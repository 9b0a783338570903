"""Step-level checkpoints, crash-consistent — the npz side of the JAX
package's ``checkpoint.py``.

Layout and contract are the JAX package's: ``<dir>/step_<n>/`` holds the
state and a ``manifest.json`` with a sha256 and byte size per file,
``<dir>/latest.json`` points at the newest step, and a plain-weights export
``<dir>/weights.npz`` (keys ``w_0 .. w_{n-1}`` in ``param_specs()`` order)
serves the model loader and ``InferenceEngine.from_checkpoint``.

- ``save`` writes the step into a temp dir, records the manifest, then
  atomically renames the dir into place: a process killed mid-save leaves a
  ``_tmp_*`` dir (invisible to ``all_steps``) and an intact previous
  checkpoint, never a half-written ``step_<n>``.
- ``latest.json`` is written via tmp + fsync + ``os.replace``; ``latest_step``
  falls back to scanning the step dirs when the pointer is missing or
  garbled.
- ``restore`` verifies the manifest checksums and falls back to the newest
  *valid* step when the latest is torn or corrupt (transient read errors
  retried per ``RetryPolicy``); it raises :class:`CheckpointError` only when
  steps exist but none restores.

What differs: the JAX package writes orbax when orbax imports, and orbax
needs JAX, so the port writes and reads only the JAX package's npz layout —
``format: "npz"`` in the manifest and ``state.npz`` holding the state's
leaves as ``l_{i}`` in ``jax.tree.leaves`` order (sorted dict keys; see
:func:`~sparkflow_tpu_torch.convert.sorted_leaves`). The port's manifest also
lists each leaf's key path (``"leaves"``), so a port checkpoint restores
without a template; a JAX npz checkpoint needs ``like``. A step in orbax
format is refused with a :class:`CheckpointError` naming the format — it is
never skipped as if it were corrupt.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .convert import params_to_list, sorted_leaves, unflatten_sorted
from .obs.spans import span as obs_span
from .resilience import faults

logger = logging.getLogger("sparkflow_tpu_torch")

MANIFEST_NAME = "manifest.json"
STATE_NAME = "state.npz"
FORMAT = "npz"


class CheckpointError(RuntimeError):
    """Checkpoints exist but none could be restored (all torn, corrupt, or
    in a format the port does not read)."""


def _file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tree_from_paths(paths: List[list], leaves: List[Any]):
    """Nested dicts from key paths; a dict whose keys are exactly
    ``0 .. n-1`` (a sequence in the saved tree) becomes a list."""
    root: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and set(node) == set(range(len(node))):
            return [node[i] for i in range(len(node))]
        return node

    return fix(root)


class CheckpointManager:
    """Periodic training checkpoints under one directory (npz format).

    ``retry`` (a :class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy`)
    governs transient read errors during restore; the default retries
    OSErrors once.
    """

    def __init__(self, directory: str, keep: int = 3, retry=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.retry = retry
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # -- save ---------------------------------------------------------------

    def _write_manifest(self, tmp: str, step: int, paths: List[list]) -> None:
        files = {}
        for root, _dirs, names in os.walk(tmp):
            for nm in sorted(names):
                full = os.path.join(root, nm)
                rel = os.path.relpath(full, tmp)
                files[rel] = {"sha256": _file_sha256(full),
                              "bytes": os.path.getsize(full)}
        manifest = {"step": int(step), "format": FORMAT, "files": files,
                    "leaves": paths}
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)

    def _write_latest(self, step: int) -> None:
        # tmp + os.replace: the pointer file is swapped atomically — a kill
        # mid-write can never leave a truncated latest.json behind
        final = os.path.join(self.directory, "latest.json")
        tmp = final + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"latest_step": int(step)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write ``state`` (a nested tree of tensors / arrays / scalars) as
        step ``step``, crash-consistently."""
        with obs_span("checkpoint/save", args={"step": int(step)}):
            self._save_impl(step, state)

    def _save_impl(self, step: int, state: Dict[str, Any]) -> None:
        final = self._step_dir(step)
        # the tmp name intentionally fails all_steps's int parse, so a crash
        # mid-save leaves a dir no reader ever mistakes for a checkpoint
        tmp = os.path.join(self.directory, f"_tmp_step_{step}_{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        flat = sorted_leaves(state)
        try:
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, STATE_NAME),
                     **{f"l_{i}": _to_numpy(x)
                        for i, (_p, x) in enumerate(flat)})
            self._write_manifest(tmp, step, [list(p) for p, _x in flat])
            faults.fire("checkpoint.pre_commit")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic on one filesystem
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._write_latest(step)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- discovery / verification -------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "latest.json")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    s = json.load(f).get("latest_step")
                if isinstance(s, int) and os.path.isdir(self._step_dir(s)):
                    return s
                logger.warning(
                    "latest.json names step %r but no such checkpoint dir "
                    "exists; scanning %s instead", s, self.directory)
            except (ValueError, OSError) as e:
                logger.warning(
                    "latest.json in %s is unreadable (%s); scanning step "
                    "dirs instead", self.directory, e)
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> Optional[dict]:
        try:
            with open(os.path.join(self._step_dir(step), MANIFEST_NAME)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def verify_step(self, step: int) -> Optional[bool]:
        """Check ``step`` against its checksum manifest: True = every file
        present with matching size+sha256; False = torn/corrupt; None = a
        pre-manifest (legacy) checkpoint that cannot be verified."""
        path = self._step_dir(step)
        if not os.path.isdir(path):
            return False
        mp = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(mp):
            return None
        try:
            with open(mp) as f:
                files = json.load(f)["files"]
        except (ValueError, KeyError, OSError):
            return False
        for rel, rec in files.items():
            full = os.path.join(path, rel)
            if not os.path.isfile(full):
                return False
            if os.path.getsize(full) != rec.get("bytes"):
                return False
            if _file_sha256(full) != rec.get("sha256"):
                return False
        return True

    def _check_format(self, step: int) -> None:
        """Refuse a step the port cannot read: orbax, the JAX package's
        format whenever orbax imports there."""
        manifest = self._manifest(step) or {}
        fmt = manifest.get("format")
        if fmt is None and os.path.isdir(
                os.path.join(self._step_dir(step), "state")):
            fmt = "orbax"
        if fmt not in (None, FORMAT):
            raise CheckpointError(
                f"checkpoint step {step} in {self.directory} is in {fmt!r} "
                f"format, which needs JAX to read; the PyTorch port reads "
                f"the {FORMAT!r} format only (see ROADMAP.md)")

    # -- restore ------------------------------------------------------------

    def _read(self, step: int, like: Optional[Dict[str, Any]]):
        path = self._step_dir(step)

        def read():
            with np.load(os.path.join(path, STATE_NAME)) as z:
                flat = [z[f"l_{i}"] for i in range(len(z.files))]
            if like is not None:
                return unflatten_sorted(like, flat)
            paths = (self._manifest(step) or {}).get("leaves")
            if paths is None or len(paths) != len(flat):
                raise CheckpointError(
                    f"checkpoint step {step} in {self.directory} lists no "
                    f"leaf paths (an npz checkpoint of the JAX package); "
                    f"restore it with `like` (a template tree)")
            return _tree_from_paths(paths, flat)

        if self.retry is None:
            from .resilience.retry import RetryPolicy
            policy = RetryPolicy(max_attempts=2, base_s=0.05, max_s=0.2,
                                 retry_on=(OSError,), seed=0)
        else:
            policy = self.retry
        return policy.call(read, describe=f"restore checkpoint step {step}")

    def restore(self, step: Optional[int] = None,
                like: Optional[Dict[str, Any]] = None,
                verify: bool = True) -> Optional[Dict[str, Any]]:
        """Restore the state tree at ``step`` (default: latest valid) with
        numpy leaves. ``like`` is a template tree supplying the structure.

        With ``step=None``, candidates are tried newest-first: a step whose
        manifest fails verification (or whose read raises) is skipped with a
        warning and the next-newest is tried. Returns None only when the
        directory holds no checkpoints at all; raises
        :class:`CheckpointError` when steps exist but none restores, and at
        once for a step in a format the port does not read. An explicit
        ``step`` never falls back: corruption there raises.
        """
        with obs_span("checkpoint/restore",
                      args={"step": (int(step) if step is not None
                                     else None)}):
            return self._restore_impl(step, like, verify)

    def _restore_impl(self, step: Optional[int],
                      like: Optional[Dict[str, Any]],
                      verify: bool) -> Optional[Dict[str, Any]]:
        explicit = step is not None
        if explicit:
            candidates = [step]
        else:
            candidates = sorted(self.all_steps(), reverse=True)
            latest = self.latest_step()
            if latest in candidates:  # pointer first (normally the max)
                candidates.remove(latest)
                candidates.insert(0, latest)
        if not candidates:
            return None
        failures = []
        for s in candidates:
            self._check_format(s)
            if verify and self.verify_step(s) is False:
                if explicit:
                    raise CheckpointError(
                        f"checkpoint step {s} in {self.directory} fails its "
                        f"manifest checksum (torn or corrupt)")
                logger.warning(
                    "checkpoint step %d fails its manifest checksum (torn "
                    "or corrupt); falling back to the next valid step", s)
                failures.append((s, "manifest checksum mismatch"))
                continue
            try:
                state = self._read(s, like)
            except Exception as e:
                if explicit:
                    raise
                logger.warning(
                    "checkpoint step %d is unreadable (%s: %s); falling "
                    "back to the next valid step", s, type(e).__name__, e)
                failures.append((s, f"{type(e).__name__}: {e}"))
                continue
            if failures:
                logger.warning(
                    "restored checkpoint step %d after skipping corrupt "
                    "step(s) %s", s, [f[0] for f in failures])
            return state
        detail = "; ".join(f"step {s}: {why}" for s, why in failures)
        raise CheckpointError(
            f"no restorable checkpoint in {self.directory} ({detail})")

    # -- plain-weights interop (model_loader) -------------------------------

    @staticmethod
    def save_weights(directory: str, model, params) -> None:
        """``<directory>/weights.npz``: the flat weight list (``w_{i}``, in
        ``param_specs()`` order) — the JAX package's export, unchanged."""
        os.makedirs(directory, exist_ok=True)
        weights = params_to_list(model, params)
        np.savez(os.path.join(directory, "weights.npz"),
                 **{f"w_{i}": w for i, w in enumerate(weights)})

    @staticmethod
    def load_weights(directory: str, model,
                     retry=None) -> List[np.ndarray]:
        """The flat weight list of ``directory``: its ``weights.npz``, else
        the ``params`` of its newest restorable checkpoint."""
        p = os.path.join(directory, "weights.npz")
        if os.path.exists(p):
            with np.load(p) as z:
                return [z[k] for k in sorted(
                    z.files, key=lambda s: int(s.split("_")[-1]))]
        mgr = CheckpointManager(directory, retry=retry)
        state = mgr.restore()
        if state is None or "params" not in state:
            raise FileNotFoundError(f"no weights.npz or checkpoints in "
                                    f"{directory}")
        params = state["params"]
        return [np.asarray(params[ln][pn])
                for ln, ps in model.param_specs().items() for pn in ps]
