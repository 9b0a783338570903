"""Live weight publication: a versioned store + the hot-swap watcher — the
port of the JAX package's ``serving/weightstore.py``.

Two halves, as there:

- :class:`WeightStore` — immutable, monotonically versioned weight sets
  under one directory, published crash-consistently: tmp-dir write,
  per-file sha256 ``manifest.json``, atomic ``os.rename``, then a
  ``latest.json`` pointer swapped via tmp + fsync + ``os.replace``. A
  process killed mid-publish leaves a ``_tmp_*`` dir no reader ever sees
  and an intact previous version; a torn or bit-rotted version fails its
  manifest and readers fall back to the newest *verifiable* one.
  :meth:`WeightStore.rollback` quarantines a bad version and repoints the
  pointer at the last good one.

- :class:`WeightWatcher` — a serving-side daemon thread that polls
  ``latest_version()``, verifies + loads a new version against the first
  engine's shape/dtype template, and hands it to each attached engine's
  ``swap_params`` (the port's
  :class:`~sparkflow_tpu_torch.serving.engine.InferenceEngine` and
  :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine`). Any failure
  keeps the replica on its **last-good** weights and is counted, never
  raised into the serving path.

The on-disk format is the JAX package's, so a store written by either
package loads in the other: ``v_<n>/weights.npz`` holds the tree's leaves
as ``l_{i}`` in ``jax.tree.leaves`` order — dict keys SORTED, so
``block_10`` precedes ``block_2`` — which is neither ``param_specs()``
order nor the port's insertion order. Publication and loading go through
:func:`~sparkflow_tpu_torch.convert.sorted_leaves` /
:func:`~sparkflow_tpu_torch.convert.unflatten_sorted`, which keep that
order. A template (``like=``) may hold tensors (``meta`` ones from an
engine's ``weights_template()``), numpy arrays or anything with
``shape`` / ``dtype``; loaded leaves are numpy arrays.

Chaos surface: :func:`resilience.faults.fire` points
``weights.publish_commit`` (between manifest and rename), ``weights.pull``
(every store read) and ``engine.swap`` (inside each engine's swap).

Lock order: ``WeightWatcher._lock`` guards only the watcher's own
counters; engine locks are taken via ``swap_params``/``maybe_swap`` calls
made *outside* it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch

from ..convert import sorted_leaves, unflatten_sorted
from ..resilience import faults
from ..resilience.retry import RetryPolicy
from ..utils import metrics as metrics_mod

if TYPE_CHECKING:  # type-only: the store must not pull in the engines
    from .decode import DecodeEngine
    from .engine import InferenceEngine

__all__ = ["WeightStoreError", "WeightStore", "WeightWatcher"]

logger = logging.getLogger("sparkflow_tpu_torch")

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.npz"


class WeightStoreError(RuntimeError):
    """Published versions exist but the requested one (or, with fallback,
    every one) is torn, corrupt, or shape-incompatible."""


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of a template leaf's dtype (torch or numpy)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


class WeightStore:
    """Immutable, monotonically versioned weight sets under one directory.

    Layout: ``<dir>/v_<n>/weights.npz`` (flat leaves in tree order) +
    per-version ``manifest.json`` (sha256 + byte size per file) +
    ``<dir>/latest.json`` (the atomic pointer, which also carries the
    quarantine list :meth:`rollback` maintains). ``retry`` (a
    :class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy`) governs transient
    read errors during :meth:`load`; the default retries OSErrors once.

    Publication is crash-consistent: a kill at ANY point leaves either the
    previous state intact or the new version fully in place — never a
    half-written ``v_<n>`` a replica could pull.
    """

    def __init__(self, directory: str, keep: int = 4, retry=None,
                 metrics: Optional[metrics_mod.Metrics] = None):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        self.retry = retry
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()
        self._lock = threading.Lock()  # in-process publish/rollback serializer
        os.makedirs(self.directory, exist_ok=True)

    def _version_dir(self, version: int) -> str:
        return os.path.join(self.directory, f"v_{version}")

    # -- publish -------------------------------------------------------------

    def _write_manifest(self, tmp: str, version: int, num_leaves: int) -> None:
        files = {}
        for root, _dirs, names in os.walk(tmp):
            for nm in sorted(names):
                full = os.path.join(root, nm)
                rel = os.path.relpath(full, tmp)
                files[rel] = {"sha256": _file_sha256(full),
                              "bytes": os.path.getsize(full)}
        manifest = {"version": int(version), "num_leaves": int(num_leaves),
                    "files": files}
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)

    def _write_latest(self, version: Optional[int],
                      quarantined: Optional[Set[int]] = None) -> None:
        # tmp + fsync + os.replace: the pointer swap is atomic — a kill
        # mid-write can never leave a truncated latest.json behind
        if quarantined is None:
            _, quarantined = self._read_pointer()
        final = os.path.join(self.directory, "latest.json")
        tmp = final + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"latest_version": (int(version)
                                          if version is not None else None),
                       "quarantined": sorted(int(v) for v in quarantined)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def publish(self, params, *, version: Optional[int] = None) -> int:
        """Publish one immutable weight set; returns its version number.

        ``params`` is any pytree of arrays (device or host) in the model's
        **standard layout** — the same tree a checkpoint stores, before any
        serving-side quantize/shard transform (each replica re-derives its
        own placement on swap). The default version is one past the newest
        published; an explicit ``version`` must still be fresh and higher
        (versions are immutable and monotone — "republish v3" is not a
        thing, and a regressing publisher is a bug this raises on).
        """
        leaves = [_to_numpy(x) for _path, x in sorted_leaves(params)]
        if not leaves:
            raise ValueError("params has no array leaves to publish")
        with self._lock:
            have = self.all_versions()
            newest = have[-1] if have else 0
            v = int(version) if version is not None else newest + 1
            if v <= newest:
                raise WeightStoreError(
                    f"version {v} is not past the newest published version "
                    f"{newest}: weight versions are immutable and monotone")
            final = self._version_dir(v)
            # the tmp name fails all_versions's int parse, so a crash
            # mid-publish leaves a dir no reader ever mistakes for a version
            tmp = os.path.join(self.directory, f"_tmp_v{v}_{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            try:
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, WEIGHTS_NAME),
                         **{f"l_{i}": x for i, x in enumerate(leaves)})
                self._write_manifest(tmp, v, len(leaves))
                # the torn-publish window: a crash here leaves the pointer
                # on the previous version and only a _tmp_* dir behind
                faults.fire("weights.publish_commit")
                os.rename(tmp, final)  # atomic on one filesystem
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._write_latest(v)
            self._gc()
        self.metrics.incr("weights/publishes")
        self.metrics.gauge("weights/published_version", float(v))
        logger.info("weightstore: published version %d to %s", v,
                    self.directory)
        return v

    def _gc(self) -> None:
        vs = self.all_versions()
        for v in vs[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._version_dir(v), ignore_errors=True)

    # -- discovery / verification -------------------------------------------

    def all_versions(self) -> List[int]:
        vs = []
        for name in os.listdir(self.directory):
            if name.startswith("v_"):
                try:
                    vs.append(int(name[2:]))
                except ValueError:
                    pass
        return sorted(vs)

    def _read_pointer(self) -> Tuple[Optional[int], Set[int]]:
        p = os.path.join(self.directory, "latest.json")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    obj = json.load(f)
                v = obj.get("latest_version")
                q = {int(x) for x in obj.get("quarantined", [])}
                return (int(v) if isinstance(v, int) else None), q
            except (ValueError, OSError) as e:
                logger.warning(
                    "weightstore: latest.json in %s is unreadable (%s); "
                    "scanning version dirs instead", self.directory, e)
        return None, set()

    def quarantined(self) -> Set[int]:
        """Versions the health gate rolled back — never served again."""
        return self._read_pointer()[1]

    def latest_version(self) -> Optional[int]:
        """The pointer's version when it names an existing dir; otherwise
        the newest non-quarantined version on disk (pointer torn/missing)."""
        v, q = self._read_pointer()
        if v is not None and os.path.isdir(self._version_dir(v)):
            return v
        vs = [x for x in self.all_versions() if x not in q]
        return vs[-1] if vs else None

    def verify_version(self, version: int) -> bool:
        """True iff every file of ``version`` is present with matching
        size + sha256 and the manifest names this version."""
        path = self._version_dir(version)
        mp = os.path.join(path, MANIFEST_NAME)
        if not os.path.isdir(path) or not os.path.exists(mp):
            return False
        try:
            with open(mp) as f:
                manifest = json.load(f)
            files = manifest["files"]
        except (ValueError, KeyError, OSError):
            return False
        if manifest.get("version") != int(version):
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

    # -- load ----------------------------------------------------------------

    def _read(self, version: int, like):
        path = os.path.join(self._version_dir(version), WEIGHTS_NAME)

        def read():
            with np.load(path) as z:
                flat = [z[f"l_{i}"] for i in range(len(z.files))]
            if like is None:
                return flat
            want = [w for _path, w in sorted_leaves(like)]
            if len(flat) != len(want):
                raise WeightStoreError(
                    f"version {version} holds {len(flat)} leaves, the "
                    f"template expects {len(want)}")
            # the shapes-unchanged contract: hot swap reuses the AOT
            # executables, so a published tree that drifts in shape or
            # dtype must be rejected here, not discovered as a retrace
            for i, (got, w) in enumerate(zip(flat, want)):
                wshape = tuple(int(d) for d in w.shape)
                wdtype = _np_dtype(w.dtype)
                if got.shape != wshape or got.dtype != wdtype:
                    raise WeightStoreError(
                        f"version {version} leaf {i} is "
                        f"{got.shape}/{got.dtype}, engine expects "
                        f"{wshape}/{wdtype} (shapes must be unchanged "
                        f"across a hot swap)")
            return unflatten_sorted(like, flat)

        if self.retry is None:
            policy = RetryPolicy(max_attempts=2, base_s=0.05, max_s=0.2,
                                 retry_on=(OSError,), seed=0)
        else:
            policy = self.retry
        return policy.call(read, describe=f"load weights version {version}")

    def load(self, version: Optional[int] = None, like=None,
             verify: bool = True) -> Optional[Tuple[int, Any]]:
        """Load ``(version, params)`` (default: newest loadable).

        ``like`` is a template pytree (arrays or ``ShapeDtypeStruct``
        leaves) supplying the tree structure and pinning shapes/dtypes.
        With ``version=None``, candidates are tried newest-first skipping
        quarantined ones; a version that fails verification or read is
        skipped with a warning — automatic fallback past torn or corrupt
        publishes (the restart-onto-last-good path). Returns None only when
        nothing is published; raises :class:`WeightStoreError` when
        versions exist but none loads. An explicit ``version`` never falls
        back: corruption there raises.
        """
        faults.fire("weights.pull")  # chaos hook; no-op unless armed
        explicit = version is not None
        if explicit:
            candidates = [int(version)]
        else:
            _, q = self._read_pointer()
            candidates = sorted((v for v in self.all_versions()
                                 if v not in q), reverse=True)
            latest = self.latest_version()
            if latest in candidates:  # pointer first (normally the max)
                candidates.remove(latest)
                candidates.insert(0, latest)
        if not candidates:
            return None
        failures = []
        for v in candidates:
            if verify and not self.verify_version(v):
                if explicit:
                    raise WeightStoreError(
                        f"weights version {v} in {self.directory} fails its "
                        f"manifest checksum (torn or corrupt)")
                logger.warning(
                    "weights version %d fails its manifest checksum (torn "
                    "or corrupt); falling back to the next valid version", v)
                failures.append((v, "manifest checksum mismatch"))
                continue
            try:
                params = self._read(v, like)
            except Exception as e:
                if explicit:
                    raise
                logger.warning(
                    "weights version %d is unreadable (%s: %s); falling "
                    "back to the next valid version", v, type(e).__name__, e)
                failures.append((v, f"{type(e).__name__}: {e}"))
                continue
            if failures:
                logger.warning(
                    "loaded weights version %d after skipping corrupt "
                    "version(s) %s", v, [f[0] for f in failures])
            return v, params
        detail = "; ".join(f"v{v}: {why}" for v, why in failures)
        raise WeightStoreError(
            f"no loadable weights in {self.directory} ({detail})")

    # -- rollback ------------------------------------------------------------

    def rollback(self, bad_version: Optional[int] = None,
                 to_version: Optional[int] = None) -> Optional[int]:
        """Quarantine ``bad_version`` (default: the current latest) and
        repoint ``latest.json`` at ``to_version`` (default: the newest
        *verifiable* non-quarantined version). Watchers polling
        ``latest_version()`` then revert every replica; the quarantined
        version is never offered again, even by fallback scans. Returns
        the new latest version (None when nothing good remains — replicas
        simply keep their in-memory last-good weights)."""
        with self._lock:
            ptr, quarantined = self._read_pointer()
            vs = self.all_versions()
            bad = (int(bad_version) if bad_version is not None
                   else (ptr if ptr is not None else (vs[-1] if vs else None)))
            if bad is not None:
                quarantined.add(bad)
            if to_version is None:
                to_version = next(
                    (v for v in sorted(vs, reverse=True)
                     if v not in quarantined and self.verify_version(v)),
                    None)
            self._write_latest(to_version, quarantined)
        self.metrics.incr("weights/rollbacks")
        if to_version is not None:
            self.metrics.gauge("weights/published_version", float(to_version))
        logger.warning(
            "weightstore: rolled back version %s -> %s (quarantined: %s)",
            bad, to_version, sorted(quarantined))
        return to_version

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        ptr, q = self._read_pointer()
        return {"directory": self.directory,
                "versions": self.all_versions(),
                "latest": self.latest_version(),
                "pointer": ptr,
                "quarantined": sorted(q),
                "keep": self.keep}


class WeightWatcher:
    """Poll a :class:`WeightStore` and hot-swap attached engines in place.

    One watcher serves one replica process: attach its engines (any mix of
    :class:`~sparkflow_tpu_torch.serving.engine.InferenceEngine` /
    :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine`), then
    :meth:`start`. Every ``poll_interval_s`` the daemon thread

    1. nudges engines with a deferred swap pending (``maybe_swap`` — a
       DecodeEngine applies at a drained token boundary, which may arrive
       between polls);
    2. reads ``store.latest_version()`` (errors counted, backed off);
    3. on a version change (up OR down — rollback is just a target below
       the current one), pulls + verifies the tree against the first
       engine's shape/dtype template under a
       :class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy`, then calls
       each engine's ``swap_params``.

    Any pull/verify failure marks the version failed (retried only when
    the pointer moves) and the replica **keeps serving last-good weights**
    — a corrupt publish is a counter and a log line here, never an error a
    client sees. Pass the watcher to
    ``InferenceServer(weight_watcher=...)`` and ``/healthz`` carries the
    live ``serving_version`` plus the watcher's counters.
    """

    def __init__(self, store: WeightStore,
                 engines: Sequence["DecodeEngine | InferenceEngine"] = (),
                 *, poll_interval_s: float = 0.5, retry=None,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 clock=time.monotonic):
        self.store = store
        self.poll_interval_s = float(poll_interval_s)
        self.retry = (retry if retry is not None
                      else RetryPolicy(max_attempts=3, base_s=0.05,
                                       max_s=0.5, retry_on=(OSError,),
                                       seed=0))
        self.metrics = metrics if metrics is not None else store.metrics
        self.clock = clock
        self._engines: List[Any] = list(engines)
        self._lock = threading.Lock()  # counters/targets only; never held
        #                                across store reads or engine calls
        self._target: Optional[int] = None   # last version handed to engines
        self._failed: Set[int] = set()       # versions that failed pull/verify
        self.polls = 0
        self.swaps = 0
        self.poll_errors = 0
        self.pull_failures = 0
        self.swap_failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, engine) -> None:
        """Add an engine (before :meth:`start`); it must expose
        ``swap_params(params, version=)`` and ``weights_template()``."""
        for need in ("swap_params", "weights_template"):
            if not hasattr(engine, need):
                raise TypeError(f"engine has no {need}(); WeightWatcher "
                                f"needs a hot-swappable engine")
        self._engines.append(engine)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "WeightWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="weight-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the watcher must never die
                with self._lock:
                    self.poll_errors += 1
                logger.exception("weight watcher poll failed; continuing")

    # -- polling -------------------------------------------------------------

    def poll_once(self) -> bool:
        """One poll tick (also callable synchronously from tests/smokes).
        Returns True when a new version was handed to every engine."""
        with self._lock:
            self.polls += 1
        # a deferred decode swap applies at a drained boundary that may
        # have arrived between polls — nudge before reading the store so an
        # idle engine flips without waiting for its next admission check
        for e in list(self._engines):
            nudge = getattr(e, "maybe_swap", None)
            if nudge is not None:
                nudge()
        try:
            target = self.store.latest_version()
        except OSError as e:
            with self._lock:
                self.poll_errors += 1
            logger.warning("weight watcher: store poll failed (%s)", e)
            return False
        with self._lock:
            if (target is None or target == self._target
                    or target in self._failed):
                return False
        if not self._engines:
            return False
        template = self._engines[0].weights_template()
        try:
            loaded = self.retry.call(
                self.store.load, version=target, like=template,
                describe=f"pull weights version {target}")
        except Exception as e:  # noqa: BLE001 - keep last-good, count it
            with self._lock:
                self._failed.add(target)
                self.pull_failures += 1
            self.metrics.incr("weights/pull_failures")
            logger.warning(
                "weight watcher: version %d failed verification/pull (%s: "
                "%s); keeping last-good weights", target,
                type(e).__name__, e)
            return False
        ver, params = loaded
        all_swapped = True
        for e in list(self._engines):
            try:
                e.swap_params(params, version=ver)
            except Exception as exc:  # noqa: BLE001 - engine keeps last-good
                all_swapped = False
                with self._lock:
                    self.swap_failures += 1
                self.metrics.incr("weights/swap_failures")
                logger.warning(
                    "weight watcher: swap to version %d failed on %s (%s: "
                    "%s); engine keeps last-good weights", ver,
                    type(e).__name__, type(exc).__name__, exc)
        if not all_swapped:
            return False  # retried next poll (target stays unclaimed)
        with self._lock:
            self._target = ver
            self.swaps += 1
        self.metrics.incr("weights/swaps")
        self.metrics.gauge("weights/target_version", float(ver))
        return True

    # -- introspection -------------------------------------------------------

    def serving_version(self) -> int:
        """The version every attached engine is actually serving (the min
        across engines — a deferred decode swap keeps this on the old
        version until it applies at a drained boundary). 0 = unpublished
        ctor weights."""
        versions = []
        for e in list(self._engines):
            sv = getattr(e, "serving_version", None)
            if callable(sv):
                versions.append(int(sv()))
        return min(versions) if versions else 0

    def stats(self) -> Dict[str, Any]:
        serving = self.serving_version()  # engine locks: outside our own
        with self._lock:
            return {"target_version": self._target,
                    "serving_version": serving,
                    "polls": self.polls,
                    "swaps": self.swaps,
                    "poll_errors": self.poll_errors,
                    "pull_failures": self.pull_failures,
                    "swap_failures": self.swap_failures,
                    "failed_versions": sorted(self._failed)}
