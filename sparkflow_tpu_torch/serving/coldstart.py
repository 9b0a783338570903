"""Cold start from a stored kernel library — the port of the JAX package's
``serving/coldstart.py``.

A fresh JAX replica pays XLA compiles at boot, and the JAX store keeps the
serialized executables beside the weights. A fresh port replica pays the
``nvcc`` build of :mod:`sparkflow_tpu_torch.ops` at its first kernel
launch; the counterpart of a serialized executable is that **built kernel
library** (one ``.so``), and :class:`ExecutableStore` keeps it beside the
weights so that a replica boots its kernels without a compiler.

Three boot tiers, best first (:func:`boot_kernels`):

1. **store** — :meth:`ExecutableStore.load` finds this tree's library
   under its source key (:func:`~sparkflow_tpu_torch.ops._build.
   source_key`), checks its sha256 and the environment fingerprint, copies
   the verified bytes into the build directory and installs them
   (:func:`~sparkflow_tpu_torch.ops._build.install`). No ``nvcc``.
2. **compile cache** — the library is already built in the build directory
   (``compile_cache_dir=``, else ``ops/_build/`` or
   ``SPARKFLOW_TORCH_KERNEL_DIR``). No ``nvcc``.
3. **build** — ``nvcc`` builds it there; with a store, the library is then
   saved for the next boot.

Layout (one directory, e.g. ``<weights_dir>/executables``)::

    executables.json          # manifest: key -> {file, sha256, env, ...}
    kernels_<key>.so          # the library's bytes

The store's rules are JAX's: a sha256 over the blob, atomic temp-file +
rename writes with the manifest written last, and the blob write +
manifest read-modify-write under an ``O_EXCL`` lock file (stale locks from
crashed writers are broken; a busy lock degrades to an unlocked update), so
concurrent replica boots against one shared store keep each other's
entries. A stale fingerprint, a corrupt blob or a missing key is a miss:
:meth:`ExecutableStore.load` returns None, counts it, and the caller falls
to the next tier. A miss never hides the device: a kernel that fails to
load or launch still raises.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

from ..utils import metrics as metrics_mod

__all__ = ["ExecutableStore", "MANIFEST_NAME", "env_fingerprint",
           "boot_kernels", "kernel_key", "cold_start_stats",
           "compile_cache_stats"]

MANIFEST_NAME = "executables.json"

# manifest-lock tuning: how long save() waits for a peer's update before
# proceeding unlocked (degrades to the lost-update race, never worse),
# and how old an abandoned lock must be before it is presumed to belong
# to a crashed writer and broken
LOCK_TIMEOUT_S = 5.0
LOCK_STALE_S = 30.0

logger = logging.getLogger("sparkflow_tpu_torch")


def env_fingerprint() -> str:
    """What a stored library is valid for: the torch version, the CUDA
    version torch was built with, the card's name and compute capability,
    and the arch the library was built for. Any change makes every entry
    stale (the build tiers take over)."""
    import torch

    from ..ops import _build
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        card = f"{torch.cuda.get_device_name(0)}/sm{major}{minor}"
    else:
        card = "no-card"
    return (f"torch-{torch.__version__}/cuda-{torch.version.cuda}/{card}"
            f"/{_build.ARCH}")


def kernel_key() -> str:
    """The store key of this tree's kernel library: its source key."""
    from ..ops import _build
    return f"kernels/{_build.source_key()}"


class ExecutableStore:
    """sha256-manifested store of built kernel libraries.

    ``load``/``save`` never raise for storage problems — cold start must
    boot through every failure mode, just slower. The ``metrics`` counters
    (``coldstart/{hits,misses,saves,rejects}``) say which tier a boot
    actually took.
    """

    def __init__(self, directory: str, *,
                 metrics: Optional[metrics_mod.Metrics] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.metrics = (metrics if metrics is not None
                        else metrics_mod.Metrics())
        self._env = None  # computed lazily: it asks the card

    # -- manifest ------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _read_manifest(self) -> Dict[str, Any]:
        try:
            with open(self.manifest_path, "r", encoding="utf-8") as fh:
                m = json.load(fh)
            return m if isinstance(m, dict) else {}
        except (OSError, ValueError):
            return {}

    def _write_manifest(self, manifest: Dict[str, Any]) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory,
                                   prefix=".manifest-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(manifest, fh, indent=1, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.manifest_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @property
    def _lock_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME + ".lock")

    @contextlib.contextmanager
    def _manifest_lock(self):
        """Cross-process mutual exclusion for the manifest read-modify-
        write. A scale-up boots several replica processes against one
        shared store; two unlocked concurrent first-boots would each
        rewrite the manifest from their own snapshot and silently drop
        the other's entries (last writer wins). O_EXCL lock file; a lock
        older than ``LOCK_STALE_S`` is presumed left by a crashed writer
        and broken; past ``LOCK_TIMEOUT_S`` the update proceeds unlocked
        (a rebuild on a later boot, never corruption)."""
        deadline = time.monotonic() + LOCK_TIMEOUT_S
        acquired = False
        while True:
            try:
                fd = os.open(self._lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                acquired = True
                break
            except FileExistsError:
                try:
                    age = time.time() - os.stat(self._lock_path).st_mtime
                except OSError:
                    continue            # holder just released; retry now
                if age > LOCK_STALE_S:
                    logger.warning("coldstart: breaking stale manifest "
                                   "lock (%.0fs old)", age)
                    try:
                        os.unlink(self._lock_path)
                    except OSError:
                        pass
                    continue
                if time.monotonic() >= deadline:
                    logger.warning(
                        "coldstart: manifest lock held past %.0fs; "
                        "updating unlocked", LOCK_TIMEOUT_S)
                    break
                time.sleep(0.02)
            except OSError:
                break                   # unwritable dir: best effort
        try:
            yield
        finally:
            if acquired:
                try:
                    os.unlink(self._lock_path)
                except OSError:
                    pass

    def keys(self):
        return sorted(self._read_manifest())

    def has(self, key: str) -> bool:
        """Whether ``key`` has an entry for this environment (its blob is
        checked only by :meth:`load`)."""
        entry = self._read_manifest().get(key)
        return (isinstance(entry, dict)
                and entry.get("env") == self._fingerprint())

    def _fingerprint(self) -> str:
        if self._env is None:
            self._env = env_fingerprint()
        return self._env

    @staticmethod
    def _filename(key: str) -> str:
        return key.replace("/", "_").replace(":", "_") + ".so"

    # -- tiers ---------------------------------------------------------------

    def save(self, key: str, library: str,
             reports: Optional[Dict[str, List[str]]] = None) -> bool:
        """Store the built library at path ``library`` under ``key``, with
        its ptxas ``reports`` (per source) in the manifest entry. Returns
        True on success; False (logged) when the read or a write fails —
        the store is an accelerator, never a gate."""
        try:
            with open(library, "rb") as fh:
                blob = fh.read()
        except OSError as exc:
            logger.warning("coldstart: cannot read %s (%s)", library, exc)
            return False
        fname = self._filename(key)
        try:
            # blob write AND manifest read-modify-write under one lock:
            # concurrent first-boots of a replica fleet must not rewrite
            # the shared manifest from divergent snapshots (lost entries)
            # or cross a peer's blob with this writer's checksum
            with self._manifest_lock():
                fd, tmp = tempfile.mkstemp(dir=self.directory,
                                           prefix=".exe-", suffix=".tmp")
                with os.fdopen(fd, "wb") as fh:
                    fh.write(blob)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, os.path.join(self.directory, fname))
                manifest = self._read_manifest()
                manifest[key] = {
                    "file": fname,
                    "sha256": hashlib.sha256(blob).hexdigest(),
                    "env": self._fingerprint(),
                    "bytes": len(blob),
                    "reports": {k: list(v)
                                for k, v in (reports or {}).items()},
                }
                self._write_manifest(manifest)
        except OSError as exc:
            logger.warning("coldstart: cannot store %s (%s)", key, exc)
            return False
        self.metrics.incr("coldstart/saves")
        return True

    def load(self, key: str, dest_dir: str):
        """The library stored under ``key``, verified and copied into
        ``dest_dir``: ``(path, reports)``, or None on any kind of miss
        (absent, stale environment, checksum mismatch, unwritable
        destination) — callers fall through to the build tiers."""
        entry = self._read_manifest().get(key)
        if not isinstance(entry, dict):
            self.metrics.incr("coldstart/misses")
            return None
        if entry.get("env") != self._fingerprint():
            # another torch / CUDA / card / arch: stale by construction
            self.metrics.incr("coldstart/rejects")
            return None
        try:
            with open(os.path.join(self.directory,
                                   str(entry.get("file"))), "rb") as fh:
                blob = fh.read()
        except OSError:
            self.metrics.incr("coldstart/misses")
            return None
        if hashlib.sha256(blob).hexdigest() != entry.get("sha256"):
            logger.warning("coldstart: checksum mismatch for %s; "
                           "falling back to the build tiers", key)
            self.metrics.incr("coldstart/rejects")
            return None
        # the bytes just verified are the bytes loaded: they go to a file
        # of their own, not back through the store's (replaceable) copy
        path = os.path.join(dest_dir, os.path.basename(key) + ".stored.so")
        try:
            os.makedirs(dest_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=dest_dir, prefix=".lib-",
                                       suffix=".tmp")
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        except OSError as exc:
            logger.warning("coldstart: cannot copy %s into %s (%s)", key,
                           dest_dir, exc)
            self.metrics.incr("coldstart/misses")
            return None
        self.metrics.incr("coldstart/hits")
        reports = entry.get("reports")
        return path, (reports if isinstance(reports, dict) else {})


def boot_kernels(store: Optional[ExecutableStore],
                 cache_dir: Optional[str], device) -> Dict[str, Any]:
    """Load this process's kernel library by the best tier there is, and
    save a library that had to be found or built into ``store``.

    Returns what the engines report under ``stats()["cold_start"]``:
    ``tier`` (1 store, 2 compile cache, 3 build; None where no tier ran),
    ``source`` (``"store"``, ``"compile_cache"``, ``"build"``,
    ``"already_loaded"`` when an earlier engine of the process loaded it,
    ``"cpu"`` when the device needs no kernels), ``library``, ``boot_s``
    and ``saved``. A library that fails to load raises."""
    from ..ops import _build
    t0 = time.perf_counter()
    out = {"tier": None, "source": "cpu", "library": None, "boot_s": 0.0,
           "saved": False}
    if getattr(device, "type", str(device)) != "cuda":
        return out
    out_dir = cache_dir or _build.build_dir()
    key = kernel_key()
    prior = _build.loaded()
    if prior is not None:
        out.update(source="already_loaded", library=prior["path"])
    else:
        hit = store.load(key, out_dir) if store is not None else None
        if hit is not None:
            path, reports = hit
            _build.install(path, reports)
            out.update(tier=1, source="store")
        else:
            _build.load(out_dir)
            how = _build.loaded()["how"]
            out.update(tier=2 if how == "found" else 3,
                       source="compile_cache" if how == "found" else "build")
        out["library"] = _build.loaded()["path"]
    # a library the store missed is saved for the next boot; one an
    # earlier engine loaded is saved where the store has no current entry
    if store is not None and out["tier"] != 1 and (
            out["tier"] is not None or not store.has(key)):
        out["saved"] = store.save(key, out["library"], _build.ptxas_report())
    out["boot_s"] = time.perf_counter() - t0
    return out


def cold_start_stats(store, boot) -> Optional[Dict[str, Any]]:
    """``stats()["cold_start"]`` of either engine: None without a store."""
    if store is None:
        return None
    return {"dir": store.directory,
            "serialized_loads": int(boot["tier"] == 1),
            "serialized_saves": int(boot["saved"]),
            **{k: boot[k] for k in ("tier", "source", "library", "boot_s")}}


def compile_cache_stats(cache_dir, boot) -> Optional[Dict[str, Any]]:
    """``stats()["compile_cache"]``: None without a directory; a hit is a
    library found built there, a miss one built there."""
    if cache_dir is None:
        return None
    return {"dir": cache_dir, "hits": int(boot["tier"] == 2),
            "misses": int(boot["tier"] == 3)}
