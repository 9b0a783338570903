"""Build and load the CUDA kernels of :mod:`sparkflow_tpu_torch.ops`.

Each source under ``ops/csrc/`` (``*.cu``; the ``*.cuh`` headers they
include count in the build key) is compiled by its own ``nvcc`` process —
all of them started together — for ``sm_90a`` with ``-Xptxas -v``, and the
objects are linked into ONE shared library with a plain C interface, loaded
with ``ctypes``. The build happens at first use, into ``ops/_build/`` (a
directory ``.gitignore`` lists; ``SPARKFLOW_TORCH_KERNEL_DIR`` overrides
it), and is keyed by a hash of the sources, headers, flags and arch
(:func:`source_key`), so an unchanged tree reuses its library across
processes. The compiler is not in the key: finding and loading a library
that is already built needs no ``nvcc`` — only a build calls
:func:`nvcc_path`, and it records the compiler's path and version inside
the build directory (``build.<key>.json``). :func:`install` loads a
library from a given path (the cold-start store's copy,
:mod:`sparkflow_tpu_torch.serving.coldstart`) before the first launch.
Nothing here runs at import time: the CPU tests import every module of the
package without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "paged_attention.cu",
           "paged_verify.cu")
HEADERS = ("pool_load.cuh", "mma_bf16.cuh", "mma_tf32.cuh")
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LIB_PREFIX = "libsparkflow_kernels"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_report: Dict[str, List[str]] = {}
# how this process got its library: path, "how" ("built" | "found" |
# "installed") and the seconds the build or load took
_origin: Dict[str, Any] = {}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k, v, mask, o, lse, B, H, S, Sk, D, strides[12], scale,
    # causal, stream
    "sf_flash_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F,
                     _I, _P],
    # dtype, q, k, v, dout, lse, delta, mask, dq, B, H, S, Sk, D,
    # strides[15], scale, causal, stream
    "sf_flash_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _P, _F, _I, _P],
    # dtype, q, k, v, dout, lse, delta, mask, dk, dv, B, H, S, Sk, D,
    # strides[18], scale, causal, stream
    "sf_flash_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _P, _F, _I, _P],
    # dtype, q, qsb, qsh, k_pages, v_pages, table, maxp, lengths, out, B, H,
    # D, page, chunk, nchunks, scale, stream
    "sf_paged_attention": [_I, _P, _LL, _LL, _P, _P, _P, _I, _P, _P, _I, _I,
                           _I, _I, _I, _I, _F, _P],
    # dtype, pool, q, qsb, qsh, k_pages, v_pages, k_scales, v_scales, table,
    # maxp, lengths, out, B, H, D, page, chunk, nchunks, scale, stream
    "sf_paged_attention_quant": [_I, _I, _P, _LL, _LL, _P, _P, _P, _P, _P,
                                 _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, pool, q, k_pages, v_pages, k_scales, v_scales, table, maxp,
    # start, out, part_acc, part_ml, nchunks, B, H, S, D, page, strides[6],
    # scale, stream
    "sf_paged_verify": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P, _F, _P],
    "sf_paged_verify_chunk": [],
}


def build_dir() -> str:
    return os.environ.get("SPARKFLOW_TORCH_KERNEL_DIR",
                          os.path.join(_HERE, "_build"))


def nvcc_path() -> str:
    """The compiler: under ``CUDA_HOME`` / ``CUDA_PATH`` where either is
    set (else ``/usr/local/cuda``), else on ``PATH``. Only a build asks."""
    roots = [r for r in (os.environ.get("CUDA_HOME"),
                         os.environ.get("CUDA_PATH")) if r]
    for root in roots or ["/usr/local/cuda"]:
        if os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def source_key() -> str:
    """The build key: a hash of the sources, the headers, ``NVCC_FLAGS``
    and the arch. It names the library in a build directory and in the
    cold-start store; the compiler's path and version are not part of it."""
    h = hashlib.sha256(repr((NVCC_FLAGS, ARCH)).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(out_dir: Optional[str] = None) -> str:
    """Where the library of this tree's sources lives in ``out_dir``
    (default :func:`build_dir`), built or not."""
    return os.path.join(out_dir or build_dir(),
                        f"{LIB_PREFIX}.{source_key()}.so")


def _nvcc_version(nvcc: str) -> str:
    r = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       timeout=60)
    return r.stdout.strip()


def _compile(nvcc: str, out_dir: str, key: str) -> str:
    """Compile every source in parallel, then link; returns the library
    path. Writes each source's ptxas report next to it."""
    procs = []
    for name in SOURCES:
        obj = os.path.join(out_dir, f"{name}.{key}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name), "-o", obj]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    objs, failed = [], []
    for name, obj, p in procs:
        out, _ = p.communicate(timeout=900)
        with open(os.path.join(out_dir, f"{name}.{key}.log"), "w") as f:
            f.write(out)
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode})\n{out}")
        objs.append(obj)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    lib = os.path.join(out_dir, f"{LIB_PREFIX}.{key}.so")
    tmp = lib + f".tmp{os.getpid()}"
    r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"linking the CUDA kernels failed:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, lib)
    with open(os.path.join(out_dir, f"build.{key}.json"), "w") as f:
        json.dump({"nvcc": nvcc, "nvcc_version": _nvcc_version(nvcc),
                   "flags": list(NVCC_FLAGS), "arch": ARCH}, f, indent=1)
    return lib


def _read_reports(out_dir: str, key: str) -> Dict[str, List[str]]:
    rep = {}
    for name in SOURCES:
        path = os.path.join(out_dir, f"{name}.{key}.log")
        lines = []
        if os.path.exists(path):
            with open(path) as f:
                lines = [ln.rstrip() for ln in f
                         if "ptxas" in ln or "spill" in ln]
        rep[name] = lines
    return rep


def _open(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.sf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(out_dir: Optional[str] = None) -> ctypes.CDLL:
    """The kernels' shared library: the one already loaded in this process,
    else this tree's library found in ``out_dir`` (default
    :func:`build_dir`), else built there with ``nvcc`` first."""
    global _lib, _report, _origin
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out_dir = out_dir or build_dir()
        os.makedirs(out_dir, exist_ok=True)
        key = source_key()
        lib_path = os.path.join(out_dir, f"{LIB_PREFIX}.{key}.so")
        how = "found"
        if not os.path.exists(lib_path):
            with open(os.path.join(out_dir, "build.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)  # one build at a time across processes
                try:
                    if not os.path.exists(lib_path):
                        _compile(nvcc_path(), out_dir, key)
                        how = "built"
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)
        _lib = _open(lib_path)
        _report = _read_reports(out_dir, key)
        _origin = {"path": lib_path, "how": how,
                   "seconds": time.perf_counter() - t0}
        return _lib


def install(lib_path: str,
            reports: Optional[Dict[str, List[str]]] = None) -> bool:
    """Load the library at ``lib_path`` as this process's kernels, before
    any launch. Returns False, and changes nothing, when a library is
    already loaded (the first one stays). ``reports`` stands in for the
    ptxas logs a build directory would hold."""
    global _lib, _report, _origin
    with _lock:
        if _lib is not None:
            return False
        t0 = time.perf_counter()
        _lib = _open(lib_path)
        _report = {name: list((reports or {}).get(name, []))
                   for name in SOURCES}
        _origin = {"path": os.path.abspath(lib_path), "how": "installed",
                   "seconds": time.perf_counter() - t0}
        return True


def loaded() -> Optional[Dict[str, Any]]:
    """Where this process's library came from (``path``, ``how``,
    ``seconds``), or None before the first load."""
    with _lock:
        return dict(_origin) if _lib is not None else None


def ptxas_report() -> Dict[str, List[str]]:
    """``-Xptxas -v`` lines (registers, shared memory, spills) per source of
    the loaded library; empty lists for a library installed without its
    reports."""
    load()
    return dict(_report)


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = load().sf_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
