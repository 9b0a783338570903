"""Compile-on-first-use for the native dataplane (host C++, built with
``g++``; no device code).

The shared library is built once per machine into ``_build/`` beside this
file (or ``SPARKFLOW_TORCH_NATIVE_DIR`` if set), named by a hash of the
sources, and reused; failure to build degrades to the pure-numpy / pure-
Python fallbacks in :mod:`sparkflow_tpu_torch.utils.data` and
:mod:`sparkflow_tpu_torch.utils.text` — never a hard error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_HERE, "dataplane.cpp"),
            os.path.join(_HERE, "tokenizer.cpp")]


def _cache_dir() -> str:
    d = os.environ.get("SPARKFLOW_TORCH_NATIVE_DIR")
    if not d:
        d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _lib_path() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_cache_dir(), f"libsfdata-{h.hexdigest()[:12]}.so")


def load_library(verbose: bool = False) -> Optional[ctypes.CDLL]:
    """Return the compiled dataplane library, building it if needed.
    None when no C++ toolchain is available (callers must fall back)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _lib_path()
        if not os.path.exists(path):
            # compile to a process-unique temp path and rename into place:
            # concurrent builders (e.g. several Spark executors on one host)
            # must never dlopen a partially written .so
            tmp = f"{path}.tmp.{os.getpid()}"
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                   *_SOURCES, "-o", tmp]
            try:
                # holding _LOCK across the compile is the point: concurrent
                # importers must wait for the one build, not race their own
                subprocess.run(cmd, check=True,  # graftcheck: disable=GC-L305
                               capture_output=not verbose, timeout=120)
                os.replace(tmp, path)  # atomic on POSIX
            except Exception as e:  # toolchain missing/broken -> numpy fallback
                if verbose:
                    print(f"sparkflow_tpu_torch: native build failed ({e}); "
                          f"using numpy fallback", file=sys.stderr)
                return None
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        _configure(lib)
        _LIB = lib
        return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    lib.sfq_create.restype = ctypes.c_void_p
    lib.sfq_create.argtypes = [i64, i64, i64, i64, ctypes.c_int, ctypes.c_uint64]
    lib.sfq_push.restype = i64
    lib.sfq_push.argtypes = [ctypes.c_void_p, f32p, f32p, i64]
    lib.sfq_finish.restype = None
    lib.sfq_finish.argtypes = [ctypes.c_void_p]
    lib.sfq_close.restype = None
    lib.sfq_close.argtypes = [ctypes.c_void_p]
    lib.sfq_pop.restype = i64
    lib.sfq_pop.argtypes = [ctypes.c_void_p, f32p, f32p, f32p]
    lib.sfq_destroy.restype = None
    lib.sfq_destroy.argtypes = [ctypes.c_void_p]
    lib.sf_csv_load.restype = f32p
    lib.sf_csv_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                ctypes.POINTER(i64)]
    lib.sf_free.restype = None
    lib.sf_free.argtypes = [ctypes.c_void_p]
    # wordpiece tokenizer (tokenizer.cpp)
    lib.sft_create.restype = ctypes.c_void_p
    lib.sft_create.argtypes = [ctypes.c_char_p, i64, i64]
    lib.sft_encode.restype = i64
    lib.sft_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int32), f32p, i64,
                               ctypes.c_int32, ctypes.c_int32]
    lib.sft_encode_batch.restype = i64
    lib.sft_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64,
                                     i64, ctypes.POINTER(ctypes.c_int32),
                                     f32p, i64, ctypes.c_int32,
                                     ctypes.c_int32]
    lib.sft_destroy.restype = None
    lib.sft_destroy.argtypes = [ctypes.c_void_p]
