"""Native (C++) host runtime components, carried from the JAX package with
the C++ sources unchanged. See ``dataplane.cpp`` and
:mod:`sparkflow_tpu_torch.native.build` for the compile-on-first-use machinery;
the Python binding lives in :mod:`sparkflow_tpu_torch.utils.data`."""

from .build import load_library

__all__ = ["load_library"]
