"""Profiling/tracing: ``torch.profiler`` capture + named range annotations.

The port of the JAX package's ``utils/tracing.py``. ``trace(dir)`` profiles
the enclosed region — the host's activity, and the card's kernels when a
card is there — and exports it as Chrome / Perfetto JSON into ``dir``;
``annotate(name)`` marks a named range, which shows in such a capture (a
``record_function`` range) and, on the card, in any CUDA tool that reads
NVTX ranges. The engines annotate their warmup points and the host spans
of :mod:`sparkflow_tpu_torch.obs` (``profiler_annotation=True``) enter
:func:`annotate`, so a capture shows where each kernel launch came from.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator, Optional

from ..obs.exporters import device_memory_stats

__all__ = ["trace", "annotate", "device_memory_stats", "Capture"]

_serial = itertools.count()


class Capture:
    """What :func:`trace` yields: ``path`` is the exported JSON once the
    region has ended (None before)."""

    def __init__(self):
        self.path: Optional[str] = None


def _cuda() -> bool:
    import torch
    return torch.cuda.is_available()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Capture]:
    """Profile the enclosed region (CPU activity; CUDA activity too when
    a card is there) and write ``trace_<pid>_<n>.json`` into ``log_dir``
    (open it in ui.perfetto.dev or chrome://tracing). The card's work is
    synchronised before the capture stops, so every kernel launched in
    the region is in the file."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = _cuda()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    cap = Capture()
    with profile(activities=acts) as prof:
        try:
            yield cap
        finally:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    cap.path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_serial)}.json")
    prof.export_chrome_trace(cap.path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range: a ``record_function`` range in a profiler capture and,
    with a card, an NVTX range."""
    from torch.profiler import record_function
    nvtx = None
    if _cuda():
        import torch
        nvtx = torch.cuda.nvtx
        nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()
