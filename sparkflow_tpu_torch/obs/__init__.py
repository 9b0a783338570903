"""Observability: host-side spans, trace assembly, flight recorder, and
metric exporters — carried from the JAX package's ``obs`` with the device
hooks rewired to PyTorch:

- :mod:`~sparkflow_tpu_torch.obs.spans` — ``Span``/``Tracer``: nested
  host-side intervals; ``span(profiler_annotation=True)`` also opens a
  ``torch.profiler.record_function`` range so host spans and device
  kernels line up by name in a profiler trace.
- :mod:`~sparkflow_tpu_torch.obs.collector` — ``TraceCollector``: trace
  assembly and tail sampling across processes.
- :mod:`~sparkflow_tpu_torch.obs.flight` — ``FlightRecorder``: always-on
  crash evidence.
- :mod:`~sparkflow_tpu_torch.obs.stepstats` — ``StepStats``: the per-step
  phase breakdown (setup / transfer / step / metrics / checkpoint) and
  throughput and MFU gauges of ``Trainer.fit(trace_spans=...)``.
- :mod:`~sparkflow_tpu_torch.obs.exporters` — ``prometheus_text`` and the
  ``MemoryWatcher`` (``torch.cuda`` allocator counters + host RSS).
"""

from .spans import (Span, TraceContext, Tracer, current_tracer,
                    default_tracer, span)
from .stepstats import StepStats
from .collector import TraceCollector, trace_spans
from .flight import FlightRecorder, harvest_flight
from .exporters import MemoryWatcher, prometheus_name, prometheus_text

__all__ = [
    "Span", "TraceContext", "Tracer", "current_tracer", "default_tracer",
    "span",
    "StepStats",
    "TraceCollector", "trace_spans",
    "FlightRecorder", "harvest_flight",
    "MemoryWatcher", "prometheus_name", "prometheus_text",
]
