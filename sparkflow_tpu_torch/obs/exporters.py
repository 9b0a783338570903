"""Metric exporters: Prometheus text exposition + device-memory watcher.

:func:`prometheus_text` renders an entire
:class:`~sparkflow_tpu_torch.utils.metrics.Metrics` registry in the Prometheus
text exposition format (v0.0.4) — counters as ``counter``, gauges and
scalar-series last values as ``gauge``, histograms as ``summary`` with
``{quantile="..."}`` sample lines plus ``_sum``/``_count``. The serving
front serves it at ``GET /metrics?format=prometheus`` (JSON stays the
default), so a stock Prometheus scrape_config can point at an
``InferenceServer`` unchanged.

:class:`MemoryWatcher` is a daemon sampling thread that publishes per-device
``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit`` from
:func:`device_memory_stats` (``torch.cuda`` allocator counters) as
``mem/<device>/<stat>`` gauges — the watermark signal that tells you a
serving process is one batch away from an OOM before it happens.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

from ..utils.metrics import Metrics, default_metrics

__all__ = ["prometheus_text", "prometheus_name", "MemoryWatcher"]

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    """Registry name → legal Prometheus metric name: every illegal char
    becomes ``_``; a leading digit gets a ``_`` prefix."""
    out = _NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "_"


def _fmt(v: float) -> str:
    # Prometheus accepts Go-style floats; repr keeps full precision and
    # renders inf/nan as 'inf'/'nan' via the explicit branches below
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


class _NameTable:
    """Registry name → unique Prometheus name. Sanitization is lossy
    (``a/b`` and ``a.b`` both become ``a_b``), so colliding names get a
    numeric suffix instead of silently overwriting each other in the
    exposition. Deterministic: families are rendered in sorted order, so
    the same registry always yields the same suffixes."""

    def __init__(self):
        self._owner: Dict[str, str] = {}   # prometheus name -> registry name

    def resolve(self, name: str) -> str:
        pn = prometheus_name(name)
        if self._owner.get(pn, name) == name:
            self._owner[pn] = name
            return pn
        i = 2
        while True:
            cand = f"{pn}_{i}"
            if self._owner.get(cand, name) == name:
                self._owner[cand] = name
                return cand
            i += 1


def prometheus_text(metrics: Optional[Metrics] = None) -> str:
    """Render ``metrics`` (default: the process registry) as Prometheus
    text exposition. Safe to call from any thread; takes one consistent
    registry snapshot. Every family gets ``# HELP`` (carrying the original
    registry name) and ``# TYPE``; registry names whose sanitized forms
    collide are de-duplicated with a ``_2``/``_3``... suffix."""
    m = metrics if metrics is not None else default_metrics
    scalars, counters, gauges, hists = m._snapshot()
    names = _NameTable()
    lines = []

    for name in sorted(counters):
        pn = names.resolve(name)
        lines.append(f"# HELP {pn} counter {name}")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_fmt(counters[name])}")

    for name in sorted(gauges):
        pn = names.resolve(name)
        value, _ts = gauges[name]
        lines.append(f"# HELP {pn} gauge {name}")
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(value)}")

    # scalar time series: expose the most recent point as a gauge (the
    # full series is a training artifact; scrapes want current state)
    for name in sorted(scalars):
        pts = scalars[name]
        if not pts:
            continue
        pn = names.resolve(name)
        lines.append(f"# HELP {pn} last value of scalar series {name}")
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(pts[-1][1])}")

    # histograms → Prometheus summary: quantile samples + _sum + _count
    for name in sorted(hists):
        h = hists[name]
        pn = names.resolve(name)
        lines.append(f"# HELP {pn} summary of {name}")
        lines.append(f"# TYPE {pn} summary")
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            lines.append(f'{pn}{{quantile="{q}"}} {_fmt(h[key])}')
        lines.append(f"{pn}_sum {_fmt(h['sum'])}")
        lines.append(f"{pn}_count {_fmt(h['count'])}")

    return "\n".join(lines) + "\n" if lines else ""


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card allocator counters (``torch.cuda.memory_allocated`` and
    friends) for every card this process has already initialised; empty on
    the CPU. Never initialises CUDA itself: a sampling thread must not be
    the one that creates the context."""
    import torch
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def _host_rss_bytes() -> Optional[int]:
    """Current resident set size of this process, or None where
    ``/proc`` isn't available (the CPU backend's allocator reports no
    per-device stats, so host RSS is the honest fallback signal there)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class MemoryWatcher:
    """Background sampler of memory state into ``mem/*`` gauges.

    Publishes per-device ``bytes_in_use`` / ``peak_bytes_in_use`` /
    ``bytes_limit`` for each initialised CUDA card (the CPU has no
    allocator stats), plus the process's host RSS as ``mem/host/rss_bytes``
    everywhere — so the gauge family is never empty just because the run
    is on the CPU backend.

    ``start()``/``stop()`` are idempotent; the thread is a daemon so it
    never blocks interpreter exit. ``sample()`` can also be called directly
    for a one-shot reading.
    """

    def __init__(self, metrics: Optional[Metrics] = None,
                 interval_s: float = 1.0, prefix: str = "mem"):
        self.metrics = metrics if metrics is not None else default_metrics
        self.interval_s = float(interval_s)
        self.prefix = prefix
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MemoryWatcher":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            t = threading.Thread(target=self._run, name="obs-memwatch",
                                 daemon=True)
            self._thread = t
        t.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        self._stop.set()
        if t is not None:
            t.join(timeout=timeout)

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    def __enter__(self) -> "MemoryWatcher":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def sample(self) -> Dict[str, Dict[str, int]]:
        """Take one reading and publish it; returns the raw stats dict."""
        stats = device_memory_stats()
        m = self.metrics
        for dev, s in stats.items():
            for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                if key in s:
                    m.gauge(f"{self.prefix}/{dev}/{key}", s[key])
        rss = _host_rss_bytes()
        if rss is not None:
            m.gauge(f"{self.prefix}/host/rss_bytes", rss)
            stats = dict(stats, host={"rss_bytes": rss})
        return stats

    def _run(self) -> None:
        while True:
            try:
                self.sample()
            except Exception:
                pass  # a flaky backend stat must never kill the thread
            if self._stop.wait(self.interval_s):
                return
