"""Structured training metrics (replaces the reference's print-based logging,
``sparkflow/HogwildSparkModel.py:94-98`` — SURVEY.md §5 "observability").

A process-local registry of counters/gauges/timings/histograms with JSONL
export and an optional per-step callback fan-out. Cheap enough to leave on:
recording is a dict update; device syncs only happen where the caller already
has a value. Histograms (``observe``/``percentile``) back the serving-side
latency metrics (p50/p95/p99) and are bounded by a reservoir cap so a
long-lived server never grows without limit.

Four value kinds, four write paths:

- ``scalar(name, v, step)`` — a time series (loss curves); every point kept.
- ``incr(name)``            — a monotone counter (requests served).
- ``gauge(name, v)``        — last-value-wins (queue depth, memory in use);
                              no history, one float per name.
- ``observe(name, v)``      — a distribution (latencies); reservoir-sampled.

Serving handlers record from many threads, so every read-modify-write —
including ``scalar``'s default-step computation and the listener snapshot —
happens under one registry lock. Listeners themselves are invoked *outside*
the lock (a listener that records back into the registry must not deadlock).
Prometheus text exposition of the whole registry lives in
:mod:`sparkflow_tpu_torch.obs.exporters`.
"""

from __future__ import annotations

import json
import random
import re
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# Per-histogram sample cap. Beyond it, reservoir sampling keeps a uniform
# sample of the whole stream (percentiles stay unbiased) instead of the
# unbounded append a months-long serving process would otherwise pay for.
HISTOGRAM_RESERVOIR = 4096

# How many of the MOST RECENT observations each histogram also retains,
# in insertion order, for windowed percentiles. The reservoir above is a
# uniform sample of the whole stream — slicing its tail has no recency
# bias at all (overwrites land at random positions), so a "windowed"
# read off it would ossify: a past overload burst stays in the signal
# forever and a new one barely registers once the stream is long. The
# deque is the true sliding window; window= reads larger than this cap
# are clamped to it.
HISTOGRAM_WINDOW = 1024


class _Histogram:
    """Reservoir-sampled value distribution with exact count/min/max/sum
    plus a bounded insertion-ordered tail for windowed percentiles."""

    __slots__ = ("samples", "recent", "count", "total", "vmin", "vmax",
                 "_rng")

    def __init__(self, seed: int = 0):
        self.samples: List[float] = []
        self.recent: deque = deque(maxlen=HISTOGRAM_WINDOW)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        self.recent.append(value)
        if len(self.samples) < HISTOGRAM_RESERVOIR:
            self.samples.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < HISTOGRAM_RESERVOIR:
                self.samples[j] = value

    def percentile(self, q: float, window: Optional[int] = None) -> float:
        """Linear-interpolated q-th percentile (q in [0, 100]).

        Without ``window``: over the whole-stream reservoir sample. With
        ``window``: over exactly the last ``window`` observations (clamped
        to ``HISTOGRAM_WINDOW``) from the insertion-ordered tail — a true
        sliding window, so the autoscaler's p95 tracks what the fleet did
        in the last N requests, not a uniform sample of its whole life."""
        if not self.samples:
            raise ValueError("empty histogram")
        if window is None or int(window) <= 0:
            s = sorted(self.samples)
        else:
            s = sorted(list(self.recent)[-int(window):])
            if not s:
                # the sliding tail can be empty while the reservoir is not
                # (e.g. a histogram restored without its recent deque);
                # fall back to the whole-stream sample rather than index
                # into an empty list
                s = sorted(self.samples)
        if len(s) == 1:
            return s[0]
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            # an empty histogram summarizes to zeros (not ±inf min/max, not
            # a ValueError): snapshot/exposition paths must render whatever
            # exists without crashing on a series that never observed
            return {"count": self.count, "sum": self.total, "mean": 0.0,
                    "min": 0.0, "max": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count if self.count else 0.0,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class Metrics:
    def __init__(self):
        self._scalars: Dict[str, List[tuple]] = defaultdict(list)
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, Tuple[float, float]] = {}  # name -> (v, ts)
        self._hists: Dict[str, _Histogram] = {}
        self._listeners: List[Callable[[str, float, int], None]] = []
        self._lock = threading.Lock()

    def scalar(self, name: str, value: float, step: Optional[int] = None) -> None:
        value = float(value)
        with self._lock:
            # the default step is "next index in this series" — a
            # read-modify-write that must not race with another recorder
            if step is None:
                step = len(self._scalars[name])
            self._scalars[name].append((step, value, time.time()))
            listeners = tuple(self._listeners)
        # fan out outside the lock: a listener recording back into this
        # registry (e.g. mirroring losses into a gauge) must not deadlock
        for fn in listeners:
            fn(name, value, step)

    def incr(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += amount

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins instantaneous reading (queue depth, bytes in
        use). Unlike ``scalar`` it keeps no history — the natural shape for
        sampled state, and what Prometheus expects of a gauge."""
        with self._lock:
            self._gauges[name] = (float(value), time.time())

    def observe(self, name: str, value: float) -> None:
        """Record one observation into the ``name`` histogram (latencies,
        batch sizes, fill ratios — anything whose distribution matters more
        than its last value)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram(seed=len(self._hists))
            h.add(float(value))

    def percentile(self, name: str, q: float,
                   window: Optional[int] = None) -> float:
        """q-th percentile (q in [0, 100]) of histogram ``name``;
        ``window`` = only the most recent samples (see
        :meth:`_Histogram.percentile`)."""
        with self._lock:
            if name not in self._hists:
                raise KeyError(f"no histogram named {name!r}")
            return self._hists[name].percentile(q, window)

    def percentiles(self, name: str,
                    qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        """{'p50': ..., 'p95': ..., 'p99': ...} for histogram ``name``."""
        return {f"p{g:g}": self.percentile(name, g) for g in qs}

    def subscribe(self, fn: Callable[[str, float, int], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def series(self, name: str) -> List[tuple]:
        with self._lock:
            return list(self._scalars.get(name, []))

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return {name: v for name, (v, _) in self._gauges.items()}

    def histograms(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: h.summary() for name, h in self._hists.items()
                    if h.count}

    def _snapshot(self):
        """One consistent view of every table (single lock acquisition, so
        summary/JSONL export can't interleave with concurrent recorders)."""
        with self._lock:
            scalars = {name: list(pts) for name, pts in self._scalars.items()}
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {name: h.summary() for name, h in self._hists.items()
                     if h.count}
        return scalars, counters, gauges, hists

    def summary(self) -> Dict[str, Any]:
        scalars, counters, gauges, hists = self._snapshot()
        out: Dict[str, Any] = {"counters": counters}
        for name, pts in scalars.items():
            vals = [v for _, v, _ in pts]
            out[name] = {"last": vals[-1], "min": min(vals), "max": max(vals),
                         "count": len(vals)}
        if gauges:
            out["gauges"] = {name: v for name, (v, _) in gauges.items()}
        if hists:
            out["histograms"] = hists
        return out

    def dump_jsonl(self, path: str) -> None:
        scalars, counters, gauges, hists = self._snapshot()
        with open(path, "w") as f:
            for name, pts in scalars.items():
                for step, value, ts in pts:
                    f.write(json.dumps({"name": name, "step": step,
                                        "value": value, "ts": ts}) + "\n")
            for name, value in counters.items():
                f.write(json.dumps({"name": name, "counter": value}) + "\n")
            for name, (value, ts) in gauges.items():
                f.write(json.dumps({"name": name, "gauge": value,
                                    "ts": ts}) + "\n")
            for name, hist in hists.items():
                f.write(json.dumps({"name": name, "histogram": hist}) + "\n")

    def remove_prefix(self, prefix: str) -> int:
        """Drop every series whose name starts with ``prefix`` (all four
        tables); returns how many were removed. This is the deregistration
        path: a replica leaving the fleet must take its
        ``router/replica<i>/*`` gauges with it, or the exposition keeps
        advertising a ghost replica forever."""
        removed = 0
        with self._lock:
            for table in (self._scalars, self._counters, self._gauges,
                          self._hists):
                for name in [n for n in table if n.startswith(prefix)]:
                    del table[name]
                    removed += 1
        return removed

    def remove_matching(self, match) -> int:
        """Drop every series whose name matches ``match`` — a regex string
        (``re.search`` semantics) or a ``name -> bool`` callable — across
        all four tables; returns how many were removed. The general form of
        :meth:`remove_prefix` for cleanups a prefix can't express (e.g.
        one metric family across every replica: ``r"^router/replica\\d+/"
        "kv_pages_free$"``)."""
        if callable(match):
            pred = match
        else:
            pred = re.compile(match).search
        removed = 0
        with self._lock:
            for table in (self._scalars, self._counters, self._gauges,
                          self._hists):
                for name in [n for n in table if pred(n)]:
                    del table[name]
                    removed += 1
        return removed

    def reset(self) -> None:
        with self._lock:
            self._scalars.clear()
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


default_metrics = Metrics()


class timer:
    """``with timer('stage'):`` records wall seconds into the registry."""

    def __init__(self, name: str, metrics: Optional[Metrics] = None):
        self.name = name
        self.metrics = metrics or default_metrics

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.scalar(f"time/{self.name}", time.perf_counter() - self._t0)
        return False
