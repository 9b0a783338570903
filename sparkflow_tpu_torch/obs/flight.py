"""Crash flight recorder: always-on, bounded, SIGKILL-survivable.

Crash replacement (the JAX package's ``Autoscaler``/``ReplicaManager``) keeps the
fleet serving through a replica death — but the dead process takes its
in-memory tracer ring and metrics with it, so the crash is unexplainable
postmortem. :class:`FlightRecorder` closes that gap with two write paths
of different durability:

- **Begin/end event lines** are appended *and flushed* to the JSONL file
  the moment a request enters / leaves the process. SIGKILL runs no
  handlers, so the only evidence that can survive it is evidence already
  on disk — replaying begins-without-ends names exactly the trace ids
  that were in flight when the process died.
- The **full dump** — recent spans (bounded), metric *deltas* since
  install, the live in-flight set — is appended on SIGTERM and atexit,
  the cases where the process does get a last word.

:func:`harvest_flight` parses a (possibly truncated — the process may
have died mid-write) recorder file back into one postmortem record;
``ReplicaManager`` calls it when it reaps or destroys a dead replica and
logs the in-flight trace ids.

The file is bounded: matched begin/end pairs are compacted away once the
event count passes a threshold, so an always-on recorder in a months-long
replica stays a few KB, not a log that grows without limit (the same
contract as the span ring's ``MAX_SPANS``).
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.metrics import Metrics, default_metrics
from .collector import normalize_span
from .spans import Tracer, default_tracer

__all__ = ["FlightRecorder", "harvest_flight"]

#: spans included in a dump (most recent first in time order)
MAX_DUMP_SPANS = 512

#: begin/end lines on disk before matched pairs are compacted away
COMPACT_THRESHOLD = 4096


class FlightRecorder:
    """Bounded request-event log + last-word dump for one process.

    ``path`` is this process's recorder file (the fleet convention is
    ``<flight_dir>/replica-<port>.jsonl`` so the manager can find it by
    port). ``install()`` arms the SIGTERM chain (previous handler — e.g.
    the server's drain — still runs after the dump) and the atexit hook;
    ``close()`` disarms both and closes the file. All methods are
    thread-safe and never raise out of the signal path."""

    def __init__(self, path: str, *, tracer: Optional[Tracer] = None,
                 metrics: Optional[Metrics] = None,
                 max_dump_spans: int = MAX_DUMP_SPANS):
        self.path = path
        self.tracer = tracer if tracer is not None else default_tracer
        self.metrics = metrics if metrics is not None else default_metrics
        self.max_dump_spans = int(max_dump_spans)
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # unbuffered binary append: every line is one write(2) straight to
        # disk — the durability the begin/end path needs, without paying a
        # buffered-writer flush on the serving hot path (~3x cheaper)
        self._f = open(path, "ab", buffering=0)
        self._inflight: Dict[str, float] = {}
        self._events = 0
        self._dumped = False
        self._baseline = self.metrics.counters()
        self._prev_sigterm: Any = None
        self._signal_installed = False
        self._atexit_installed = False
        self._write({"event": "open", "process": self.tracer.fingerprint,
                     "pid": os.getpid(), "ts": time.time()})

    # -- event log (SIGKILL-survivable path) ---------------------------------

    def _write_line(self, line: str) -> None:
        """Append one pre-serialized JSON line. Caller holds the lock (or
        is the constructor, before the recorder is shared)."""
        f = self._f
        if f is None:
            return
        try:
            f.write((line + "\n").encode("utf-8"))
        except (OSError, ValueError):
            pass  # a full disk must never take the serving path down

    def _write(self, rec: Dict[str, Any]) -> None:
        self._write_line(json.dumps(rec))

    def begin(self, trace_id: str,
              request_id: Optional[str] = None) -> None:
        """A request with ``trace_id`` entered this process."""
        # hand-formatted on the hot path (json.dumps of the whole record
        # costs more than the write itself); request_id is user-supplied
        # so only IT goes through the serializer
        ts = time.time()
        line = '{"event":"begin","trace_id":%s,"ts":%r}' % (
            json.dumps(trace_id), ts)
        if request_id:
            line = '%s,"request_id":%s}' % (line[:-1], json.dumps(request_id))
        with self._lock:
            self._inflight[trace_id] = ts
            self._events += 1
            self._write_line(line)

    def end(self, trace_id: str, error: bool = False) -> None:
        """The request left (completed or failed — either way it is no
        longer in flight, so its begin/end pair is compactable)."""
        line = '{"event":"end","trace_id":%s,"ts":%r%s}' % (
            json.dumps(trace_id), time.time(),
            ',"error":true' if error else "")
        with self._lock:
            self._inflight.pop(trace_id, None)
            self._events += 1
            self._write_line(line)
            if self._events >= COMPACT_THRESHOLD:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the file keeping only still-open begins (+ any dump
        lines), then atomically replace — bounds the always-on log."""
        f = self._f
        if f is None:
            return
        tmp = f"{self.path}.tmp-{os.getpid()}"
        try:
            kept: List[str] = []
            with open(self.path) as src:
                for line in src:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    ev = rec.get("event")
                    if ev == "begin" and rec.get("trace_id") in self._inflight:
                        kept.append(line)
                    elif ev in ("open", "dump"):
                        kept.append(line)
            with open(tmp, "w") as out:
                out.writelines(kept)
            f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab", buffering=0)
            self._events = len(kept)
        except (OSError, ValueError):
            # compaction is best-effort; keep appending to the old handle
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def inflight(self) -> List[str]:
        with self._lock:
            return sorted(self._inflight)

    # -- the last word (SIGTERM / atexit path) -------------------------------

    def dump(self, reason: str = "manual", force: bool = False) -> str:
        """Append the full postmortem record: recent spans, metric deltas
        since construction, the in-flight set. Idempotent unless ``force``
        (SIGTERM then atexit should not double-dump). Returns the path."""
        spans = self.tracer.spans()[-self.max_dump_spans:]
        records = [normalize_span(self.tracer, s) for s in spans]
        counters = self.metrics.counters()
        deltas = {}
        for name, value in counters.items():
            d = value - self._baseline.get(name, 0.0)
            if d:
                deltas[name] = d
        with self._lock:
            if self._dumped and not force:
                return self.path
            self._dumped = True
            self._write({"event": "dump", "reason": reason,
                         "process": self.tracer.fingerprint,
                         "pid": os.getpid(), "ts": time.time(),
                         "inflight": sorted(self._inflight),
                         "spans": records, "metric_deltas": deltas})
        return self.path

    # -- arming --------------------------------------------------------------

    def install(self, signals=(signal.SIGTERM,)) -> "FlightRecorder":
        """Arm the atexit hook, and (main thread only — ``signal.signal``
        raises elsewhere) chain a dump in front of the existing handler
        for each of ``signals``."""
        if not self._atexit_installed:
            atexit.register(self._atexit_dump)
            self._atexit_installed = True
        for sig in signals:
            try:
                prev = signal.signal(sig, self._on_signal)
            except ValueError:
                break  # not the main thread; atexit still covers us
            if sig == signal.SIGTERM:
                self._prev_sigterm = prev
                self._signal_installed = True
        return self

    def _on_signal(self, signum, frame) -> None:
        self.dump(reason=f"signal:{signum}")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore and re-raise so default termination still happens
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def _atexit_dump(self) -> None:
        try:
            self.dump(reason="atexit")
        except Exception:
            pass  # interpreter teardown: never raise into atexit

    def close(self) -> None:
        """Disarm hooks, restore the previous SIGTERM handler, close the
        file. Idempotent."""
        if self._atexit_installed:
            try:
                atexit.unregister(self._atexit_dump)
            except Exception:
                pass
            self._atexit_installed = False
        if self._signal_installed:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, TypeError):
                pass
            self._signal_installed = False
        with self._lock:
            f = self._f
            self._f = None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def harvest_flight(path: str) -> Optional[Dict[str, Any]]:
    """Parse a recorder file back into one postmortem record, tolerating a
    truncated last line (the process may have died mid-write — that is the
    point). Returns None when the file is missing or empty.

    ``inflight_trace_ids`` is replayed from begin/end lines, so it is
    correct even for SIGKILL (no dump line); when a dump IS present its
    spans and metric deltas ride along."""
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return None
    process = None
    begins: Dict[str, float] = {}
    ended = set()
    total_begins = total_ends = 0
    dump: Optional[Dict[str, Any]] = None
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail line
        ev = rec.get("event")
        if ev == "open":
            process = rec.get("process", process)
        elif ev == "begin" and rec.get("trace_id"):
            begins[rec["trace_id"]] = rec.get("ts", 0.0)
            total_begins += 1
        elif ev == "end" and rec.get("trace_id"):
            ended.add(rec["trace_id"])
            total_ends += 1
        elif ev == "dump":
            dump = rec
            process = rec.get("process", process)
    if process is None and not begins and dump is None:
        return None
    inflight = sorted(t for t in begins if t not in ended)
    out: Dict[str, Any] = {
        "path": path,
        "process": process,
        "begins": total_begins,
        "ends": total_ends,
        "inflight_trace_ids": inflight,
        "dumped": dump is not None,
    }
    if dump is not None:
        out["reason"] = dump.get("reason")
        out["spans"] = dump.get("spans", [])
        out["metric_deltas"] = dump.get("metric_deltas", {})
    return out
