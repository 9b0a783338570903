"""Fleet trace collection: tail-sampled assembly of cross-process request
timelines.

A request that traverses the fleet leaves spans in several process-local
:class:`~sparkflow_tpu_torch.obs.spans.Tracer` rings: the router's dispatch and
hedge-attempt spans, each replica's queue/admission/prefill/per-tick decode
spans. This module turns those fragments into ONE waterfall:

- :func:`trace_spans` extracts every span belonging to a trace id from one
  tracer ring — seed spans carry ``trace_id`` in their args; the closure
  adds their descendants (children rarely repeat the id) and ancestors, and
  normalization maps each onto the wall clock via the tracer's origin pair
  and fingerprints its ids, so fragments from different processes merge
  without collisions. Replicas serve this as ``GET /traces/<trace_id>``.
- :class:`TraceCollector` lives in the router. After each request it makes
  a **tail-based** retention decision (:meth:`TraceCollector.should_keep`):
  errored, hedged, retried, or slow-vs-live-p95 requests are always kept;
  a configurable head-sample fraction of the boring rest rides along.
  Kept traces are assembled synchronously — fetch the winning (and losing)
  replicas' fragments, merge with the router's own, link the replica roots
  to the dispatch attempts via the ``parent_uid`` each replica recorded
  from its ``traceparent`` header — and stored in a bounded ring
  (:attr:`TraceCollector.max_traces`, same boundedness contract as
  ``MAX_SPANS``). Because keep-worthy requests are rare by construction,
  the hot path pays only the decision, never the assembly.

Exports: :meth:`TraceCollector.to_chrome_trace` renders a merged trace as
Chrome-trace JSON (one synthetic pid per process fingerprint, so
chrome://tracing / Perfetto shows each process as its own lane on one
timeline); :meth:`TraceCollector.export_jsonl` writes one span per line for
log pipelines.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple
from urllib.parse import urlparse

from ..utils.metrics import Metrics, default_metrics
from .spans import Span, Tracer

__all__ = ["TraceCollector", "trace_spans", "normalize_span"]

#: assembled traces retained by a collector (oldest evicted first)
MAX_TRACES = 256

#: minimum observations before "slow vs live p95" can fire (a cold
#: histogram's p95 is noise; until then only error/hedge/retry/head keep)
MIN_P95_SAMPLES = 20


def normalize_span(tracer: Tracer, s: Span,
                   thread: Optional[str] = None) -> Dict[str, Any]:
    """One span → a process-independent record: fingerprinted ids, wall-clock
    start (``ts``, epoch seconds), duration. A root span that carried its
    cross-process parent in ``args["parent_uid"]`` (stamped by the server
    from the incoming ``traceparent``) gets that uid as its ``parent_id``,
    which is what links a replica's fragment under the router's dispatch
    attempt in the merged waterfall."""
    t1 = s.t1 if s.t1 is not None else s.t0
    rec: Dict[str, Any] = {
        "name": s.name,
        "span_id": tracer.span_uid(s.span_id),
        "parent_id": tracer.span_uid(s.parent_id),
        "process": tracer.fingerprint,
        "ts": tracer.wall_time(s.t0),
        "duration_s": round(t1 - s.t0, 9),
    }
    if thread is not None:
        rec["thread"] = thread
    if s.args:
        rec["args"] = dict(s.args)
        if rec["parent_id"] is None and s.args.get("parent_uid"):
            rec["parent_id"] = s.args["parent_uid"]
    return rec


def trace_spans(tracer: Tracer, trace_id: str) -> List[Dict[str, Any]]:
    """Every span in ``tracer``'s ring belonging to ``trace_id``, as
    normalized records sorted by wall-clock start.

    Seeds are spans whose args carry the trace id; the transitive closure
    adds descendants (a decode tick parents to the request span without
    repeating the id) and ancestors, so callers only need to stamp the id
    on the boundary spans."""
    with tracer._lock:
        spans = list(tracer._spans)
        tids = dict(tracer._tids)
    keep = {s.span_id for s in spans
            if s.args and s.args.get("trace_id") == trace_id}
    if not keep:
        return []
    # descendants: children point at parents, so iterate to a fixpoint
    changed = True
    while changed:
        changed = False
        for s in spans:
            if (s.span_id not in keep and s.parent_id is not None
                    and s.parent_id in keep):
                keep.add(s.span_id)
                changed = True
    # ancestors: walk each seed's parent chain
    by_id = {s.span_id: s for s in spans}
    for sid in list(keep):
        cur = by_id.get(sid)
        while cur is not None and cur.parent_id is not None:
            if cur.parent_id in keep:
                break
            keep.add(cur.parent_id)
            cur = by_id.get(cur.parent_id)
    out = [normalize_span(tracer, s, thread=tids.get(s.tid, str(s.tid)))
           for s in spans if s.span_id in keep]
    out.sort(key=lambda r: r["ts"])
    return out


class TraceCollector:
    """Router-side tail-sampled trace buffer + cross-process assembly.

    ``tracer`` is the router's own tracer (its dispatch/hedge spans seed
    every assembly). Retention knobs:

    - ``head_sample`` — fraction of unremarkable requests kept anyway
      (0 disables; 1.0 keeps everything).
    - ``slow_factor`` — keep when ``duration_ms >= slow_factor × live p95``
      of the ``latency_hist`` histogram (windowed, so "slow" tracks what
      the fleet did recently, not its whole life).
    - errored / hedged / retried requests are always kept — the tail that
      actually needs explaining.

    Assembly fetches ``GET /traces/<trace_id>`` from each replica URL the
    request touched — outside the collector lock, so a slow replica never
    stalls concurrent keep decisions — and merges the fragments with the
    router's own spans into one ``ts``-ordered record ring."""

    def __init__(self, tracer: Tracer, *, metrics: Optional[Metrics] = None,
                 head_sample: float = 0.01, slow_factor: float = 1.0,
                 latency_hist: str = "router/request_ms",
                 max_traces: int = MAX_TRACES, fetch_timeout_s: float = 2.0,
                 seed: Optional[int] = None):
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else default_metrics
        self.head_sample = float(head_sample)
        self.slow_factor = float(slow_factor)
        self.latency_hist = latency_hist
        self.max_traces = int(max_traces)
        self.fetch_timeout_s = float(fetch_timeout_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._seen = 0

    # -- retention -----------------------------------------------------------

    def should_keep(self, duration_ms: float, *, error: bool = False,
                    hedged: bool = False,
                    retried: bool = False) -> Optional[str]:
        """Tail-based retention verdict: the reason string when the trace
        should be kept in full, None when it should be dropped."""
        if error:
            return "error"
        if hedged:
            return "hedged"
        if retried:
            return "retried"
        with self._lock:
            self._seen += 1
            seen = self._seen
            head = self._rng.random() < self.head_sample
        if seen >= MIN_P95_SAMPLES:
            try:
                p95 = self.metrics.percentile(self.latency_hist, 95,
                                              window=1024)
            except (KeyError, ValueError):
                p95 = None
            if p95 is not None and duration_ms >= self.slow_factor * p95:
                return "slow"
        if head:
            return "head"
        return None

    # -- assembly ------------------------------------------------------------

    def observe_request(self, trace_id: str, duration_ms: float, *,
                        error: bool = False, hedged: bool = False,
                        retried: bool = False,
                        replicas: Iterable[str] = ()) -> Optional[Dict[str, Any]]:
        """Per-request hook: decide, and assemble only when kept. Returns
        the assembled trace record or None (dropped)."""
        reason = self.should_keep(duration_ms, error=error, hedged=hedged,
                                  retried=retried)
        if reason is None:
            self.metrics.incr("trace/sampled_out")
            return None
        return self.assemble(trace_id, replicas=replicas, reason=reason,
                             duration_ms=duration_ms)

    def assemble(self, trace_id: str, *, replicas: Iterable[str] = (),
                 reason: str = "manual",
                 duration_ms: Optional[float] = None) -> Dict[str, Any]:
        """Merge the router's own spans for ``trace_id`` with each replica's
        ``GET /traces/<trace_id>`` fragment into one wall-clock-ordered
        trace; store it in the bounded ring and return it."""
        records = trace_spans(self.tracer, trace_id)
        for url in replicas:
            records.extend(self._fetch(url, trace_id))
        # de-duplicate on the fingerprinted uid (a replica probed twice, or
        # a local span that also came back over the wire, merges to one)
        seen: Dict[str, Dict[str, Any]] = {}
        for rec in records:
            seen.setdefault(rec["span_id"], rec)
        spans = sorted(seen.values(), key=lambda r: r["ts"])
        trace = {"trace_id": trace_id, "reason": reason, "spans": spans,
                 "processes": sorted({r["process"] for r in spans}),
                 "replicas": list(replicas)}
        if duration_ms is not None:
            trace["duration_ms"] = duration_ms
        with self._lock:
            self._traces[trace_id] = trace
            self._traces.move_to_end(trace_id)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
        self.metrics.incr("trace/kept")
        return trace

    def _fetch(self, url: str, trace_id: str) -> List[Dict[str, Any]]:
        """One replica's fragment via a one-shot GET (no pooling: assembly
        is rare by construction, and a dedicated connection keeps this path
        independent of the dispatch pools). Any failure returns [] — a
        replica that died mid-request still yields a partial trace."""
        parsed = urlparse(url if "//" in url else f"http://{url}")
        conn = http.client.HTTPConnection(parsed.hostname,
                                          parsed.port or 80,
                                          timeout=self.fetch_timeout_s)
        try:
            conn.request("GET", f"/traces/{trace_id}")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return []
            obj = json.loads(body.decode("utf-8"))
            spans = obj.get("spans", [])
            return [s for s in spans if isinstance(s, dict)]
        except (OSError, ValueError):
            self.metrics.incr("trace/fetch_errors")
            return []
        finally:
            conn.close()

    # -- introspection -------------------------------------------------------

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._traces.get(trace_id)

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def traces(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._traces.values())

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self, trace_id: str) -> Dict[str, Any]:
        """One assembled trace as Chrome-trace JSON: a synthetic pid per
        process fingerprint (each process gets its own lane), ts/dur in
        microseconds relative to the trace's first span. Raises KeyError
        for an unknown trace id."""
        trace = self.get(trace_id)
        if trace is None:
            raise KeyError(f"no assembled trace {trace_id!r}")
        spans = trace["spans"]
        t0 = min((r["ts"] for r in spans), default=0.0)
        pids = {proc: i + 1 for i, proc in enumerate(trace["processes"])}
        events: List[Dict[str, Any]] = []
        for proc, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": f"process {proc}"}})
        threads: Dict[Tuple[int, str], int] = {}
        for rec in spans:
            pid = pids[rec["process"]]
            key = (pid, rec.get("thread", "main"))
            tid = threads.get(key)
            if tid is None:
                tid = threads[key] = len([k for k in threads
                                          if k[0] == pid]) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tid, "args": {"name": key[1]}})
            args = dict(rec.get("args") or {})
            args["span_id"] = rec["span_id"]
            if rec.get("parent_id"):
                args["parent_id"] = rec["parent_id"]
            args["trace_id"] = trace_id
            events.append({
                "name": rec["name"], "ph": "X", "cat": "trace",
                "ts": round((rec["ts"] - t0) * 1e6, 3),
                "dur": round(rec["duration_s"] * 1e6, 3),
                "pid": pid, "tid": tid, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, trace_id: str, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(trace_id), f)
        os.replace(tmp, path)
        return path

    def export_jsonl(self, trace_id: str, path: str) -> str:
        """One span record per line (already wall-clock ``ts``-ordered)."""
        trace = self.get(trace_id)
        if trace is None:
            raise KeyError(f"no assembled trace {trace_id!r}")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            for rec in trace["spans"]:
                f.write(json.dumps(dict(rec, trace_id=trace_id)) + "\n")
        os.replace(tmp, path)
        return path

    @staticmethod
    def waterfall(trace: Dict[str, Any]) -> str:
        """Human-readable indentation waterfall of an assembled trace —
        what ``examples/trace_smoke.py`` prints."""
        spans = trace["spans"]
        children: Dict[Optional[str], List[Dict[str, Any]]] = {}
        ids = {r["span_id"] for r in spans}
        for rec in spans:
            parent = rec.get("parent_id")
            if parent not in ids:
                parent = None  # orphaned fragment → render at the root
            children.setdefault(parent, []).append(rec)
        t0 = min((r["ts"] for r in spans), default=0.0)
        lines = [f"trace {trace['trace_id']} "
                 f"(reason={trace.get('reason')}, "
                 f"processes={len(trace.get('processes', []))})"]

        def walk(parent: Optional[str], depth: int) -> None:
            for rec in sorted(children.get(parent, ()),
                              key=lambda r: r["ts"]):
                label = ""
                args = rec.get("args") or {}
                if "outcome" in args:
                    label = f" [{args['outcome']}]"
                lines.append(
                    f"  {'  ' * depth}+{(rec['ts'] - t0) * 1e3:9.3f}ms "
                    f"{rec['duration_s'] * 1e3:9.3f}ms  {rec['name']}"
                    f"{label}  ({rec['process'][-6:]})")
                walk(rec["span_id"], depth + 1)

        walk(None, 0)
        return "\n".join(lines)
