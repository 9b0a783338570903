"""Structured spans: low-overhead host-side tracing with nesting.

The reference's only temporal signal is a fixed 8-second sleep and a print
per loss (``sparkflow/HogwildSparkModel.py:94-98``); nothing in it can answer
"where did this step/request spend its time". :class:`Tracer` closes that
gap on the host side of this framework: a :class:`Span` is a named
``[t0, t1)`` interval with parent/child nesting (thread-local, so ``with``
blocks nest naturally within a thread; cross-thread chains pass the parent
explicitly — the MicroBatcher worker parents its per-request spans to the
HTTP handler's span this way).

Finished spans land in a bounded ring buffer, exportable two ways:

- :meth:`Tracer.export_chrome_trace` — Chrome-trace ``traceEvents`` JSON
  (open in ``chrome://tracing`` or ui.perfetto.dev), one ``ph: "X"``
  complete event per span plus thread-name metadata.
- :meth:`Tracer.export_jsonl` — one JSON object per span for log pipelines.

Device-side integration: ``span(..., profiler_annotation=True)`` additionally
enters :func:`sparkflow_tpu_torch.utils.tracing.annotate` (a
``torch.profiler.record_function`` range, and an NVTX range on the card),
so when a ``torch.profiler`` capture is active the same named range shows
up in the device timeline — host spans and device annotations line up by
name.

Overhead discipline (pinned by ``python bench.py --span-overhead``): a span
is two ``perf_counter`` calls, one small allocation, and one locked ring
append — no formatting, no I/O, no torch import on this module's path. The
framework's cross-cutting span sites (checkpoint save/restore, retry
backoffs, serving requests) go through the module-level :func:`span`, which
routes to the innermost :meth:`Tracer.activate`-d tracer on this thread
(``default_tracer`` otherwise), so a traced ``fit`` collects its own
checkpoint spans without any plumbing through call signatures.

Fleet-native tracing: :class:`TraceContext` is a W3C-traceparent-style
context (128-bit trace id, parent span id, sampled flag) minted at the
router (or accepted from the client) and carried over HTTP alongside
``X-Request-Id``. Span ids are process-local ``itertools.count`` integers,
so exports namespace them with the tracer's :attr:`Tracer.fingerprint`
(``"<pidhex><random>:<n>"``) — merged multi-process traces cannot collide —
and each tracer carries one ``(perf_counter, epoch)`` origin pair so
intervals recorded in different processes land on ONE wall-clock timeline
(:meth:`Tracer.wall_time`). Assembly/sampling live in
:mod:`sparkflow_tpu_torch.obs.collector`; the crash flight recorder in
:mod:`sparkflow_tpu_torch.obs.flight`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Union

__all__ = ["Span", "TraceContext", "Tracer", "default_tracer", "span",
           "current_tracer"]

_span_ids = itertools.count(1)
_now = time.perf_counter
_get_ident = threading.get_ident

# Default ring capacity: bounded so an always-on default tracer in a
# months-long serving process cannot grow without limit (same contract as
# the metrics histogram reservoir).
MAX_SPANS = 65536

#: HTTP header that carries a :class:`TraceContext` across processes,
#: alongside the existing ``X-Request-Id`` plumbing.
TRACEPARENT_HEADER = "traceparent"

_NO_PARENT = "0" * 16  # traceparent parent field for "no parent span"


class TraceContext:
    """W3C-traceparent-style context: ``00-<trace_id>-<parent>-<flags>``.

    ``trace_id`` is 32 hex chars (128 bits), minted once per request at the
    router (or accepted from the client) and carried through every process
    the request touches. ``parent`` is the *exported* span uid of the span
    the next process should hang its root under — a
    ``"<fingerprint>:<n>"`` string (no dashes, so the 4-field dash format
    still splits), or the all-zero sentinel for "no parent". ``sampled``
    rides the flags octet; tail-based retention decisions happen at the
    collector, so the flag is a head-sampling hint, not the verdict.
    """

    __slots__ = ("trace_id", "parent", "sampled")

    def __init__(self, trace_id: str, parent: Optional[str] = None,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.parent = parent
        self.sampled = bool(sampled)

    @classmethod
    def mint(cls, sampled: bool = True) -> "TraceContext":
        """A fresh 128-bit trace id with no parent span."""
        return cls(uuid.uuid4().hex, None, sampled)

    @classmethod
    def parse(cls, header: Optional[str]) -> Optional["TraceContext"]:
        """Tolerant decode of a ``traceparent`` header; None on anything
        malformed (a bad client header must never fail the request —
        the router just mints a fresh context instead)."""
        if not header:
            return None
        parts = header.strip().split("-")
        if len(parts) != 4 or parts[0] != "00":
            return None
        trace_id, parent, flags = parts[1], parts[2], parts[3]
        if len(trace_id) != 32 or not _is_hex(trace_id):
            return None
        if int(trace_id, 16) == 0:
            return None
        if parent == _NO_PARENT:
            parent = None
        try:
            sampled = bool(int(flags, 16) & 0x01)
        except ValueError:
            return None
        return cls(trace_id, parent, sampled)

    def to_header(self) -> str:
        return (f"00-{self.trace_id}-{self.parent or _NO_PARENT}-"
                f"{'01' if self.sampled else '00'}")

    def child(self, parent_uid: str) -> "TraceContext":
        """Same trace, re-parented under an exported span uid — what the
        router stamps per dispatch attempt so each replica's spans hang
        under the attempt that actually reached it."""
        return TraceContext(self.trace_id, parent_uid, self.sampled)

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, parent={self.parent!r}, "
                f"sampled={self.sampled})")


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


class Span:
    """One named time interval. ``t0``/``t1`` are ``perf_counter`` seconds
    (monotonic, tracer-relative at export time); ``parent_id`` links child
    spans to the enclosing one (or to an explicitly passed cross-thread
    parent)."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "t0", "t1", "args")

    def __init__(self, name: str, parent_id: Optional[int], tid: int,
                 t0: float, args: Optional[Dict[str, Any]]):
        self.name = name
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.tid = tid
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = args

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) \
            - self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur={self.duration_s * 1e3:.3f}ms)")


class _SpanCtx:
    """The ``with tracer.span(...)`` handle — a plain object (not a
    generator contextmanager) to keep per-span overhead minimal."""

    __slots__ = ("tracer", "name", "args", "parent", "profiler_annotation",
                 "span", "_ann", "_stack")

    def __init__(self, tracer, name, args, parent, profiler_annotation):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.parent = parent
        self.profiler_annotation = profiler_annotation
        self.span: Optional[Span] = None
        self._ann = None
        self._stack = None

    def __enter__(self) -> Span:
        self._stack = stack = self.tracer._stack()
        parent = self.parent
        if parent is None:
            parent_id = stack[-1].span_id if stack else None
        else:
            parent_id = parent.span_id if isinstance(parent, Span) else parent
        sp = Span(self.name, parent_id, _get_ident(), _now(), self.args)
        self.span = sp
        stack.append(sp)
        if self.profiler_annotation:
            from ..utils.tracing import annotate
            self._ann = annotate(self.name)
            self._ann.__enter__()
        return sp

    def __exit__(self, *exc):
        t1 = _now()  # stamp first: nothing below belongs to the span
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        sp = self.span
        sp.t1 = t1
        stack = self._stack
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # mis-nested exit (rare; keep the stack sane)
            stack.remove(sp)
        self.tracer._commit(sp)
        return False


class _NoopSpanCtx:
    """Shared do-nothing handle returned by a disabled tracer's
    :meth:`Tracer.span` — the tracing-off baseline ``bench.py
    --trace-overhead`` compares against."""

    __slots__ = ()

    def __enter__(self) -> Optional[Span]:
        return None

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopSpanCtx()


class Tracer:
    """Collects finished spans from any number of threads.

    ``max_spans`` bounds the ring (oldest dropped first; :meth:`dropped`
    reports how many). Each thread keeps its own span stack, so nesting
    inside one thread needs no lock; only the final commit does.

    ``enabled=False`` turns the tracer into a no-op (``span()`` returns a
    shared null context, ``record()`` drops the span) — the off-baseline
    for overhead benchmarks and a kill switch for span-heavy sites.

    :attr:`fingerprint` namespaces this tracer's process-local span-id
    counter at export time (``"<pidhex><random>:<n>"`` via
    :meth:`span_uid`), so spans merged from many processes — or many
    tracers — cannot collide; :meth:`wall_time` maps the tracer's
    ``perf_counter`` stamps onto the wall clock with one origin pair, so
    merged intervals share a timeline.
    """

    def __init__(self, max_spans: int = MAX_SPANS, enabled: bool = True):
        self.max_spans = int(max_spans)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.max_spans)
        self._total = 0
        self._tids: Dict[int, str] = {}
        self._local = threading.local()
        # one time origin pair so exports can map monotonic perf_counter
        # stamps onto the wall clock
        self._origin = time.perf_counter()
        self._origin_epoch = time.time()
        # per-process (and per-tracer) fingerprint: span ids come from a
        # process-local itertools.count, so merged multi-process traces
        # need this namespace to keep ids collision-free
        self.fingerprint = f"{os.getpid():x}{uuid.uuid4().hex[:6]}"

    # -- cross-process identity ----------------------------------------------

    def span_uid(self, span_id: Optional[int]) -> Optional[str]:
        """Exported (fingerprinted) form of a process-local span id."""
        if span_id is None:
            return None
        return f"{self.fingerprint}:{span_id}"

    def wall_time(self, t: float) -> float:
        """Map one of this tracer's ``perf_counter`` stamps onto the wall
        clock (epoch seconds) via the tracer's origin pair."""
        return self._origin_epoch + (t - self._origin)

    # -- recording -----------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        """The innermost open span on THIS thread (capture it before handing
        work to another thread, then pass it as that work's ``parent=``)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def span(self, name: str, args: Optional[Dict[str, Any]] = None,
             parent: Union[Span, int, None] = None,
             profiler_annotation: bool = False):
        """``with tracer.span('phase') as sp:`` — times the block, nests
        under the current span (or the explicit ``parent``). A disabled
        tracer returns a shared no-op context (``sp`` is None)."""
        if not self.enabled:
            return _NOOP_CTX
        return _SpanCtx(self, name, args, parent, profiler_annotation)

    def record(self, name: str, t0: float, t1: float,
               parent: Union[Span, int, None] = None,
               args: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Post-hoc span from already-measured ``perf_counter`` stamps (how
        the micro-batcher reconstructs each request's queue-wait interval
        after the batch completes). Dropped (returns None) when the tracer
        is disabled."""
        if not self.enabled:
            return None
        parent_id = parent.span_id if isinstance(parent, Span) else parent
        sp = Span(name, parent_id, threading.get_ident(), t0, args)
        sp.t1 = t1
        self._commit(sp)
        return sp

    def _commit(self, sp: Span) -> None:
        name = (threading.current_thread().name
                if sp.tid not in self._tids else None)
        with self._lock:
            if name is not None:
                self._tids.setdefault(sp.tid, name)
            self._spans.append(sp)
            self._total += 1

    # -- activation (module-level span() routing) ----------------------------

    @contextlib.contextmanager
    def activate(self):
        """Make this tracer the target of the module-level :func:`span` on
        this thread for the duration (how ``Trainer.fit(trace_spans=True)``
        collects the checkpoint/retry spans fired deep in the stack)."""
        stack = _active_stack()
        stack.append(self)
        try:
            yield self
        finally:
            stack.pop()

    # -- introspection / export ----------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def dropped(self) -> int:
        """Spans evicted from the ring (recorded beyond ``max_spans``)."""
        with self._lock:
            return max(0, self._total - len(self._spans))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._total = 0

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace dict: ``{"traceEvents": [...]}`` with one complete
        (``ph: "X"``) event per span (ts/dur in microseconds) plus
        thread-name metadata events — loads in chrome://tracing and
        Perfetto."""
        with self._lock:
            spans = list(self._spans)
            tids = dict(self._tids)
        pid = os.getpid()
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "sparkflow-tpu"}}]
        for tid in sorted(tids):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tids[tid]}})
        origin = self._origin
        for s in spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            args = dict(s.args) if s.args else {}
            # export-time namespacing: the raw ids are process-local
            # counters; the fingerprint keeps merged traces collision-free
            args["span_id"] = self.span_uid(s.span_id)
            if s.parent_id is not None:
                args["parent_id"] = self.span_uid(s.parent_id)
            events.append({
                "name": s.name, "ph": "X", "cat": "obs",
                "ts": round((s.t0 - origin) * 1e6, 3),
                "dur": round((t1 - s.t0) * 1e6, 3),
                "pid": pid, "tid": s.tid, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write :meth:`to_chrome_trace` JSON to ``path`` (tmp + atomic
        replace, so a concurrent reader never sees a torn file). Returns
        the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path

    def export_jsonl(self, path: str) -> str:
        """One JSON object per span: name, ids, thread, wall-clock start,
        duration, args."""
        with self._lock:
            spans = list(self._spans)
            tids = dict(self._tids)
        origin, epoch = self._origin, self._origin_epoch
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            for s in spans:
                t1 = s.t1 if s.t1 is not None else s.t0
                rec = {"name": s.name, "span_id": self.span_uid(s.span_id),
                       "parent_id": self.span_uid(s.parent_id),
                       "process": self.fingerprint,
                       "thread": tids.get(s.tid, str(s.tid)),
                       "ts": epoch + (s.t0 - origin),
                       "duration_s": round(t1 - s.t0, 9)}
                if s.args:
                    rec["args"] = s.args
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# module-level routing: span() goes to the innermost activated tracer
# ---------------------------------------------------------------------------

default_tracer = Tracer()

_active = threading.local()


def _active_stack() -> List[Tracer]:
    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
    return stack


def current_tracer() -> Tracer:
    """The innermost :meth:`Tracer.activate`-d tracer on this thread, or
    :data:`default_tracer`."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else default_tracer


def span(name: str, args: Optional[Dict[str, Any]] = None,
         parent: Union[Span, int, None] = None,
         profiler_annotation: bool = False) -> _SpanCtx:
    """Record a span on the current thread's active tracer. This is the
    entry point for cross-cutting sites (checkpoint, retry, serving engine)
    that should not care which tracer is collecting."""
    return current_tracer().span(name, args, parent, profiler_annotation)
