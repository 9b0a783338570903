"""Deadline-based micro-batching for concurrent inference requests.

Per-request device dispatch wastes the accelerator: each call pays the fixed
host-side overhead (python → runtime → device and back) for a handful of rows.
The SparkNet observation (arXiv:1511.06051) is that the fix for exactly this
shape of overhead is batching work before it reaches the device — here applied
on the serving side. The :class:`MicroBatcher` coalesces requests that arrive
within a small deadline window (``max_delay_ms``) into one engine call of up
to ``max_batch`` rows, then fans the rows of the batched output back out to
per-request futures.

Backpressure is explicit: the pending-row queue is bounded, and submissions
beyond the bound raise :class:`QueueFull` immediately instead of stretching
tail latency without limit. The HTTP front maps that to a structured 503.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

if TYPE_CHECKING:  # type-only: batcher must not pull in the engines at import
    from .decode import DecodeEngine

from ..obs import spans as spans_mod
from ..utils import metrics as metrics_mod
from .kvcache import SwapPending


class QueueFull(Exception):
    """Raised by :meth:`MicroBatcher.submit` when the pending queue is at
    capacity — the caller should shed the request (HTTP 503), not wait."""


class Draining(QueueFull):
    """Raised by :meth:`MicroBatcher.submit` once :meth:`begin_drain` was
    called: queued work still completes, but no new work is admitted. The
    HTTP front maps this to ``503`` + ``Retry-After`` so a load balancer
    re-routes instead of surfacing an error."""


class _Pending:
    __slots__ = ("rows", "future", "enqueued_at", "request_id", "parent",
                 "trace_id")

    def __init__(self, rows, future, enqueued_at, request_id=None,
                 parent=None, trace_id=None):
        self.rows = rows
        self.future = future
        self.enqueued_at = enqueued_at
        self.request_id = request_id  # X-Request-Id from the HTTP front
        self.parent = parent  # submitter's open Span (cross-thread link)
        self.trace_id = trace_id  # fleet trace id (obs.TraceContext)


class MicroBatcher:
    """Thread-safe request coalescer in front of a predict engine
    (:class:`~sparkflow_tpu_torch.serving.engine.InferenceEngine`).

    Parameters
    ----------
    engine : object
        Anything with a ``predict(x) -> np.ndarray`` that maps rows to rows
        (row i of the output answers row i of the input).
    max_batch : int | None
        Rows per engine call; defaults to ``engine.max_batch``.
    max_delay_ms : float
        How long the worker waits for co-riders once a request is pending.
        0 disables coalescing delay (still batches whatever is queued).
    max_queue : int
        Bound on queued rows (excluding the batch in flight). Submissions
        that would exceed it raise :class:`QueueFull`.
    """

    def __init__(self, engine: Any, *,
                 max_batch: Optional[int] = None,
                 max_delay_ms: float = 2.0, max_queue: int = 1024,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 tracer: Optional[spans_mod.Tracer] = None):
        self.engine = engine
        self.max_batch = int(max_batch if max_batch is not None
                             else getattr(engine, "max_batch", 64))
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.max_delay_ms = float(max_delay_ms)
        self.max_queue = int(max_queue)
        self.metrics = (metrics if metrics is not None
                        else getattr(engine, "metrics", None)
                        or metrics_mod.Metrics())
        # request tracing: batch/compute spans land here, and the worker
        # activates it so engine-level span() calls nest under them
        self.tracer = (tracer if tracer is not None
                       else spans_mod.default_tracer)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Pending] = []
        self._queued_rows = 0
        self._inflight_rows = 0  # rows popped into the batch being served
        self._closed = False
        self._draining = False
        self._worker = threading.Thread(target=self._loop,
                                        name="microbatcher", daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, x, request_id: Optional[str] = None,
               parent: Optional[spans_mod.Span] = None,
               trace_id: Optional[str] = None
               ) -> "Future[np.ndarray]":
        """Queue one request (``[n, ...]`` array, or one unbatched row, or a
        tuple of arrays for multi-input engines) and return a Future that
        resolves to its rows of the batched output.

        ``request_id`` rides along for tracing; ``parent`` (the caller's
        open :class:`~sparkflow_tpu_torch.obs.Span`) parents the worker-side
        spans so the cross-thread chain stays connected. On completion the
        Future additionally carries ``.request_id`` and ``.timing`` — the
        per-request latency decomposition
        ``{queue_wait_ms, batch_assembly_ms, compute_ms, total_ms}``
        (set before the result is published, so ``result()`` returners
        always see it)."""
        rows = self._as_rows(x)
        n = rows[0].shape[0]
        if n > self.max_batch:
            raise ValueError(
                f"request of {n} rows exceeds max_batch={self.max_batch}; "
                f"split it client-side or call engine.predict directly")
        fut: "Future[np.ndarray]" = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self._draining:
                self.metrics.incr("serving/drain_rejections")
                raise Draining("MicroBatcher is draining; in-flight work "
                               "completes but new requests are refused")
            if self._queued_rows + n > self.max_queue:
                self.metrics.incr("serving/queue_rejections")
                raise QueueFull(
                    f"queue at capacity ({self._queued_rows}/{self.max_queue}"
                    f" rows); retry later")
            self._pending.append(_Pending(rows, fut, time.perf_counter(),
                                          request_id, parent, trace_id))
            self._queued_rows += n
            self.metrics.observe("serving/queue_depth_rows",
                                 self._queued_rows)
            self._cond.notify()
        return fut

    def predict(self, x, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper: ``submit(x).result(timeout)``."""
        return self.submit(x).result(timeout)

    def begin_drain(self) -> None:
        """Stop admitting work (submits raise :class:`Draining`) while the
        worker finishes everything already queued. Idempotent; pair with
        :meth:`wait_drained`, then :meth:`close`."""
        with self._cond:
            if self._closed or self._draining:
                return
            self._draining = True
            self._cond.notify_all()

    def wait_drained(self, timeout: Optional[float] = 10.0) -> bool:
        """Block until no request is queued or being served. Returns False
        if ``timeout`` expired with work still in flight."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while self._pending or self._inflight_rows:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def close(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the worker. With ``drain`` (default) queued requests are
        served first; otherwise they fail with RuntimeError."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                for p in self._pending:
                    p.future.set_exception(
                        RuntimeError("MicroBatcher closed"))
                self._pending.clear()
                self._queued_rows = 0
            self._cond.notify_all()
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def depth(self) -> int:
        """Rows currently queued (diagnostics / tests)."""
        with self._lock:
            return self._queued_rows

    def inflight_rows(self) -> int:
        """Rows in the batch currently on the device — together with
        :meth:`depth` this is the replica's load signal (``/healthz``
        exposes both for the router's least-loaded dispatch)."""
        with self._lock:
            return self._inflight_rows

    # -- worker side ---------------------------------------------------------

    def _as_rows(self, x) -> Tuple[np.ndarray, ...]:
        multi = bool(getattr(self.engine, "_multi", False))
        xs = (tuple(np.asarray(a) for a in x) if multi
              else (np.asarray(x),))
        shapes = getattr(self.engine, "_in_shapes", None)
        if shapes is not None and xs[0].ndim == len(shapes[0]):
            xs = tuple(a[None] for a in xs)  # single unbatched row
        n = xs[0].shape[0]
        if any(a.shape[0] != n for a in xs):
            raise ValueError("multi-input arrays must share the batch dim")
        if n == 0:
            raise ValueError("empty request")
        return xs

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until there is work (or close), wait out the coalescing
        deadline, then pop up to max_batch rows worth of whole requests."""
        with self._cond:
            while not self._pending and not self._closed:
                self._cond.wait()
            if not self._pending:
                return None  # closed and drained
            if self.max_delay_ms > 0 and not self._draining:
                oldest = self._pending[0].enqueued_at
                deadline = oldest + self.max_delay_ms / 1000.0
                while (self._queued_rows < self.max_batch
                       and not self._closed and not self._draining):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            batch, rows = [], 0
            while self._pending:
                n = self._pending[0].rows[0].shape[0]
                if batch and rows + n > self.max_batch:
                    break
                p = self._pending.pop(0)
                batch.append(p)
                rows += n
            self._queued_rows -= rows
            self._inflight_rows += rows
            return batch

    def _loop(self) -> None:
        # activate(): module-level span() calls made while serving (e.g. in
        # the engine) land on this batcher's tracer, nested under the
        # batch span, instead of on the process-default one
        with self.tracer.activate():
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                try:
                    self._serve(batch)
                finally:
                    with self._cond:
                        self._inflight_rows -= sum(p.rows[0].shape[0]
                                                   for p in batch)
                        self._cond.notify_all()  # wait_drained watches this

    def _serve(self, batch: List[_Pending]) -> None:
        sizes = [p.rows[0].shape[0] for p in batch]
        total = sum(sizes)
        multi = len(batch[0].rows) > 1
        tracer = self.tracer
        with tracer.span("serving/batch",
                         args={"rows": total, "requests": len(batch)}):
            try:
                with tracer.span("serving/batch_assembly"):
                    t_asm = time.perf_counter()
                    joined = tuple(
                        np.concatenate([p.rows[i] for p in batch], axis=0)
                        for i in range(len(batch[0].rows)))
                    t0 = time.perf_counter()
                with tracer.span("serving/engine_compute"):
                    out = self.engine.predict(joined if multi else joined[0])
                    t1 = time.perf_counter()
                dt = t1 - t0
            except Exception as exc:  # noqa: BLE001 - fan the failure out
                for p in batch:
                    if not p.future.cancelled():
                        p.future.set_exception(exc)
                self.metrics.incr("serving/batch_errors")
                return
        asm_ms = (t0 - t_asm) * 1000.0
        compute_ms = dt * 1000.0
        self.metrics.observe("serving/batch_rows", total)
        self.metrics.observe("serving/batch_fill_ratio",
                             total / self.max_batch)
        self.metrics.observe("serving/batch_assembly_ms", asm_ms)
        self.metrics.observe("serving/compute_ms", compute_ms)
        self.metrics.observe("serving/batch_latency_ms", dt * 1000.0)
        self.metrics.incr("serving/batches")
        self.metrics.incr("serving/requests", len(batch))
        offset = 0
        now = time.perf_counter()
        for p, n in zip(batch, sizes):
            queue_wait_ms = (t_asm - p.enqueued_at) * 1000.0
            total_ms = (now - p.enqueued_at) * 1000.0
            self.metrics.observe("serving/queue_wait_ms", queue_wait_ms)
            self.metrics.observe("serving/request_latency_ms", total_ms)
            # post-hoc span: the wait interval is only known once the batch
            # forms; parent = the submitter's request span, so the chain
            # reads request -> queue_wait even across threads
            wargs: Dict[str, Any] = {}
            if p.request_id:
                wargs["request_id"] = p.request_id
            if p.trace_id:
                wargs["trace_id"] = p.trace_id
            tracer.record("serving/queue_wait", p.enqueued_at, t_asm,
                          parent=p.parent, args=wargs or None)
            if not p.future.cancelled():
                # attach BEFORE set_result: anyone woken by result() must
                # already see the decomposition
                p.future.request_id = p.request_id
                p.future.timing = {
                    "queue_wait_ms": queue_wait_ms,
                    "batch_assembly_ms": asm_ms,
                    "compute_ms": compute_ms,
                    "total_ms": total_ms,
                }
                p.future.set_result(out[offset:offset + n])
            offset += n


class _GenPending:
    __slots__ = ("prompt", "max_new_tokens", "temperature", "top_k",
                 "eos_id", "seed", "future", "enqueued_at", "request_id",
                 "parent", "trace_id", "admitted_at", "prefill_done_at",
                 "slot", "tokens")

    def __init__(self, prompt, max_new_tokens, temperature, top_k, eos_id,
                 seed, future, enqueued_at, request_id=None, parent=None,
                 trace_id=None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.seed = seed
        self.future = future
        self.enqueued_at = enqueued_at
        self.request_id = request_id
        self.parent = parent
        self.trace_id = trace_id
        self.admitted_at = None
        self.prefill_done_at = None
        self.slot = None
        self.tokens: List[int] = []


class ContinuousBatcher:
    """Continuous (token-boundary) batching in front of a
    :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine`.

    Where :class:`MicroBatcher` coalesces at CALL boundaries — a batch forms,
    runs once, disperses — generation needs coalescing at TOKEN boundaries:
    a 2048-token completion and a 10-token one share a decode step per token,
    and the short one must leave (and its slot be refilled) the moment it
    finishes, not when the convoy does. The worker loop therefore interleaves
    three things every iteration: **admit** queued requests into free slots
    (engine prefill + reservation-based admission), **step** the whole slot
    batch one token, and **retire** sequences that hit EOS or their token
    budget — returning pages and the lane to the pool immediately.

    With ``prefill_split=True`` admission/prefill runs on its own worker so a
    long prompt's prefill never stalls the decode loop; the decode worker
    keeps stepping whatever is live and picks the new slot up next iteration.

    Backpressure and drain semantics mirror :class:`MicroBatcher` exactly —
    bounded queue raising :class:`QueueFull`, :meth:`begin_drain` /
    :meth:`wait_drained` / :meth:`close`, :meth:`depth` /
    :meth:`inflight_rows` as the ``/healthz`` load signals — so
    ``InferenceServer``/``RouterServer`` front either batcher unchanged.

    Futures resolve to ``{"tokens", "num_tokens", "finish_reason"}`` and
    carry ``.request_id`` and ``.timing``
    (``{queue_wait_ms, prefill_ms, decode_ms, total_ms, tokens}``) exactly
    like the predict path's futures.
    """

    def __init__(self, engine: "DecodeEngine", *, max_queue: int = 256,
                 prefill_split: bool = False,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 tracer: Optional[spans_mod.Tracer] = None):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.metrics = (metrics if metrics is not None
                        else getattr(engine, "metrics", None)
                        or metrics_mod.Metrics())
        self.tracer = (tracer if tracer is not None
                       else spans_mod.default_tracer)
        self.prefill_split = bool(prefill_split)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_GenPending] = []
        self._active: Dict[int, _GenPending] = {}   # slot -> request
        self._prefilling = 0   # requests popped for prefill, no slot yet
        self._closed = False
        self._draining = False
        # admission accounting: offered vs refused-at-the-door. The
        # quantized-pool benchmarks read the rejection RATE off these (a
        # roomier pool admits more of the same offered load), and capacity
        # dashboards get them without scraping the metrics registry.
        self._submitted = 0
        self._rejected = 0
        self._workers = [threading.Thread(target=self._decode_loop,
                                          name="continuous-batcher",
                                          daemon=True)]
        if self.prefill_split:
            self._workers.append(threading.Thread(
                target=self._prefill_loop, name="continuous-prefill",
                daemon=True))
        for w in self._workers:
            w.start()

    # -- client side ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None, seed: Optional[int] = None,
               request_id: Optional[str] = None,
               parent: Optional[spans_mod.Span] = None,
               trace_id: Optional[str] = None) -> "Future[Dict]":
        """Queue one generation; the Future resolves to
        ``{"tokens": [...], "num_tokens": n, "finish_reason": "eos"|"length"}``."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) > self.engine.max_prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds max_prompt_len="
                f"{self.engine.max_prompt_len}")
        if len(prompt) + max_new_tokens > self.engine.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {len(prompt) + max_new_tokens} "
                f"exceeds max_seq_len={self.engine.max_seq_len}")
        fut: "Future[Dict]" = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            self._submitted += 1
            if self._draining:
                self._rejected += 1
                self.metrics.incr("serving/drain_rejections")
                raise Draining("ContinuousBatcher is draining; in-flight "
                               "generations complete but new requests are "
                               "refused")
            if len(self._pending) >= self.max_queue:
                self._rejected += 1
                self.metrics.incr("serving/queue_rejections")
                raise QueueFull(
                    f"generate queue at capacity ({len(self._pending)}/"
                    f"{self.max_queue}); retry later")
            self._pending.append(_GenPending(
                prompt, max_new_tokens, float(temperature), int(top_k),
                eos_id, seed, fut, time.perf_counter(), request_id, parent,
                trace_id))
            self.metrics.observe("serving/decode/queue_depth",
                                 len(self._pending))
            self._cond.notify_all()
        return fut

    def generate(self, prompt: Sequence[int], timeout: Optional[float] = None,
                 **kw) -> Dict[str, Any]:
        """Blocking convenience wrapper: ``submit(...).result(timeout)``."""
        return self.submit(prompt, **kw).result(timeout)

    def begin_drain(self) -> None:
        """Stop admitting requests (submits raise :class:`Draining`); queued
        and in-flight generations still run to completion. Idempotent."""
        with self._cond:
            if self._closed or self._draining:
                return
            self._draining = True
            self._cond.notify_all()

    def wait_drained(self, timeout: Optional[float] = 10.0) -> bool:
        """Block until nothing is queued, prefilling, or decoding."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending or self._active or self._prefilling:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the workers. With ``drain`` (default) queued + in-flight
        generations finish first; otherwise they fail with RuntimeError."""
        if drain:
            self.begin_drain()
            self.wait_drained(timeout)
        failed = []
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                failed = [p.future for p in self._pending]
                self._pending.clear()
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout)
        # workers are parked; whatever is still active (drain=False, a
        # drain that timed out, or a prefill that landed mid-close) holds
        # an engine slot and KV pages — retire them, or they leak
        with self._cond:
            abandoned = list(self._active.values())
            self._active.clear()
        for p in abandoned:
            failed.append(p.future)
            self.engine.release(p.slot)
        for f in failed:
            if not f.cancelled():
                f.set_exception(RuntimeError("ContinuousBatcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def depth(self) -> int:
        """Requests queued, not yet admitted into a slot."""
        with self._lock:
            return len(self._pending)

    def inflight_rows(self) -> int:
        """Sequences currently generating (slots held + prefills in
        flight) — the replica load signal ``/healthz`` exposes."""
        with self._lock:
            return len(self._active) + self._prefilling

    def stats(self) -> Dict[str, Any]:
        """Admission accounting: offered load vs refused-at-the-door, plus
        the engine's pool layout so capacity benchmarks correlate the
        rejection rate with bytes-per-page in one read."""
        with self._lock:
            submitted, rejected = self._submitted, self._rejected
            depth = len(self._pending)
            inflight = len(self._active) + self._prefilling
        return {
            "submitted": submitted,
            "rejected": rejected,
            "rejection_rate": rejected / submitted if submitted else 0.0,
            "queue_depth": depth,
            "inflight_rows": inflight,
            "kv_quant": getattr(self.engine, "kv_quant", "bf16"),
        }

    # -- worker side ---------------------------------------------------------

    def _try_admit_locked(self) -> Optional[_GenPending]:
        """Pop the oldest admissible request, or None. Caller holds the
        lock. FIFO head-of-line only: skipping ahead would starve big
        requests behind a stream of small ones."""
        if not self._pending:
            return None
        req = self._pending[0]
        # the actual prompt tokens let prefix-cache hits shrink the demand
        if not self.engine.can_admit(len(req.prompt), req.max_new_tokens,
                                     prompt=req.prompt):
            return None
        self._pending.pop(0)
        req.admitted_at = time.perf_counter()
        self._prefilling += 1
        return req

    def _prefill_one(self, req: _GenPending) -> None:
        """Run the engine prefill for one popped request and activate its
        slot (any-thread half; state updates re-acquire the lock)."""
        aargs: Dict[str, Any] = {}
        if req.request_id:
            aargs["request_id"] = req.request_id
        if req.trace_id:
            aargs["trace_id"] = req.trace_id
        try:
            with self.tracer.span("serving/decode_admit",
                                  args=aargs or None,
                                  parent=req.parent):
                info = self.engine.prefill(
                    req.prompt, max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    seed=req.seed)
        except Exception as exc:  # noqa: BLE001 - fan to the caller
            requeue = isinstance(exc, SwapPending)
            with self._cond:
                self._prefilling -= 1
                if requeue:
                    # a swap staged after can_admit: backpressure, not
                    # failure; the request waits at the head of the queue
                    # until the swap lands at the drained boundary
                    self._pending.insert(0, req)
                self._cond.notify_all()
            if not requeue and not req.future.cancelled():
                req.future.set_exception(exc)
            return
        req.slot = info["slot"]
        tok = info.get("token")
        if tok is None:
            # chunked prefill: the suffix advances inside the decode loop's
            # fused steps; the first token arrives via step() like any other
            # (prefill_done_at is stamped when it does)
            self.metrics.incr("serving/decode/admitted")
            with self._cond:
                self._prefilling -= 1
                self._active[req.slot] = req
                self._cond.notify_all()
            return
        req.prefill_done_at = time.perf_counter()
        req.tokens.append(tok)
        self.metrics.incr("serving/decode/admitted")
        with self._cond:
            self._prefilling -= 1
            self._active[req.slot] = req
            self._cond.notify_all()

    def _finish(self, req: _GenPending, reason: str) -> None:
        self.engine.release(req.slot)
        now = time.perf_counter()
        # decomposition: enqueued -> admitted (queue wait) -> first token
        # (prefill/TTFT) -> finish (decode). Each leg measures only its own
        # span, whatever mix of chunked prefill and multi-token speculative
        # bursts produced the tokens.
        admitted = req.admitted_at or req.enqueued_at
        queue_wait_ms = (admitted - req.enqueued_at) * 1000.0
        prefill_ms = 0.0
        if req.prefill_done_at is not None:
            prefill_ms = (req.prefill_done_at - admitted) * 1000.0
        decode_ms = (now - (req.prefill_done_at or admitted)) * 1000.0
        total_ms = (now - req.enqueued_at) * 1000.0
        ntok = len(req.tokens)
        self.metrics.observe("serving/decode/request_latency_ms", total_ms)
        self.metrics.observe("serving/decode/tokens_per_request", ntok)
        self.metrics.incr("serving/decode/completed")
        gargs: Dict[str, Any] = {"tokens": ntok}
        if req.request_id:
            gargs["request_id"] = req.request_id
        if req.trace_id:
            gargs["trace_id"] = req.trace_id
        self.tracer.record("serving/decode_generate", req.enqueued_at, now,
                           parent=req.parent, args=gargs)
        if not req.future.cancelled():
            req.future.request_id = req.request_id
            req.future.timing = {
                "queue_wait_ms": queue_wait_ms,
                "prefill_ms": prefill_ms,
                "decode_ms": decode_ms,
                "total_ms": total_ms,
                "tokens": ntok,
            }
            req.future.set_result({"tokens": list(req.tokens),
                                   "num_tokens": ntok,
                                   "finish_reason": reason})

    def _step_active(self) -> None:
        """One decode iteration + retirement. The engine call runs outside
        the batcher lock (it has its own); retirement updates re-acquire."""
        t_tick0 = time.perf_counter()
        produced = self.engine.step()
        t_tick1 = time.perf_counter()
        finished = []
        ticked = []  # (req, tokens) for per-tick spans, recorded post-lock
        with self._cond:
            for slot, burst in produced.items():
                req = self._active.get(slot)
                if req is None:
                    continue
                if req.trace_id:
                    # per-tick decode attribution, only for requests that
                    # carry a fleet trace id (untraced load stays span-free
                    # on the hot path)
                    ticked.append((req, len(burst)))
                if req.prefill_done_at is None:
                    # chunked request's first token: TTFT stamps here
                    req.prefill_done_at = time.perf_counter()
                # a speculative step can commit 0..k+1 tokens per slot:
                # consume the burst in order and retire mid-burst on eos or
                # budget, discarding the remainder (the engine's extra KV
                # past the retired length dies with release())
                for tok in burst:
                    req.tokens.append(tok)
                    if req.eos_id is not None and tok == req.eos_id:
                        finished.append((req, "eos"))
                        del self._active[slot]
                        break
                    if len(req.tokens) >= req.max_new_tokens:
                        finished.append((req, "length"))
                        del self._active[slot]
                        break
            if finished:
                self._cond.notify_all()  # wait_drained watches _active
        for req, ntok in ticked:
            self.tracer.record("serving/decode_tick", t_tick0, t_tick1,
                               parent=req.parent,
                               args={"trace_id": req.trace_id,
                                     "slot": req.slot, "tokens": ntok})
        for req, reason in finished:
            self._finish(req, reason)

    def _decode_loop(self) -> None:
        with self.tracer.activate():
            while True:
                admitted = False
                if not self.prefill_split:
                    # inline admission: fill every free slot before stepping
                    while True:
                        with self._cond:
                            if self._closed:
                                return
                            req = self._try_admit_locked()
                        if req is None:
                            break
                        self._prefill_one(req)
                        admitted = True
                with self._cond:
                    if self._closed:
                        return
                    if not self._active and not admitted:
                        # idle (or head-of-line request doesn't fit yet):
                        # sleep until a submit / prefill / retire notifies.
                        # Bounded wait while work is queued or prefilling so
                        # admission capacity is re-checked promptly.
                        self._cond.wait(0.05 if (self._pending
                                                 or self._prefilling)
                                        else None)
                        continue
                    have_active = bool(self._active)
                if have_active:
                    self._step_active()

    def _prefill_loop(self) -> None:
        while True:
            with self._cond:
                req = None
                while not self._closed:
                    req = self._try_admit_locked()
                    if req is not None:
                        break
                    self._cond.wait(0.05 if self._pending else None)
                if req is None:  # closed with nothing admitted
                    return
            # an admission that raced close() still runs its prefill; the
            # slot it activates is retired by close()'s abandoned sweep
            self._prefill_one(req)
