"""Stdlib JSON-over-HTTP front for the inference engine.

Mirrors the reference's choice of a driver-hosted HTTP process for its
parameter server (``sparkflow/HogwildSparkModel.py:156-166``) but on the
serving side, and — like the rest of this repo — without taking a web
framework dependency: ``http.server.ThreadingHTTPServer`` is enough for a
JSON request/response front, and every handler thread funnels into the one
:class:`~sparkflow_tpu_torch.serving.batcher.MicroBatcher`, which is the point —
concurrency arrives at the device as micro-batches, not as per-request calls.

Endpoints
---------
``POST /v1/predict``
    Body ``{"inputs": [[...], ...]}`` (row-major nested lists; a dict of
    ``{input_name: rows}`` for multi-input engines). Returns
    ``{"predictions": [...], "rows": n}``. Overload returns a structured
    ``503 {"error": {"code": "queue_full", ...}}``.
``POST /v1/generate``
    Autoregressive decode (requires a ``generate_batcher`` — a
    :class:`~sparkflow_tpu_torch.serving.batcher.ContinuousBatcher` over a
    :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine`). Body
    ``{"prompt": [token ids], "max_new_tokens": 32, "temperature": 0.0,
    "top_k": 0, "eos_id": null, "seed": null}``. Returns
    ``{"tokens": [...], "num_tokens": n, "finish_reason": "eos"|"length"}``
    plus ``request_id`` and ``timing_ms``. Same backpressure contract as
    predict: structured 503 + ``Retry-After`` on queue-full or drain.
``GET /healthz``
    Liveness + engine stats (buckets, compile counts, request totals) and
    the lifecycle state; flips to ``503`` once the server is draining so
    load balancers eject the replica before its socket goes away.
``GET /metrics``
    Full ``utils.metrics`` summary: counters, gauges, scalar series, and the
    serving histograms (queue depth, batch fill ratio, padding waste, latency
    p50/p95/p99). ``GET /metrics?format=prometheus`` returns the same
    registry in Prometheus text exposition format (``obs.exporters``) for a
    stock scrape_config; JSON stays the default.

Request tracing
---------------
Every ``POST /v1/predict`` gets an ``X-Request-Id`` (the client's, or a
fresh one), threaded through the micro-batcher and echoed in the response
headers and body together with a per-request latency decomposition
(``timing_ms``: queue wait vs batch assembly vs compute). The same id
labels the request's spans on the server's tracer.
"""

from __future__ import annotations

import json
import logging
import os
import signal as signal_mod
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from ..obs import spans as spans_mod
from ..obs.collector import trace_spans
from ..obs.exporters import MemoryWatcher, prometheus_text
from ..obs.flight import FlightRecorder
from ..resilience.lifecycle import Lifecycle, ServerState
from .batcher import ContinuousBatcher, Draining, MicroBatcher, QueueFull

logger = logging.getLogger("sparkflow_tpu_torch")


class InferenceServer:
    """Own an engine + micro-batcher and serve them over HTTP.

    ``InferenceServer(engine, port=0)`` binds an ephemeral port (read it back
    from ``server.port`` after :meth:`start` — tests depend on this). The
    server runs on daemon threads; use as a context manager or call
    :meth:`stop`.

    Lifecycle (``resilience.lifecycle``): ``STARTING -> SERVING`` on
    :meth:`start`; :meth:`drain` (or a SIGTERM via
    :meth:`install_signal_handlers`) moves to ``DRAINING`` — in-flight
    requests finish, new ones get ``503`` + ``Retry-After`` — and
    :meth:`stop` drains first, then tears the socket down (``STOPPED``).
    """

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 batcher: Optional[MicroBatcher] = None,
                 generate_batcher: Optional[ContinuousBatcher] = None,
                 max_delay_ms: float = 2.0, max_queue: int = 1024,
                 request_timeout_s: float = 30.0,
                 drain_timeout_s: float = 10.0,
                 retry_after_s: float = 1.0,
                 tracer: Optional[spans_mod.Tracer] = None,
                 memory_watch: bool = True,
                 memory_interval_s: float = 5.0,
                 weight_watcher=None,
                 flight_dir: Optional[str] = None):
        self.engine = engine
        # optional live-weight subscription (serving.weightstore): started/
        # stopped with the server; /healthz carries its serving_version so
        # routers can canary by version
        self.weight_watcher = weight_watcher
        self.tracer = (tracer if tracer is not None
                       else spans_mod.default_tracer)
        self.batcher = batcher if batcher is not None else MicroBatcher(
            engine, max_delay_ms=max_delay_ms, max_queue=max_queue,
            tracer=self.tracer)
        # optional decode front: a ContinuousBatcher over a DecodeEngine
        # enables POST /v1/generate (absent -> that route 404s)
        self.generate_batcher = generate_batcher
        self.metrics = self.batcher.metrics
        self.request_timeout_s = float(request_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.retry_after_s = float(retry_after_s)
        # memory_watch: background mem/* gauges (per-device bytes_in_use /
        # peak / limit) so a scrape sees how close the replica is to OOM;
        # a no-op on backends whose allocator reports no stats (CPU)
        self.memory_watcher = (MemoryWatcher(metrics=self.metrics,
                                             interval_s=memory_interval_s)
                               if memory_watch else None)
        self.lifecycle = Lifecycle()
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        # flight recorder: always-on crash evidence, keyed by port so the
        # ReplicaManager can harvest <flight_dir>/replica-<port>.jsonl after
        # reaping this process (see obs.flight)
        self.flight: Optional[FlightRecorder] = None
        if flight_dir:
            self.flight = FlightRecorder(
                os.path.join(flight_dir, f"replica-{self.port}.jsonl"),
                tracer=self.tracer, metrics=self.metrics)
        self._thread: Optional[threading.Thread] = None
        self._prev_handlers: Dict[int, Any] = {}

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "InferenceServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="inference-server", daemon=True)
        self._thread.start()
        if self.flight is not None:
            # atexit-only arming: the SIGTERM dump rides the drain handler
            # (install_signal_handlers), avoiding a second handler chain
            self.flight.install(signals=())
        if self.memory_watcher is not None:
            self.memory_watcher.start()
        if self.weight_watcher is not None:
            self.weight_watcher.start()
        self.lifecycle.transition(ServerState.SERVING)
        return self

    # -- lifecycle -----------------------------------------------------------

    def install_signal_handlers(self,
                                signals=(signal_mod.SIGTERM,)) -> bool:
        """Arm graceful drain on SIGTERM (preemption notice): the handler
        kicks :meth:`drain` off on a background thread and returns, so the
        grace window is spent finishing in-flight work, not blocking the
        handler. Main-thread only (CPython signal routing); returns whether
        handlers were installed. :meth:`stop` restores the previous
        handlers."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def on_signal(signum, frame):
            if self.flight is not None:
                # the last word goes to disk BEFORE the drain starts: if the
                # grace window is cut short by SIGKILL, the dump already
                # names what was in flight
                self.flight.dump(reason=f"signal:{signum}")
            logger.warning("signal %d received: draining the inference "
                           "server", signum)
            threading.Thread(target=self.drain, name="serving-drain",
                             daemon=True).start()

        for s in signals:
            self._prev_handlers[s] = signal_mod.signal(s, on_signal)
        return True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admitting requests (503 + ``Retry-After``),
        finish everything in flight, leave the socket up so health checks
        can observe the draining state. Idempotent. Returns True when the
        server went fully idle inside ``timeout`` (default
        ``drain_timeout_s``)."""
        timeout = self.drain_timeout_s if timeout is None else timeout
        self.lifecycle.transition(ServerState.DRAINING)
        self.batcher.begin_drain()
        if self.generate_batcher is not None:
            self.generate_batcher.begin_drain()
        idle = self.lifecycle.wait_idle(timeout)
        drained = self.batcher.wait_drained(timeout)
        if self.generate_batcher is not None:
            drained = self.generate_batcher.wait_drained(timeout) and drained
        if not (idle and drained):
            logger.warning(
                "drain timed out after %.1fs with work still in flight "
                "(inflight_http=%d)", timeout, self.lifecycle.inflight)
        return idle and drained

    def stop(self) -> None:
        if self._thread is None:
            return
        if self.weight_watcher is not None:
            self.weight_watcher.stop()  # no swaps mid-teardown
        self.drain()
        if self.memory_watcher is not None:
            self.memory_watcher.stop()
        self._httpd.shutdown()
        self._thread.join(timeout=10.0)
        self._httpd.server_close()
        self._thread = None
        self.batcher.close()
        if self.generate_batcher is not None:
            self.generate_batcher.close()
        if self.flight is not None:
            self.flight.dump(reason="stop")
            self.flight.close()
        self.lifecycle.transition(ServerState.STOPPED)
        if (self._prev_handlers
                and threading.current_thread() is threading.main_thread()):
            for s, prev in self._prev_handlers.items():
                signal_mod.signal(s, prev)
            self._prev_handlers.clear()

    def kill(self) -> None:
        """Ungraceful stop — the chaos path. Tears the listening socket down
        NOW: in-flight requests see connection resets, queued batcher work is
        abandoned with an error. This is what a SIGKILL'd replica looks like
        to its clients; the fleet tests use it to prove the router reroutes
        around a corpse (for the graceful path, use :meth:`drain`/:meth:`stop`)."""
        if self._thread is None:
            return
        if self.weight_watcher is not None:
            self.weight_watcher.stop()
        if self.memory_watcher is not None:
            self.memory_watcher.stop()
        self._httpd.shutdown()
        self._thread.join(timeout=10.0)
        self._httpd.server_close()
        self._thread = None
        self.batcher.close(drain=False, timeout=1.0)
        if self.generate_batcher is not None:
            self.generate_batcher.close(drain=False, timeout=1.0)
        if self.flight is not None:
            # the chaos path leaves the file UNdumped on purpose: a killed
            # process writes nothing either, and the harvest must still name
            # the in-flight traces from begin/end lines alone
            self.flight.close()
        self.lifecycle.transition(ServerState.STOPPED)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request handling ----------------------------------------------------

    def _parse_inputs(self, payload: Dict[str, Any]):
        inputs = payload.get("inputs", payload.get("instances"))
        if inputs is None:
            raise ValueError('body must carry "inputs" (or "instances")')
        if getattr(self.engine, "_multi", False):
            keys = list(getattr(self.engine, "_in_keys"))
            if not isinstance(inputs, dict):
                raise ValueError(
                    f'multi-input engine: "inputs" must be an object mapping '
                    f'input names {keys} to row lists')
            missing = [k for k in keys if k not in inputs]
            if missing:
                raise ValueError(f"missing inputs: {missing}")
            return tuple(np.asarray(inputs[k]) for k in keys)
        if isinstance(inputs, dict):
            raise ValueError('single-input engine: "inputs" must be a list '
                             "of rows, not an object")
        return np.asarray(inputs)

    def _span_args(self, request_id: str,
                   ctx: Optional[spans_mod.TraceContext]) -> Dict[str, Any]:
        """Root-span args for one request: the trace id seeds
        ``obs.collector.trace_spans`` extraction, and ``parent_uid`` is the
        cross-process link — the router attempt span this process's
        fragment hangs under in the assembled waterfall."""
        args: Dict[str, Any] = {"request_id": request_id}
        if ctx is not None:
            args["trace_id"] = ctx.trace_id
            if ctx.parent:
                args["parent_uid"] = ctx.parent
        return args

    def _predict(self, body: bytes, request_id: str,
                 ctx: Optional[spans_mod.TraceContext] = None) -> Tuple:
        # always (status, body, headers); the request id is echoed on every
        # outcome so a client/log line can be joined to server-side spans
        rid = {"X-Request-Id": request_id}
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            x = self._parse_inputs(payload)
        except (ValueError, TypeError) as exc:
            self.metrics.incr("serving/http_400")
            return 400, {"error": {"code": "bad_request",
                                   "message": str(exc)}}, rid
        fut = None
        try:
            with self.tracer.span("serving/request",
                                  args=self._span_args(request_id,
                                                       ctx)) as sp:
                fut = self.batcher.submit(
                    x, request_id=request_id, parent=sp,
                    trace_id=ctx.trace_id if ctx is not None else None)
                out = fut.result(timeout=self.request_timeout_s)
        except Draining as exc:
            # the drain began after this request was admitted; shed it the
            # same way un-admitted ones are shed
            self.metrics.incr("serving/http_503")
            return 503, {"error": {"code": "draining",
                                   "message": str(exc)}}, \
                {**self._retry_after(), **rid}
        except QueueFull as exc:
            self.metrics.incr("serving/http_503")
            return 503, {"error": {"code": "queue_full",
                                   "message": str(exc)}}, \
                {**self._retry_after(), **rid}
        except ValueError as exc:
            self.metrics.incr("serving/http_400")
            return 400, {"error": {"code": "bad_request",
                                   "message": str(exc)}}, rid
        except Exception as exc:  # noqa: BLE001 - surface, don't hang
            self.metrics.incr("serving/http_500")
            return 500, {"error": {"code": "internal",
                                   "message": f"{type(exc).__name__}: "
                                              f"{exc}"}}, rid
        self.metrics.incr("serving/http_200")
        resp: Dict[str, Any] = {"predictions": np.asarray(out).tolist(),
                                "rows": int(np.asarray(out).shape[0]),
                                "request_id": request_id}
        timing = getattr(fut, "timing", None)
        if timing is not None:
            resp["timing_ms"] = {k: round(v, 3) for k, v in timing.items()}
        return 200, resp, rid

    def _generate(self, body: bytes, request_id: str,
                  ctx: Optional[spans_mod.TraceContext] = None) -> Tuple:
        rid = {"X-Request-Id": request_id}
        if self.generate_batcher is None:
            self.metrics.incr("serving/http_404")
            return 404, {"error": {
                "code": "not_found",
                "message": "generation is not enabled on this server "
                           "(no generate_batcher)"}}, rid
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            prompt = payload.get("prompt")
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError('"prompt" must be a non-empty list of '
                                 "integer token ids")
            max_new = int(payload.get("max_new_tokens", 32))
            temperature = float(payload.get("temperature", 0.0))
            top_k = int(payload.get("top_k", 0))
            eos_id = payload.get("eos_id")
            eos_id = int(eos_id) if eos_id is not None else None
            seed = payload.get("seed")
            seed = int(seed) if seed is not None else None
        except (ValueError, TypeError) as exc:
            self.metrics.incr("serving/http_400")
            return 400, {"error": {"code": "bad_request",
                                   "message": str(exc)}}, rid
        fut = None
        try:
            with self.tracer.span("serving/request",
                                  args=self._span_args(request_id,
                                                       ctx)) as sp:
                fut = self.generate_batcher.submit(
                    prompt, max_new_tokens=max_new, temperature=temperature,
                    top_k=top_k, eos_id=eos_id, seed=seed,
                    request_id=request_id, parent=sp,
                    trace_id=ctx.trace_id if ctx is not None else None)
                out = fut.result(timeout=self.request_timeout_s)
        except Draining as exc:
            self.metrics.incr("serving/http_503")
            return 503, {"error": {"code": "draining",
                                   "message": str(exc)}}, \
                {**self._retry_after(), **rid}
        except QueueFull as exc:
            self.metrics.incr("serving/http_503")
            return 503, {"error": {"code": "queue_full",
                                   "message": str(exc)}}, \
                {**self._retry_after(), **rid}
        except ValueError as exc:
            self.metrics.incr("serving/http_400")
            return 400, {"error": {"code": "bad_request",
                                   "message": str(exc)}}, rid
        except Exception as exc:  # noqa: BLE001 - surface, don't hang
            self.metrics.incr("serving/http_500")
            return 500, {"error": {"code": "internal",
                                   "message": f"{type(exc).__name__}: "
                                              f"{exc}"}}, rid
        self.metrics.incr("serving/http_200")
        resp: Dict[str, Any] = dict(out)
        resp["request_id"] = request_id
        timing = getattr(fut, "timing", None)
        if timing is not None:
            resp["timing_ms"] = {k: round(v, 3) for k, v in timing.items()}
        return 200, resp, rid

    def _retry_after(self) -> Dict[str, str]:
        return {"Retry-After": str(max(1, int(round(self.retry_after_s))))}

    def _serving_version(self) -> int:
        """Version of the weights this replica serves (0 = ctor weights, or
        an engine without the hot-swap surface)."""
        eng = (self.generate_batcher.engine
               if self.generate_batcher is not None else self.engine)
        sv = getattr(eng, "serving_version", None)
        return int(sv()) if callable(sv) else 0

    def _healthz(self) -> Tuple[int, Dict[str, Any], Optional[Dict[str, str]]]:
        stats = (self.engine.stats()
                 if hasattr(self.engine, "stats") else {})
        state = self.lifecycle.state
        # queue_depth / in_flight: the health probe doubles as the router's
        # load signal (least-loaded dispatch reads these — no second
        # endpoint). inflight/queued_rows stay for older scrapers.
        queue_depth = self.batcher.depth()
        in_flight = self.lifecycle.inflight + self.batcher.inflight_rows()
        if self.generate_batcher is not None:
            queue_depth += self.generate_batcher.depth()
            in_flight += self.generate_batcher.inflight_rows()
        body = {"status": ("ok" if state in (ServerState.SERVING,
                                             ServerState.STARTING)
                           else state.value),
                "state": state.value,
                "inflight": self.lifecycle.inflight,
                "queued_rows": queue_depth,
                "queue_depth": queue_depth,
                "in_flight": in_flight,
                # serving_version: harvested by Membership probes so the
                # router can do version-aware (canary) dispatch
                "serving_version": self._serving_version(),
                # trace advertisement: the membership prober harvests this so
                # the router knows each replica's tracer fingerprint (process
                # lane in merged waterfalls) and where its flight record is
                "trace": {
                    "process": self.tracer.fingerprint,
                    "flight": (self.flight.path
                               if self.flight is not None else None)},
                "engine": stats}
        if self.weight_watcher is not None:
            body["weights"] = self.weight_watcher.stats()
        if self.generate_batcher is not None:
            gb = self.generate_batcher
            gstats = (gb.engine.stats()
                      if hasattr(gb.engine, "stats") else {})
            kv = gstats.get("kv", {}) if isinstance(gstats, dict) else {}
            par = (gstats.get("parallel", {})
                   if isinstance(gstats, dict) else {})
            body["decode"] = {
                "queue_depth": gb.depth(),
                "in_flight": gb.inflight_rows(),
                # KV headroom: the router places /v1/generate traffic by
                # these, not queue depth — a page-starved replica would 503
                # new generations no matter how short its queue looks
                "free_slots": (int(kv.get("num_slots", 0))
                               - int(kv.get("slots_active", 0))),
                "pages_free": int(kv.get("pages_free", 0)),
                # quantized-pool layout: replicas with different pool
                # dtypes report different effective capacity per page, so
                # routers compare BYTE headroom (pages_free x
                # kv_bytes_per_page), not raw page counts
                "kv_dtype": kv.get("kv_dtype", "bf16"),
                "kv_bytes_per_page": int(kv.get("kv_bytes_per_page") or 0),
                # model-parallel layout: membership/routers export these as
                # per-replica gauges, and capacity math (pages_free is
                # per-REPLICA, not per-device) needs the degree
                "mesh_shape": par.get("mesh"),
                "tp": int(par.get("tp", 1) or 1),
                "ep": int(par.get("ep", 1) or 1),
                "pp": int(par.get("pp", 1) or 1),
                "stages": int(par.get("stages", 1) or 1),
                "engine": gstats,
            }
            spec = gstats.get("spec", {}) if isinstance(gstats, dict) else {}
            if spec.get("enabled"):
                # speculative health: routers/membership can prefer replicas
                # whose drafts are actually being accepted
                body["decode"]["spec_accept_rate"] = float(
                    spec.get("accept_rate", 0.0))
                body["decode"]["spec_mean_accepted"] = float(
                    spec.get("mean_accepted", 0.0))
        if state in (ServerState.SERVING, ServerState.STARTING):
            return 200, body, None
        # draining/stopped: flip readiness so the load balancer ejects this
        # replica before its socket goes away
        return 503, body, self._retry_after()

    def _metrics(self) -> Tuple[int, Dict[str, Any]]:
        self.metrics.gauge("serving/version", float(self._serving_version()))
        return 200, self.metrics.summary()

    def _metrics_prometheus(self) -> Tuple[int, str]:
        self.metrics.gauge("serving/version", float(self._serving_version()))
        return 200, prometheus_text(self.metrics)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, status: int, obj: Dict[str, Any],
                       headers: Optional[Dict[str, str]] = None) -> None:
                data = json.dumps(obj).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                # a draining/stopped server must shed its keep-alive
                # connections too: otherwise pooled clients (the router's
                # prober) would keep talking to this dying process instead
                # of re-dialing — and reaching its restarted successor
                if server.lifecycle.state not in (ServerState.SERVING,
                                                  ServerState.STARTING):
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(data)

            def _reply_text(self, status: int, text: str,
                            content_type: str) -> None:
                data = text.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    self._reply(*server._healthz())
                elif path == "/metrics":
                    fmt = parse_qs(query).get("format", ["json"])[0]
                    if fmt == "prometheus":
                        status, text = server._metrics_prometheus()
                        # the version suffix is part of the exposition
                        # contract prometheus scrapers negotiate on
                        self._reply_text(
                            status, text,
                            "text/plain; version=0.0.4; charset=utf-8")
                    else:
                        self._reply(*server._metrics())
                elif path.startswith("/traces/"):
                    # per-replica trace fragment: every span of this trace
                    # still in the tracer ring, normalized (fingerprinted
                    # ids, wall-clock ts) for router-side assembly
                    tid = path[len("/traces/"):]
                    self._reply(200, {
                        "trace_id": tid,
                        "process": server.tracer.fingerprint,
                        "spans": trace_spans(server.tracer, tid)})
                else:
                    self._reply(404, {"error": {"code": "not_found",
                                                "message": self.path}})

            def do_POST(self):  # noqa: N802
                if self.path == "/v1/predict":
                    handle = server._predict
                elif self.path == "/v1/generate":
                    handle = server._generate
                else:
                    self._reply(404, {"error": {"code": "not_found",
                                                "message": self.path}})
                    return
                # propagate the caller's correlation id, or mint one —
                # either way every response carries X-Request-Id
                request_id = (self.headers.get("X-Request-Id")
                              or uuid.uuid4().hex)
                # fleet trace context rides the traceparent header (minted
                # at the router; absent for direct single-replica clients)
                ctx = spans_mod.TraceContext.parse(
                    self.headers.get(spans_mod.TRACEPARENT_HEADER))
                # admission control: a draining/stopped server sheds the
                # request BEFORE reading work into the batcher, with a
                # Retry-After hint for the balancer's re-dispatch
                if not server.lifecycle.try_begin_request():
                    server.metrics.incr("serving/http_503")
                    self._reply(503, {"error": {
                        "code": "draining",
                        "message": "server is draining; retry on another "
                                   "replica"}},
                        {**server._retry_after(),
                         "X-Request-Id": request_id})
                    return
                if server.flight is not None and ctx is not None:
                    server.flight.begin(ctx.trace_id, request_id)
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    self._reply(*handle(body, request_id, ctx))
                finally:
                    if server.flight is not None and ctx is not None:
                        server.flight.end(ctx.trace_id)
                    server.lifecycle.end_request()

            def log_message(self, fmt, *args):  # quiet: metrics cover this
                pass

        return Handler
