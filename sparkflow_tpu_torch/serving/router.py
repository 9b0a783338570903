"""Fleet-scale serving: a health-gated router over N inference replicas —
carried unchanged from the JAX package's ``serving/router.py``.

One :class:`~sparkflow_tpu_torch.serving.server.InferenceServer` dies with one
SIGKILL — the reference's single parameter-server process has the same
shape of problem (``sparkflow/HogwildSparkModel.py:156-166``). The
:class:`RouterServer` makes serving survive that: it fronts N replicas with

- **health-gated membership** (:mod:`~sparkflow_tpu_torch.serving.membership`):
  periodic ``/healthz`` probes plus a per-replica circuit breaker
  (consecutive-failure ejection, half-open recovery), and immediate ejection
  on a ``Draining`` 503 (a replica that caught SIGTERM);
- **least-loaded dispatch** over live router-side in-flight counters,
  tie-broken by the replica-reported queue depth the health probe carries;
- **admission control**: a token bucket (``admission_rate``/``burst``) and a
  router-wide in-flight cap, both shedding onto the same structured
  ``503 queue_full`` + ``Retry-After`` path replicas already use — clients
  that retry 503s need no new logic;
- **retry + reroute**: a failed dispatch (connection error, 5xx, overload)
  backs off via :class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy` and
  reroutes to the next healthy replica, so a mid-burst replica kill is a
  retry, not a client-visible failure;
- **hedged requests** (opt-in): when the primary hasn't answered within a
  p95-derived delay, a duplicate goes to a second replica; first success
  wins and the loser is cancelled (its connection is closed, unblocking the
  worker) — the classic tail-latency lever;
- **content-addressed result cache** (opt-in): an input-hash LRU over
  successful responses with hit/miss counters.

Observability: ``X-Request-Id`` is minted (or propagated) at the router and
threaded through to the replica, so one id joins client log, router spans
(``router/request`` → ``router/dispatch``), and replica spans. ``GET
/metrics?format=prometheus`` exposes router counters/histograms plus
per-replica gauges (``router/replica<i>/{healthy,ejected,inflight,
error_rate,hedges}``). Chaos: :func:`resilience.faults.fire` points
``router.dispatch`` (admission side) and ``replica.predict`` (every
forwarding attempt) make the whole fleet path fault-injectable.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import random
import threading
import time
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs

from ..obs import spans as spans_mod
from ..obs.collector import TraceCollector
from ..obs.exporters import prometheus_text
from ..resilience import faults
from ..resilience.lifecycle import Lifecycle, ServerState
from ..resilience.retry import RetryPolicy
from ..utils import metrics as metrics_mod
from . import policies
from .client import _STALE_CONN_ERRORS
from .membership import Membership, Replica
from .policies import VersionStats

__all__ = ["RouterServer", "TokenBucket", "ResultCache", "CanaryController"]

logger = logging.getLogger("sparkflow_tpu_torch")


class TokenBucket:
    """Token-bucket admission: ``rate`` tokens/s refill up to ``burst``.
    ``try_acquire`` never blocks — admission control sheds, it does not
    queue. ``clock`` is injectable for deterministic tests."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=time.monotonic):
        if rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self.clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def try_acquire(self, n: float = 1.0) -> bool:
        # the refill/spend arithmetic is the pure policy; this shell owns
        # the lock and the clock read (policies never touch wall time)
        with self._lock:
            ok, self._tokens, self._last = policies.token_bucket_admit(
                self._tokens, self._last, self.clock(),
                rate=self.rate, burst=self.burst, n=n)
            return ok


class ResultCache:
    """Content-addressed LRU over successful predict responses.

    Keyed by the hash of the request body (same inputs → same bytes from
    the same client serialization), valid because the engine is a pure
    function of its inputs. ``hits``/``misses`` counters are maintained
    under the cache's own lock.
    """

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(body: bytes) -> str:
        return hashlib.sha256(body).hexdigest()

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return dict(value)

    def put(self, key: str, value: Dict[str, Any]) -> None:
        with self._lock:
            self._entries[key] = dict(value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses}


def _response_has_nan(obj: Dict[str, Any], cap: int = 4096) -> bool:
    """Scan a predict response's ``predictions`` for NaN/Inf (the canary
    gate's numerical-health signal), visiting at most ``cap`` scalars."""
    seen = 0
    stack = [obj.get("predictions")]
    while stack and seen < cap:
        v = stack.pop()
        if isinstance(v, list):
            stack.extend(v)
        elif isinstance(v, float):
            seen += 1
            if math.isnan(v) or math.isinf(v):
                return True
    return False


class CanaryController:
    """Health-gated canary rollout over live-weight versions.

    Plugs into :class:`~sparkflow_tpu_torch.serving.membership.Membership` as its
    ``version_policy`` and is fed every dispatch outcome by the router. The
    fleet's versions split into three roles: the **incumbent** (first
    version seen), a **canary** (any strictly newer version that appears as
    replicas hot-swap), and **quarantined** versions (failed canaries).
    While a canary is under trial, roughly ``canary_fraction`` of picks
    prefer canary replicas — weighted version-aware dispatch — and its
    outcomes accumulate per-version. The gate then decides:

    - any NaN/Inf in a canary response → **instant rollback**;
    - after ``min_requests``: error rate above the incumbent's by more than
      ``error_rate_margin``, or latency p95 above
      ``max(latency_floor_ms, latency_factor x incumbent p95)`` →
      **rollback**; otherwise → **promote** (the canary becomes incumbent).

    Rollback quarantines the version — the picker excludes its replicas, so
    a bad publish takes ZERO post-gate traffic — and, when a ``store``
    (:class:`~sparkflow_tpu_torch.serving.weightstore.WeightStore`) is wired,
    repoints it at the last good version so every watcher reverts too.

    Lock order: ``CanaryController._lock`` is a leaf — taken after
    ``Membership._lock`` releases (the picker calls :meth:`filter_replicas`
    outside it) and never held across store or network calls.
    """

    MAX_LAT_SAMPLES = 512  # per-version latency ring for the p95 gate

    def __init__(self, *, min_requests: int = 20,
                 canary_fraction: float = 0.25,
                 error_rate_margin: float = 0.05,
                 latency_factor: float = 2.0,
                 latency_floor_ms: float = 5.0,
                 store=None,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 seed: int = 0):
        if not 0.0 < canary_fraction < 1.0:
            raise ValueError(f"canary_fraction must be in (0, 1), got "
                             f"{canary_fraction}")
        if min_requests < 1:
            raise ValueError(f"min_requests must be >= 1, got {min_requests}")
        self.min_requests = int(min_requests)
        self.canary_fraction = float(canary_fraction)
        self.error_rate_margin = float(error_rate_margin)
        self.latency_factor = float(latency_factor)
        self.latency_floor_ms = float(latency_floor_ms)
        self.store = store
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._stats: Dict[int, Dict[str, Any]] = {}
        self.incumbent: Optional[int] = None
        self.canary: Optional[int] = None
        self.quarantined: set = set()
        self.promotions = 0
        self.rollbacks = 0

    # -- roles ---------------------------------------------------------------

    def _note_version_locked(self, version: int) -> None:
        if version < 0 or version in self.quarantined:
            return
        if self.incumbent is None:
            self.incumbent = version
            return
        base = self.incumbent if self.canary is None else self.canary
        if version > base:
            # the newest version in the fleet is the canary under trial
            self.canary = version

    def _stats_for_locked(self, version: int) -> Dict[str, Any]:
        st = self._stats.get(version)
        if st is None:
            st = self._stats[version] = {"requests": 0, "errors": 0,
                                         "nans": 0, "lat": []}
        return st

    @staticmethod
    def _p95(lat: List[float]) -> float:
        return policies.percentile_nearest_rank(lat, 95.0)

    # -- the gate ------------------------------------------------------------

    def observe(self, version: Optional[int], ok: bool,
                latency_ms: Optional[float] = None,
                nan: bool = False) -> None:
        """Record one dispatch outcome against the replica's version; when
        the version is the canary, run the health gate. Callers skip
        overload 503s and 4xx — those say nothing about the weights."""
        if version is None or version < 0:
            return
        bad = None
        with self._lock:
            if version in self.quarantined:
                return
            self._note_version_locked(version)
            st = self._stats_for_locked(version)
            st["requests"] += 1
            if not ok:
                st["errors"] += 1
            if nan:
                st["nans"] += 1
            if ok and latency_ms is not None:
                lat = st["lat"]
                lat.append(float(latency_ms))
                if len(lat) > self.MAX_LAT_SAMPLES:
                    del lat[:len(lat) - self.MAX_LAT_SAMPLES]
            if version == self.canary:
                bad = self._gate_locked(st)
        if bad is not None and self.store is not None:
            # outside our lock: the store takes its own, and a slow disk
            # must not stall the dispatch path
            try:
                self.store.rollback(bad_version=bad)
            except Exception:  # noqa: BLE001 - quarantine already protects
                logger.exception("canary: weight-store rollback for "
                                 "version %d failed", bad)

    @staticmethod
    def _version_stats(st: Optional[Dict[str, Any]]
                       ) -> Optional[VersionStats]:
        if st is None:
            return None
        return VersionStats(requests=st["requests"], errors=st["errors"],
                            nans=st["nans"], latencies_ms=tuple(st["lat"]))

    def _gate_locked(self, st: Dict[str, Any]) -> Optional[int]:
        """Judge the canary; returns the version to roll back, or None
        (still trialling, or promoted). Caller holds ``self._lock``. The
        verdict itself is :func:`policies.canary_gate` — the pure function
        the fleet simulator replays; this shell applies its side effects
        (promotion bookkeeping, quarantine, metrics)."""
        v = self.canary
        verdict, reason = policies.canary_gate(
            self._version_stats(st),
            self._version_stats(self._stats.get(self.incumbent)),
            min_requests=self.min_requests,
            error_rate_margin=self.error_rate_margin,
            latency_factor=self.latency_factor,
            latency_floor_ms=self.latency_floor_ms)
        if verdict == policies.GATE_ROLLBACK:
            return self._rollback_locked(v, reason)
        if verdict == policies.GATE_PROMOTE:
            logger.info("canary: promoting version %d to incumbent "
                        "(was %s)", v, self.incumbent)
            self.incumbent, self.canary = v, None
            self.promotions += 1
        return None

    def _rollback_locked(self, v: int, reason: str) -> int:
        logger.warning("canary: rolling back version %d (%s)", v, reason)
        self.quarantined.add(v)
        self.canary = None
        self.rollbacks += 1
        self.metrics.incr("serving/canary_rollbacks")
        # the version gets zero post-gate traffic from here on: take its
        # gauges out of the exposition (stats() keeps the history — only
        # the live per-version family is retired)
        self.metrics.remove_prefix(f"serving/version{v}/")
        return v

    # -- membership version_policy hook --------------------------------------

    def filter_replicas(self, replicas: List[Replica],
                        version_of) -> List[Replica]:
        """Version-aware reorder of the load-sorted candidate list.
        Quarantined versions are dropped outright (zero post-gate traffic —
        an all-quarantined fleet yields [] and the router 503s rather than
        serve bad weights); with a canary under trial, ~``canary_fraction``
        of picks put the canary group first, the rest put it last. The
        reorder itself is :func:`policies.canary_reorder`; the random
        canary-fraction coin is drawn HERE (policies take it pre-drawn —
        no randomness inside the pure layer)."""
        with self._lock:
            for v in sorted({version_of(r) for r in replicas}):
                self._note_version_locked(v)
            q = frozenset(self.quarantined)
            canary = self.canary
            prefer_canary = self._rng.random() < self.canary_fraction
        by_pos = {i: r for i, r in enumerate(replicas)}
        versions = {i: version_of(r) for i, r in enumerate(replicas)}
        order = policies.canary_reorder(list(by_pos), versions, canary, q,
                                        prefer_canary)
        return [by_pos[i] for i in order]

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"incumbent": self.incumbent,
                    "canary": self.canary,
                    "quarantined": sorted(self.quarantined),
                    "promotions": self.promotions,
                    "rollbacks": self.rollbacks,
                    "versions": {
                        v: {"requests": st["requests"],
                            "errors": st["errors"],
                            "nans": st["nans"],
                            "latency_p95": self._p95(st["lat"])}
                        for v, st in self._stats.items()}}

    def publish_gauges(self) -> None:
        """Per-version health as Prometheus gauges:
        ``serving/version<v>/{requests,errors,latency_p95}`` plus the
        rollout state under ``serving/canary/*``."""
        with self._lock:
            # quarantined versions serve nothing: publishing them would
            # resurrect the family _rollback_locked just removed
            snap = {v: (st["requests"], st["errors"], self._p95(st["lat"]))
                    for v, st in self._stats.items()
                    if v not in self.quarantined}
            inc, can = self.incumbent, self.canary
            nq, promos, rbs = (len(self.quarantined), self.promotions,
                               self.rollbacks)
        for v, (req, errs, p95) in snap.items():
            prefix = f"serving/version{v}"
            self.metrics.gauge(f"{prefix}/requests", float(req))
            self.metrics.gauge(f"{prefix}/errors", float(errs))
            self.metrics.gauge(f"{prefix}/latency_p95", float(p95))
        self.metrics.gauge("serving/canary/incumbent",
                           float(-1 if inc is None else inc))
        self.metrics.gauge("serving/canary/version",
                           float(-1 if can is None else can))
        self.metrics.gauge("serving/canary/quarantined", float(nq))
        self.metrics.gauge("serving/canary/promotions", float(promos))
        self.metrics.gauge("serving/canary/rollbacks", float(rbs))


class _CallSlot:
    """Abortable handle on one in-flight replica call — hedging's loser
    cancellation. ``abort()`` closes the checked-out connection, which
    unblocks the worker thread mid-``recv`` (HTTP has no cancel verb; the
    socket teardown is the cancellation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conn = None
        self.aborted = False

    def attach(self, conn) -> bool:
        """Register the checked-out connection; False if already aborted
        (the worker must not even send)."""
        with self._lock:
            if self.aborted:
                return False
            self._conn = conn
            return True

    def detach(self) -> None:
        with self._lock:
            self._conn = None

    def abort(self) -> None:
        with self._lock:
            if self.aborted:
                return
            self.aborted = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


class _Aborted(Exception):
    """This attempt lost a hedge race; its failure is not the replica's."""


class RouterServer:
    """HTTP router fronting N ``InferenceServer`` replicas.

    ``RouterServer([url1, url2, ...], port=0).start()`` binds an ephemeral
    port (read ``router.port``/``router.url`` back) and speaks the same wire
    protocol as a single replica — ``POST /v1/predict``,
    ``POST /v1/generate`` (forwarded verbatim to replicas that enable
    decode), ``GET /healthz``, ``GET /metrics[?format=prometheus]`` — so
    :class:`ServingClient` points at a fleet unchanged.

    Parameters (beyond the membership knobs, which forward to
    :class:`~sparkflow_tpu_torch.serving.membership.Membership`):

    - ``dispatch_retries`` — reroute attempts after the first dispatch
      fails; ``retry_policy`` shapes the backoff between them.
    - ``max_inflight`` — router-wide concurrent-request cap; beyond it,
      requests shed with ``503 queue_full`` + ``Retry-After``.
    - ``admission_rate`` / ``admission_burst`` — optional token bucket
      (requests/s); ``None`` disables rate admission.
    - ``hedge`` / ``hedge_delay_ms`` / ``hedge_floor_ms`` — opt-in hedged
      requests. With ``hedge_delay_ms=None`` the delay is the live p95 of
      ``router/request_ms`` (never below ``hedge_floor_ms``).
    - ``cache_size`` — entries in the content-addressed result cache;
      0 disables it.
    - ``canary`` (+ ``canary_fraction`` / ``canary_min_requests`` /
      ``canary_error_margin`` / ``canary_latency_factor`` /
      ``weight_store``) — live-weight canary rollout: version-aware
      dispatch with a health gate that promotes or instantly rolls back a
      new weight version (see :class:`CanaryController`).
    """

    def __init__(self, replica_urls: Sequence[str], *,
                 host: str = "127.0.0.1", port: int = 0,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 failure_threshold: int = 3,
                 recovery_s: float = 2.0,
                 dispatch_retries: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 max_inflight: int = 256,
                 admission_rate: Optional[float] = None,
                 admission_burst: Optional[float] = None,
                 hedge: bool = False,
                 hedge_delay_ms: Optional[float] = None,
                 hedge_floor_ms: float = 20.0,
                 cache_size: int = 0,
                 request_timeout_s: float = 30.0,
                 retry_after_s: float = 1.0,
                 canary: bool = False,
                 canary_fraction: float = 0.25,
                 canary_min_requests: int = 20,
                 canary_error_margin: float = 0.05,
                 canary_latency_factor: float = 2.0,
                 weight_store=None,
                 clock=time.monotonic,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 tracer: Optional[spans_mod.Tracer] = None,
                 trace_sample: float = 0.01,
                 trace_slow_factor: float = 1.0,
                 trace_max: int = 256):
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()
        self.tracer = (tracer if tracer is not None
                       else spans_mod.default_tracer)
        # fleet tracing: tail-sampled assembly of cross-process request
        # timelines (errored/hedged/retried/slow requests always kept;
        # trace_sample head-samples the rest). GET /traces/<id> serves the
        # assembled waterfall.
        self.collector = TraceCollector(
            self.tracer, metrics=self.metrics, head_sample=trace_sample,
            slow_factor=trace_slow_factor, max_traces=trace_max)
        # canary=True arms version-aware dispatch + the health gate; a
        # weight_store additionally lets a rollback repoint latest.json so
        # every replica's watcher reverts to the last good version
        self.canary_ctl = (CanaryController(
            min_requests=canary_min_requests,
            canary_fraction=canary_fraction,
            error_rate_margin=canary_error_margin,
            latency_factor=canary_latency_factor,
            store=weight_store, metrics=self.metrics)
            if canary else None)
        self.membership = Membership(
            replica_urls, probe_interval_s=probe_interval_s,
            probe_timeout_s=probe_timeout_s,
            failure_threshold=failure_threshold, recovery_s=recovery_s,
            metrics=self.metrics, version_policy=self.canary_ctl,
            clock=clock)
        self.dispatch_retries = int(dispatch_retries)
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=self.dispatch_retries + 1, base_s=0.05,
            multiplier=2.0, max_s=0.5, jitter=0.5, seed=0)
        self.max_inflight = int(max_inflight)
        self.bucket = (TokenBucket(admission_rate, admission_burst,
                                   clock=clock)
                       if admission_rate is not None else None)
        self.hedge = bool(hedge)
        self.hedge_delay_ms = hedge_delay_ms
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.cache = ResultCache(cache_size) if cache_size else None
        self.request_timeout_s = float(request_timeout_s)
        self.retry_after_s = float(retry_after_s)
        self.lifecycle = Lifecycle()
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "RouterServer":
        if self._thread is not None:
            return self
        self.membership.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="router-server", daemon=True)
        self._thread.start()
        self.lifecycle.transition(ServerState.SERVING)
        return self

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self.lifecycle.transition(ServerState.DRAINING)
        self.lifecycle.wait_idle(timeout)
        self._httpd.shutdown()
        self._thread.join(timeout=timeout)
        self._httpd.server_close()
        self._thread = None
        self.membership.stop()
        self.lifecycle.transition(ServerState.STOPPED)

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- dispatch ------------------------------------------------------------

    def _hedge_delay_s(self) -> float:
        if self.hedge_delay_ms is not None:
            return self.hedge_delay_ms / 1000.0
        try:
            p95 = self.metrics.percentile("router/request_ms", 95)
        except (KeyError, ValueError):
            return self.hedge_floor_ms / 1000.0
        return max(self.hedge_floor_ms, p95) / 1000.0

    def _call_replica(self, replica: Replica, body: bytes,
                      headers: Dict[str, str], slot: _CallSlot,
                      path: str = "/v1/predict"
                      ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """One wire exchange with one replica over its keep-alive pool.
        A stale pooled connection gets one fresh retry (no response had
        started, so nothing can double-execute)."""
        for last_try in (False, True):
            conn, reused = replica.pool.acquire(self.request_timeout_s)
            if not slot.attach(conn):
                replica.pool.release(conn, reuse=reused)
                raise _Aborted()
            try:
                conn.request("POST", path, body=body,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except _STALE_CONN_ERRORS:
                aborted = slot.aborted
                slot.detach()
                replica.pool.release(conn, reuse=False)
                if aborted:
                    raise _Aborted()
                if reused and not last_try:
                    continue
                raise
            except Exception:
                aborted = slot.aborted
                slot.detach()
                replica.pool.release(conn, reuse=False)
                if aborted:
                    raise _Aborted()
                raise
            slot.detach()
            replica.pool.release(conn, reuse=not resp.will_close)
            obj = json.loads(data.decode("utf-8")) if data else {}
            if not isinstance(obj, dict):
                raise ValueError("replica returned a non-object body")
            return resp.status, obj, {k: v for k, v in resp.getheaders()}
        raise AssertionError("unreachable")  # pragma: no cover

    def _run_attempt(self, replica: Replica, body: bytes,
                     headers: Dict[str, str], slot: _CallSlot,
                     is_hedge: bool,
                     path: str = "/v1/predict",
                     ctx: Optional[spans_mod.TraceContext] = None,
                     info: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """One classified dispatch attempt. The outcome dict carries
        ``ok``/``retryable``/``status``/``obj`` plus breaker bookkeeping
        side effects (success, failure, or drain ejection), and ``span`` —
        the attempt's dispatch span, relabeled winner/loser after a hedge
        race resolves."""
        self.membership.begin_dispatch(replica, hedge=is_hedge)
        if info is not None:
            info["replicas"].append(replica.url)
        sp_args: Dict[str, Any] = {"replica": replica.url, "hedge": is_hedge}
        if ctx is not None:
            sp_args["trace_id"] = ctx.trace_id
        sp_ref: Optional[spans_mod.Span] = None
        try:
            faults.fire("replica.predict")
            with self.tracer.span("router/dispatch", args=sp_args) as sp:
                sp_ref = sp
                attempt_headers = headers
                if ctx is not None and sp is not None:
                    # re-parent the replica's fragment under THIS attempt:
                    # each hedge leg gets its own traceparent so the merged
                    # waterfall shows which attempt reached which replica
                    attempt_headers = dict(headers)
                    attempt_headers[spans_mod.TRACEPARENT_HEADER] = (
                        ctx.child(self.tracer.span_uid(sp.span_id))
                        .to_header())
                # graftcheck: dispatch-site
                status, obj, _hdrs = self._call_replica(replica, body,
                                                        attempt_headers,
                                                        slot, path)
        except _Aborted:
            # lost a hedge race: the closed socket is our doing, not the
            # replica's — no breaker bookkeeping
            return {"ok": False, "retryable": False, "aborted": True,
                    "replica": replica, "hedge": is_hedge, "span": sp_ref}
        except Exception as exc:  # noqa: BLE001 - wire failure = replica down
            self.membership.record_failure(replica, type(exc).__name__)
            return {"ok": False, "retryable": True, "exc": exc,
                    "replica": replica, "hedge": is_hedge, "span": sp_ref}
        finally:
            self.membership.end_dispatch(replica)
        # what the outcome MEANS (eject / reroute / breaker-feed / pass
        # through) is the pure policy; the side effects stay here
        code = (obj.get("error") or {}).get("code", "")
        verdict = policies.classify_outcome(status, code)
        if verdict == policies.OUTCOME_SUCCESS:
            self.membership.record_success(replica)
            return {"ok": True, "status": 200, "obj": obj,
                    "replica": replica, "hedge": is_hedge, "span": sp_ref}
        if verdict == policies.OUTCOME_EJECT:
            # the replica caught SIGTERM: out of rotation NOW, reroute
            self.membership.eject(replica, "draining 503")
        elif verdict == policies.OUTCOME_REROUTE:
            # queue_full: overloaded, not broken — reroute without feeding
            # the breaker (least-loaded pick already steers away)
            self.metrics.incr("router/replica_queue_full")
        elif verdict == policies.OUTCOME_FAILURE:
            self.membership.record_failure(replica, f"http {status}")
        # OUTCOME_CLIENT_ERROR (4xx): the request is wrong, not the
        # replica — pass through verbatim, no retry
        return {"ok": False,
                "retryable": verdict != policies.OUTCOME_CLIENT_ERROR,
                "status": status, "obj": obj, "replica": replica,
                "hedge": is_hedge, "span": sp_ref}

    def _attempt(self, primary: Replica, body: bytes,
                 headers: Dict[str, str],
                 path: str = "/v1/predict",
                 ctx: Optional[spans_mod.TraceContext] = None,
                 info: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One dispatch round: the primary call, optionally hedged with a
        duplicate to a second replica after the hedge delay. First success
        wins; losers are cancelled via their :class:`_CallSlot`."""
        if not self.hedge:
            return self._run_attempt(primary, body, headers, _CallSlot(),
                                     False, path, ctx, info)

        cond = threading.Condition()
        outcomes: List[Dict[str, Any]] = []
        slots: List[_CallSlot] = []
        launched = [0]
        resolved: List[Optional[Dict[str, Any]]] = [None]  # winner, once known

        def run(replica: Replica, is_hedge: bool, slot: _CallSlot) -> None:
            out = self._run_attempt(replica, body, headers, slot,
                                    is_hedge, path, ctx, info)
            with cond:
                outcomes.append(out)
                if resolved[0] is not None and out is not resolved[0]:
                    # the race resolved while this leg was still on the
                    # wire (abort unblocked it late): self-label as loser
                    sp = out.get("span")
                    if sp is not None and sp.args is not None:
                        sp.args["outcome"] = "loser"
                cond.notify_all()

        def launch(replica: Replica, is_hedge: bool) -> None:
            slot = _CallSlot()
            with cond:
                slots.append(slot)
                launched[0] += 1
            threading.Thread(target=run, args=(replica, is_hedge, slot),
                             name="router-hedge" if is_hedge
                             else "router-primary", daemon=True).start()

        launch(primary, False)
        deadline = time.monotonic() + self.request_timeout_s
        with cond:
            cond.wait_for(lambda: outcomes, timeout=self._hedge_delay_s())
            primary_done = bool(outcomes)
        if not primary_done:
            signal = "generate" if path == "/v1/generate" else "predict"
            second = self.membership.pick(exclude=[primary], signal=signal)
            if second is not None:
                self.metrics.incr("router/hedges")
                if info is not None:
                    info["hedged"] = True
                launch(second, True)
        with cond:
            cond.wait_for(
                lambda: any(o["ok"] for o in outcomes)
                or len(outcomes) >= launched[0],
                timeout=max(0.0, deadline - time.monotonic()))
            done = list(outcomes)
            all_slots = list(slots)
        winner = next((o for o in done if o["ok"]), None)
        # cancel losers: every in-flight slot dies with its socket; already
        # finished attempts see abort() as a no-op on a detached slot
        for slot in all_slots:
            slot.abort()
        if winner is not None:
            # label the race on the committed dispatch spans: the args dicts
            # are live references, so the trace waterfall shows which hedge
            # leg won even though the verdict postdates the spans (legs
            # still on the wire self-label in run() via `resolved`)
            with cond:
                resolved[0] = winner
                finished = list(outcomes)
            for o in finished:
                sp = o.get("span")
                if sp is not None and sp.args is not None:
                    sp.args["outcome"] = ("winner" if o is winner
                                          else "loser")
            if winner["hedge"]:
                self.metrics.incr("router/hedge_wins")
            return winner
        real = [o for o in done if not o.get("aborted")]
        if real:
            # prefer a non-retryable verdict (a 400 is authoritative)
            return next((o for o in real if not o["retryable"]), real[-1])
        # nothing answered inside the window: count it against the primary
        self.membership.record_failure(primary, "timeout")
        return {"ok": False, "retryable": True,
                "exc": TimeoutError(f"no replica answered within "
                                    f"{self.request_timeout_s}s"),
                "replica": primary, "hedge": False}

    def _dispatch(self, body: bytes, request_id: str,
                  path: str = "/v1/predict",
                  ctx: Optional[spans_mod.TraceContext] = None,
                  info: Optional[Dict[str, Any]] = None
                  ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """Route one request (predict or generate): cache, then
        retry/reroute rounds. The result cache only fronts predict —
        generate responses depend on sampling state, not just the body."""
        rid = {"X-Request-Id": request_id}
        faults.fire("router.dispatch")
        key = None
        if self.cache is not None and path == "/v1/predict":
            key = ResultCache.key(body)
            hit = self.cache.get(key)
            if hit is not None:
                self.metrics.incr("router/cache_hits")
                self.metrics.incr("router/http_200")
                return 200, {**hit, "request_id": request_id,
                             "cache": "hit"}, \
                    {**rid, "X-Cache": "hit"}
            self.metrics.incr("router/cache_misses")
        headers = {"Content-Type": "application/json",
                   "X-Request-Id": request_id}
        if ctx is not None:
            # base context; each attempt re-parents under its own dispatch
            # span in _run_attempt
            headers[spans_mod.TRACEPARENT_HEADER] = ctx.to_header()
        policy = self.retry_policy
        start = policy.clock()
        tried: List[Replica] = []
        last: Optional[Dict[str, Any]] = None
        budget = self.dispatch_retries + 1
        signal = "generate" if path == "/v1/generate" else "predict"
        for attempt in range(budget):
            if attempt:
                self.metrics.incr("router/rerouted")
                if info is not None:
                    info["retried"] = True
            replica = self.membership.pick(exclude=tried, signal=signal)
            if replica is None and tried:
                # every replica already tried this request — start a fresh
                # pass; a restarted/half-open replica may be back
                tried = []
                replica = self.membership.pick(signal=signal)
            if replica is None:
                self.metrics.incr("router/no_healthy_replica")
            else:
                t0 = time.perf_counter()
                out = self._attempt(replica, body, headers, path, ctx, info)
                if self.canary_ctl is not None:
                    self._observe_canary(out, replica,
                                         (time.perf_counter() - t0) * 1000.0)
                if out["ok"]:
                    obj = out["obj"]
                    if key is not None and "predictions" in obj:
                        self.cache.put(key, {
                            "predictions": obj["predictions"],
                            "rows": obj.get("rows")})
                    self.metrics.incr("router/http_200")
                    return 200, {**obj, "request_id": request_id}, rid
                if not out["retryable"]:
                    status = out.get("status", 500)
                    self.metrics.incr(f"router/http_{status}")
                    return status, out.get("obj") or {
                        "error": {"code": "bad_request", "message": ""}}, rid
                tried.append(replica)
                last = out
            if attempt + 1 < budget:
                delay = policy.backoff(attempt)
                if policy.clock() - start + delay > self.request_timeout_s:
                    break
                policy.sleep(delay)
        self.metrics.incr("router/http_503")
        detail = ""
        if last is not None:
            exc = last.get("exc")
            detail = (f"; last error: {type(exc).__name__}: {exc}"
                      if exc is not None
                      else f"; last status: {last.get('status')}")
        return 503, {"error": {
            "code": "no_healthy_replicas",
            "message": f"no replica served the request after "
                       f"{budget} attempt(s){detail}"}}, \
            {**self._retry_after(), **rid}

    def _observe_canary(self, out: Dict[str, Any], picked: Replica,
                        latency_ms: float) -> None:
        """Feed one dispatch outcome to the canary gate, keyed by the
        serving version of the replica that actually answered (the hedge
        winner may differ from the pick). Overload 503s and 4xx are skipped
        — they say nothing about the weights being trialled."""
        replica = out.get("replica") or picked
        ver = self.membership.version_of(replica)
        if out["ok"]:
            nan = _response_has_nan(out.get("obj") or {})
            self.canary_ctl.observe(ver, ok=not nan, latency_ms=latency_ms,
                                    nan=nan)
            return
        if out.get("status") == 503 or out.get("aborted"):
            return
        if out.get("exc") is not None or out.get("status", 0) >= 500:
            self.canary_ctl.observe(ver, ok=False)

    # -- http front ----------------------------------------------------------

    def _retry_after(self) -> Dict[str, str]:
        return {"Retry-After": str(max(1, int(round(self.retry_after_s))))}

    def _predict(self, body: bytes, request_id: str,
                 path: str = "/v1/predict",
                 ctx: Optional[spans_mod.TraceContext] = None
                 ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        rid = {"X-Request-Id": request_id}
        self.metrics.incr("router/requests")
        # admission: shed BEFORE any replica work, on the same structured
        # queue_full 503 the replicas use — retrying clients need no new code
        if self.bucket is not None and not self.bucket.try_acquire():
            self.metrics.incr("router/admission_rejections")
            self.metrics.incr("router/http_503")
            return 503, {"error": {
                "code": "queue_full",
                "message": "router admission rate exceeded; retry later"}}, \
                {**self._retry_after(), **rid}
        if self.lifecycle.inflight > self.max_inflight:
            self.metrics.incr("router/shed_inflight")
            self.metrics.incr("router/http_503")
            return 503, {"error": {
                "code": "queue_full",
                "message": f"router at capacity "
                           f"({self.max_inflight} in flight)"}}, \
                {**self._retry_after(), **rid}
        if ctx is None:
            ctx = spans_mod.TraceContext.mint()
        info: Dict[str, Any] = {"replicas": [], "hedged": False,
                                "retried": False}
        rargs = {"request_id": request_id, "trace_id": ctx.trace_id}
        t0 = time.perf_counter()
        try:
            with self.tracer.span("router/request", args=rargs):
                status, obj, headers = self._dispatch(body, request_id,
                                                      path, ctx, info)
        except Exception as exc:  # noqa: BLE001 - surface, don't hang
            self.metrics.incr("router/http_500")
            self._observe_trace(ctx, (time.perf_counter() - t0) * 1000.0,
                                True, info)
            return 500, {"error": {"code": "internal",
                                   "message": f"{type(exc).__name__}: "
                                              f"{exc}"}}, rid
        dur_ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.observe("router/request_ms", dur_ms)
        self._observe_trace(ctx, dur_ms, status >= 500, info)
        return status, obj, headers

    def _observe_trace(self, ctx: spans_mod.TraceContext, dur_ms: float,
                       error: bool, info: Dict[str, Any]) -> None:
        """Feed the tail sampler; assembly (rare by construction) fetches
        the touched replicas' fragments. Never raises into the request."""
        if not ctx.sampled:
            return  # client explicitly opted this trace out
        try:
            self.collector.observe_request(
                ctx.trace_id, dur_ms, error=error,
                hedged=info["hedged"], retried=info["retried"],
                replicas=list(dict.fromkeys(info["replicas"])))
        except Exception:  # noqa: BLE001 - tracing must not fail serving
            self.metrics.incr("trace/observe_errors")

    def _healthz(self) -> Tuple[int, Dict[str, Any],
                                Optional[Dict[str, str]]]:
        state = self.lifecycle.state
        replicas = self.membership.snapshot()
        healthy = self.membership.healthy_count()
        serving = state in (ServerState.SERVING, ServerState.STARTING)
        body = {"status": ("ok" if serving and healthy else
                           ("degraded" if serving else state.value)),
                "state": state.value,
                "role": "router",
                "inflight": self.lifecycle.inflight,
                "healthy_replicas": healthy,
                "replicas": replicas}
        if self.cache is not None:
            body["cache"] = self.cache.stats()
        if self.canary_ctl is not None:
            body["canary"] = self.canary_ctl.stats()
        body["trace"] = {"process": self.tracer.fingerprint,
                         "kept": len(self.collector.trace_ids())}
        if serving and healthy:
            return 200, body, None
        return 503, body, self._retry_after()

    def _metrics_json(self) -> Tuple[int, Dict[str, Any]]:
        self.membership.publish_gauges()
        if self.canary_ctl is not None:
            self.canary_ctl.publish_gauges()
        summary = self.metrics.summary()
        if self.cache is not None:
            summary["cache"] = self.cache.stats()
        return 200, summary

    def _metrics_prometheus(self) -> Tuple[int, str]:
        self.membership.publish_gauges()
        if self.canary_ctl is not None:
            self.canary_ctl.publish_gauges()
        if self.cache is not None:
            stats = self.cache.stats()
            self.metrics.gauge("router/cache_entries", stats["entries"])
        return 200, prometheus_text(self.metrics)

    def _make_handler(self):
        router = self

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
                # same contract as the replica server: once draining, shed
                # keep-alive connections so clients re-dial elsewhere
                if router.lifecycle.state not in (ServerState.SERVING,
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
                    self._reply(*router._healthz())
                elif path == "/metrics":
                    fmt = parse_qs(query).get("format", ["json"])[0]
                    if fmt == "prometheus":
                        status, text = router._metrics_prometheus()
                        self._reply_text(
                            status, text,
                            "text/plain; version=0.0.4; charset=utf-8")
                    else:
                        self._reply(*router._metrics_json())
                elif path == "/traces":
                    self._reply(200, {
                        "traces": router.collector.trace_ids()})
                elif path.startswith("/traces/"):
                    tid = path[len("/traces/"):]
                    trace = router.collector.get(tid)
                    if trace is None:
                        self._reply(404, {"error": {
                            "code": "not_found",
                            "message": f"no assembled trace {tid}"}})
                    else:
                        # re-assemble at read time: hedge legs that were
                        # still on the wire at keep time have landed (and
                        # self-labeled) by the time anyone reads the trace
                        try:
                            trace = router.collector.assemble(
                                tid, replicas=trace.get("replicas", ()),
                                reason=trace.get("reason", "manual"),
                                duration_ms=trace.get("duration_ms"))
                        except Exception:  # noqa: BLE001 - serve the cached one
                            pass
                        self._reply(200, trace)
                else:
                    self._reply(404, {"error": {"code": "not_found",
                                                "message": self.path}})

            def do_POST(self):  # noqa: N802
                if self.path not in ("/v1/predict", "/v1/generate"):
                    self._reply(404, {"error": {"code": "not_found",
                                                "message": self.path}})
                    return
                request_id = (self.headers.get("X-Request-Id")
                              or uuid.uuid4().hex)
                # accept the client's trace context, or mint one: either
                # way the response advertises the trace id back via the
                # same traceparent header
                ctx = (spans_mod.TraceContext.parse(
                    self.headers.get(spans_mod.TRACEPARENT_HEADER))
                    or spans_mod.TraceContext.mint())
                if not router.lifecycle.try_begin_request():
                    router.metrics.incr("router/http_503")
                    self._reply(503, {"error": {
                        "code": "draining",
                        "message": "router is draining"}},
                        {**router._retry_after(),
                         "X-Request-Id": request_id})
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    status, obj, hdrs = router._predict(body, request_id,
                                                        self.path, ctx)
                    hdrs = {**(hdrs or {}),
                            spans_mod.TRACEPARENT_HEADER: ctx.to_header()}
                    self._reply(status, obj, hdrs)
                finally:
                    router.lifecycle.end_request()

            def log_message(self, fmt, *args):  # quiet: metrics cover this
                pass

        return Handler
