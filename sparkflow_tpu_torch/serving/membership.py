"""Health-gated replica membership for the serving router — carried
unchanged from the JAX package's ``serving/membership.py``.

The reference funnels every exchange through one Flask parameter server
(``sparkflow/HogwildSparkModel.py:156-166``) — a single point of failure the
paper never mitigates. This module is the fleet-side antidote on the serving
path: a :class:`Membership` tracks N :class:`Replica` records and decides,
per request, which replica should get the work. Three independent gates
compose:

- **Health probes.** A background prober hits each replica's ``/healthz``
  every ``probe_interval_s``; a 200 marks it healthy and harvests the body's
  ``queue_depth`` / ``in_flight`` fields as the load signal (the probe
  doubles as load reporting — no second endpoint). A connection error or a
  non-200 (a draining replica answers 503) marks it unhealthy.
- **Circuit breaker** (:class:`CircuitBreaker`), fed by the *data path*:
  ``failure_threshold`` consecutive dispatch failures eject the replica
  (OPEN) without waiting for the next probe tick; after ``recovery_s`` one
  trial request is allowed through (HALF_OPEN) — success closes the
  breaker, failure re-opens it. DeepSpark's lesson (PAPERS.md, 1602.08191):
  worker failure is the steady state, so detection has to run at request
  cadence, not probe cadence.
- **Drain ejection.** A ``Draining`` 503 from a replica (SIGTERM received,
  finishing in-flight work) calls :meth:`Membership.eject` — the replica
  leaves the rotation immediately and re-enters only when its ``/healthz``
  goes green again (i.e. after a restart).

Dispatch picks the **least-loaded** live replica: for predict traffic the
lowest router-side in-flight counter, tie-broken by the probe-reported
replica-side queue depth; for ``/v1/generate`` traffic the load signal is
**KV headroom** (``free_slots`` / ``pages_free`` from the probe body's
``decode`` block) — a decode replica's capacity is pages, not queue length,
so page-starved replicas sort last while still serving predict normally.
All mutable state (health flags, counters, load figures) is guarded
by one ``Membership._lock``; per-replica gauges are published to a
``utils.metrics`` registry so ``GET /metrics?format=prometheus`` on the
router exposes the whole fleet (``router/replica<i>/...``).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence
from urllib.parse import urlsplit

from ..utils import metrics as metrics_mod
from ..utils import quant
from . import policies
from .client import ConnectionPool, ServingClient, ServingError
from .policies import ReplicaView

__all__ = ["BreakerState", "CircuitBreaker", "Replica", "Membership"]

logger = logging.getLogger("sparkflow_tpu_torch")


class BreakerState(enum.Enum):
    CLOSED = "closed"          # normal operation
    OPEN = "open"              # ejected: all requests refused
    HALF_OPEN = "half_open"    # recovery window: one trial request allowed


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a half-open recovery probe.

    CLOSED counts consecutive failures; at ``failure_threshold`` it OPENs
    (``allow()`` returns False). After ``recovery_s`` the next ``allow()``
    claims the single HALF_OPEN trial slot; the trial's ``record_success``
    closes the breaker, its ``record_failure`` re-opens it for another
    ``recovery_s``. ``clock`` is injectable so tests drive recovery with a
    fake clock instead of sleeping.
    """

    def __init__(self, failure_threshold: int = 3, recovery_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._trial_in_flight = False
        self.ejections = 0  # times the breaker OPENed (monotone)

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request be sent now? In HALF_OPEN only one caller wins the
        trial slot until its outcome is recorded."""
        with self._lock:
            if self._state is BreakerState.CLOSED:
                return True
            if self._state is BreakerState.OPEN:
                if self.clock() - self._opened_at < self.recovery_s:
                    return False
                self._state = BreakerState.HALF_OPEN
                self._trial_in_flight = True
                return True
            # HALF_OPEN: the trial slot is exclusive
            if self._trial_in_flight:
                return False
            self._trial_in_flight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = BreakerState.CLOSED
            self._consecutive_failures = 0
            self._trial_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                self._open_locked()
                return
            self._consecutive_failures += 1
            if (self._state is BreakerState.CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._open_locked()

    def trip(self) -> None:
        """Force OPEN immediately (drain ejection: the replica said it is
        going away; there is no point counting to the threshold)."""
        with self._lock:
            if self._state is not BreakerState.OPEN:
                self._open_locked()
            else:
                self._opened_at = self.clock()

    def _open_locked(self) -> None:
        self._state = BreakerState.OPEN
        self._opened_at = self.clock()
        self._consecutive_failures = 0
        self._trial_in_flight = False
        self.ejections += 1


class Replica:
    """One backend ``InferenceServer``: address, keep-alive plumbing, breaker,
    and the load/health figures Membership maintains for it.

    The mutable fields (``healthy``, ``inflight``, ``successes`` ...) are
    owned by :class:`Membership` and mutated only under its lock; the
    breaker carries its own lock (it is also poked from dispatch threads).
    """

    def __init__(self, url: str, index: int, *,
                 failure_threshold: int = 3, recovery_s: float = 2.0,
                 probe_timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.url = url.rstrip("/")
        self.index = index
        parts = urlsplit(self.url)
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or 80
        # data-path pool: dispatch attempts check out abortable connections
        self.pool = ConnectionPool(self.host, self.port)
        # probe client: keep-alive too, with retries off (the prober IS the
        # failure detector; retrying inside it would blur the signal)
        self.probe_client = ServingClient(self.url, timeout=probe_timeout_s,
                                          retries=0, max_idle=1)
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                      recovery_s=recovery_s, clock=clock)
        # -- fields below are guarded by Membership._lock -------------------
        self.healthy = True          # optimistic until the first probe
        # consecutive failed probes; reset by any green /healthz. The
        # scaling policy's death debounce reads this: one missed probe
        # takes the replica out of rotation (healthy=False) but does NOT
        # mark it dead — probe timeouts correlate with saturation, and
        # killing a slow replica amplifies the overload that slowed it.
        self.probe_misses = 0
        self.inflight = 0            # router-side dispatches in flight
        self.queue_depth = 0         # replica-reported, from /healthz
        self.reported_in_flight = 0  # replica-reported, from /healthz
        # decode-plane KV headroom, from /healthz's "decode" block; -1 =
        # unknown (no decode plane on the replica, or not yet probed)
        self.decode_free_slots = -1
        self.decode_pages_free = -1
        # quantized-pool layout from /healthz: pool storage dtype and the
        # replica-total bytes one page costs (K+V+scales, all layers).
        # Effective-capacity routing multiplies pages_free by this, so a
        # bf16 replica and an int8 replica with equal page counts compare
        # by the bytes they can actually still hold. -1 = unknown.
        self.kv_dtype = "bf16"
        self.kv_bytes_per_page = -1
        # speculative-decode acceptance rate from /healthz; -1 = speculation
        # off on the replica (or not yet probed)
        self.decode_spec_accept_rate = -1.0
        # model-parallel layout from /healthz's "decode" block: tp/ep/pp
        # degree and the replica's mesh axis sizes. tp/ep/pp default to 1
        # (a replica without a decode plane is effectively unsharded);
        # mesh_shape is None until a probe reports one. pp == stages: the
        # replica's pipeline depth, exported so capacity math knows its
        # per-device KV bytes are 1/pp of the replica total.
        self.mesh_shape: Optional[Dict[str, int]] = None
        self.tp = 1
        self.ep = 1
        self.pp = 1
        # live-weight version from /healthz ("serving_version"); -1 = not
        # yet probed. Canary dispatch keys on this.
        self.version = -1
        # distributed-tracing advertisement from /healthz's "trace" block:
        # the replica tracer's process fingerprint (namespaces its span ids
        # in assembled traces) and where its flight recorder writes, so the
        # ReplicaManager knows what to harvest when this replica dies.
        self.trace_process: Optional[str] = None
        self.flight_path: Optional[str] = None
        # when (by `clock`) the last successful probe harvested the load
        # figures above; 0.0 = never probed. The pick degrades stale load
        # reports to "unknown" via policies.probe_is_stale, and the
        # injectable clock lets the simulator/tests drive that check in
        # virtual time.
        self.clock = clock
        self.last_probe_t = 0.0
        # cumulative dispatches ever sent here; the pure pick's
        # equal-load tie-break (least-served first), so ties spread
        # instead of always landing on the lowest index
        self.dispatched = 0
        self.successes = 0
        self.failures = 0
        self.hedges = 0              # hedge requests sent to this replica
        self.last_probe_error: Optional[str] = None

    def close(self) -> None:
        self.pool.close()
        self.probe_client.close()


class Membership:
    """Thread-safe replica table + health prober + least-loaded picker."""

    def __init__(self, urls: Sequence[str], *,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 failure_threshold: int = 3,
                 recovery_s: float = 2.0,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 version_policy=None,
                 clock: Callable[[], float] = time.monotonic):
        if not urls:
            raise ValueError("at least one replica url is required")
        self.probe_interval_s = float(probe_interval_s)
        # kept for register(): late-joining replicas get the same breaker
        # and probe parameters the founding fleet got
        self._probe_timeout_s = float(probe_timeout_s)
        self._failure_threshold = int(failure_threshold)
        self._recovery_s = float(recovery_s)
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()
        # version_policy: an object with filter_replicas(ordered, version_of)
        # — the router's CanaryController plugs in here to do version-aware
        # (canary-weighted, quarantine-excluding) dispatch
        self.version_policy = version_policy
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: List[Replica] = [
            Replica(u, i, failure_threshold=failure_threshold,
                    recovery_s=recovery_s, probe_timeout_s=probe_timeout_s,
                    clock=clock)
            for i, u in enumerate(urls)]
        self._next_index = len(self._replicas)  # never-recycled identity
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Membership":
        """Probe every replica once synchronously (so the first request
        already routes on real health), then keep probing on a daemon
        thread."""
        if self._prober is not None:
            return self
        self.probe_all()
        self._stop.clear()
        self._prober = threading.Thread(target=self._probe_loop,
                                        name="router-prober", daemon=True)
        self._prober.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
            self._prober = None
        for r in self._replicas:
            r.close()
            # deregister() covers replicas that left while we ran; replicas
            # still in the set at stop() need their gauges taken down here,
            # or a shared registry keeps advertising the dead fleet
            self.metrics.remove_prefix(f"router/replica{r.index}/")

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self.probe_all()

    # -- probing -------------------------------------------------------------

    def probe_all(self) -> None:
        for replica in list(self._replicas):
            self._probe_one(replica)
        self.publish_gauges()

    def _probe_one(self, replica: Replica) -> None:
        try:
            body = replica.probe_client.healthz()
            ok, err = True, None
        except ServingError as exc:
            # 503 = draining (or otherwise not ready): out of rotation, but
            # the socket is alive — keep probing, it flips back on restart
            body, ok, err = {}, False, f"http {exc.status} [{exc.code}]"
        except Exception as exc:  # noqa: BLE001 - any wire failure = down
            body, ok, err = {}, False, f"{type(exc).__name__}: {exc}"
        with self._lock:
            was_healthy = replica.healthy
            replica.healthy = ok
            replica.last_probe_error = err
            if not ok:
                replica.probe_misses += 1
            if ok:
                replica.probe_misses = 0
                replica.last_probe_t = self._clock()
                replica.queue_depth = int(body.get("queue_depth", 0))
                replica.reported_in_flight = int(body.get("in_flight", 0))
                try:
                    replica.version = int(body.get("serving_version", -1))
                except (TypeError, ValueError):
                    replica.version = -1
                tr = body.get("trace")
                if isinstance(tr, dict):
                    tp_fp = tr.get("process")
                    replica.trace_process = (str(tp_fp) if tp_fp else None)
                    fp_path = tr.get("flight")
                    replica.flight_path = (str(fp_path) if fp_path else None)
                else:
                    replica.trace_process = None
                    replica.flight_path = None
                dec = body.get("decode")
                if isinstance(dec, dict):
                    replica.decode_free_slots = int(dec.get("free_slots", -1))
                    replica.decode_pages_free = int(dec.get("pages_free", -1))
                    replica.decode_spec_accept_rate = float(
                        dec.get("spec_accept_rate", -1.0))
                    ms = dec.get("mesh_shape")
                    replica.mesh_shape = (dict(ms) if isinstance(ms, dict)
                                          else None)
                    replica.tp = int(dec.get("tp", 1) or 1)
                    replica.ep = int(dec.get("ep", 1) or 1)
                    replica.pp = int(dec.get("pp", 1) or 1)
                    replica.kv_dtype = str(dec.get("kv_dtype") or "bf16")
                    try:
                        replica.kv_bytes_per_page = int(
                            dec.get("kv_bytes_per_page") or -1)
                    except (TypeError, ValueError):
                        replica.kv_bytes_per_page = -1
                else:
                    replica.decode_free_slots = -1
                    replica.decode_pages_free = -1
                    replica.decode_spec_accept_rate = -1.0
                    replica.mesh_shape = None
                    replica.tp = 1
                    replica.ep = 1
                    replica.pp = 1
                    replica.kv_dtype = "bf16"
                    replica.kv_bytes_per_page = -1
        if ok:
            # a live /healthz is recovery evidence: without it an ejected
            # replica on an idle fleet stays OPEN forever, because half-open
            # trials otherwise only happen on dispatch. allow() paces this to
            # the breaker's own recovery window and claims the single trial
            # slot (skipped if a real request already holds it).
            br = replica.breaker
            if br.state is not BreakerState.CLOSED and br.allow():
                br.record_success()
        if ok != was_healthy:
            logger.warning("router: replica %s is now %s%s", replica.url,
                           "healthy" if ok else "unhealthy",
                           "" if ok else f" ({err})")

    # -- dispatch bookkeeping ------------------------------------------------

    def view_of(self, replica: Replica, now: Optional[float] = None
                ) -> ReplicaView:
        """Frozen policy-layer snapshot of one replica. Caller holds
        ``self._lock``. A stale probe report (older than 3 probe intervals
        by the injectable clock — a wedged prober) degrades the load
        figures to unknown rather than freezing old 'idle' numbers into
        every pick."""
        stale = policies.probe_is_stale(
            replica.last_probe_t,
            self._clock() if now is None else now,
            self.probe_interval_s)
        return ReplicaView(
            index=replica.index, healthy=replica.healthy,
            inflight=replica.inflight,
            queue_depth=0 if stale else replica.queue_depth,
            decode_free_slots=-1 if stale else replica.decode_free_slots,
            decode_pages_free=-1 if stale else replica.decode_pages_free,
            kv_bytes_per_page=replica.kv_bytes_per_page,
            version=replica.version, dispatched=replica.dispatched,
            probe_misses=replica.probe_misses)

    def pick(self, exclude: Sequence[Replica] = (),
             signal: str = "predict") -> Optional[Replica]:
        """Least-loaded live replica (healthy + breaker allows), or None.
        ``exclude`` skips replicas already tried for this request (reroute)
        or already carrying its primary attempt (hedge).

        The *decision* lives in :mod:`~sparkflow_tpu_torch.serving.policies`
        (pure functions over :class:`ReplicaView` snapshots — the same
        code the fleet simulator replays): ``"predict"`` ranks by
        router-side in-flight then replica queue depth
        (:func:`policies.predict_pick_key`); ``"generate"`` ranks by
        **byte-headroom weighted load** — occupancy per effective free KV
        byte, ``pages_free x kv_bytes_per_page``, so a heterogeneous
        bf16/int8 fleet loads replicas proportionally to the bytes each
        can still hold, with page-/slot-starved replicas last (still
        dispatchable as a final resort: replica-side admission turns it
        into explicit backpressure) and unknown headroom after known
        (:func:`policies.generate_pick_key`). Equal-load ties go to the
        replica with the fewest cumulative dispatches (self-balancing)
        instead of always the lowest index."""
        skip = {id(r) for r in exclude}
        with self._lock:
            now = self._clock()
            candidates = {r.index: r for r in self._replicas
                          if id(r) not in skip}
            views = [self.view_of(r, now) for r in candidates.values()]
            order = policies.pick_order(views, signal=signal)
            ordered = [candidates[i] for i in order]
            versions = {id(r): r.version for r in ordered}
        if self.version_policy is not None and ordered:
            # canary weighting + quarantine exclusion, applied to the
            # load-sorted list OUTSIDE the lock (the policy has its own)
            ordered = self.version_policy.filter_replicas(
                ordered, lambda r: versions.get(id(r), -1))
        # breaker.allow() outside the membership lock, in load order, and
        # ONLY until the first taker: allow() on a HALF_OPEN breaker claims
        # its single trial slot, so probing replicas we then don't dispatch
        # to would strand their trial and lock them out
        for r in ordered:
            if r.breaker.allow():
                return r
        return None

    def begin_dispatch(self, replica: Replica, hedge: bool = False) -> None:
        with self._lock:
            replica.inflight += 1
            replica.dispatched += 1
            if hedge:
                replica.hedges += 1

    def end_dispatch(self, replica: Replica) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)

    def record_success(self, replica: Replica) -> None:
        replica.breaker.record_success()
        with self._lock:
            replica.successes += 1

    def record_failure(self, replica: Replica, reason: str = "") -> None:
        replica.breaker.record_failure()
        with self._lock:
            replica.failures += 1
        if replica.breaker.state is BreakerState.OPEN:
            logger.warning("router: circuit opened for replica %s%s",
                           replica.url, f" ({reason})" if reason else "")

    def version_of(self, replica: Replica) -> int:
        """Last probed serving_version of ``replica`` (-1 = unknown)."""
        with self._lock:
            return replica.version

    def eject(self, replica: Replica, reason: str = "") -> None:
        """Immediate removal from rotation (draining replica): trip the
        breaker AND mark unhealthy — only a green ``/healthz`` re-admits."""
        replica.breaker.trip()
        with self._lock:
            replica.healthy = False
        logger.warning("router: ejected replica %s%s", replica.url,
                       f" ({reason})" if reason else "")

    # -- elastic membership --------------------------------------------------

    def register(self, url: str) -> Replica:
        """Add a replica to the fleet at runtime (autoscaler scale-up /
        crash replacement). The new record gets the next never-used index
        — indices are identities in gauges and pick tie-breaks, so they
        are not recycled — and is probed once synchronously so the very
        next ``pick`` can route to it on real health."""
        with self._lock:
            idx = self._next_index
            self._next_index += 1
            replica = Replica(
                url, idx, failure_threshold=self._failure_threshold,
                recovery_s=self._recovery_s,
                probe_timeout_s=self._probe_timeout_s, clock=self._clock)
            self._replicas.append(replica)
        self._probe_one(replica)
        self.publish_gauges()
        logger.info("router: registered replica %s as index %d", url, idx)
        return replica

    def deregister(self, replica: Replica) -> None:
        """Remove a replica from the fleet for good (scale-down): filter
        it from the pick order, stop probing it (the prober iterates the
        live table), close its connections, and drop its
        ``router/replica<i>/*`` gauges so the exposition doesn't advertise
        a ghost replica forever — unlike :meth:`eject`, which keeps
        probing so a restart re-admits."""
        with self._lock:
            try:
                self._replicas.remove(replica)
            except ValueError:
                return                  # already gone: idempotent
        replica.close()
        self.metrics.remove_prefix(f"router/replica{replica.index}/")
        logger.info("router: deregistered replica %s (index %d)",
                    replica.url, replica.index)

    # -- introspection -------------------------------------------------------

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def healthy_count(self) -> int:
        with self._lock:
            candidates = [r for r in self._replicas if r.healthy]
        return sum(1 for r in candidates
                   if r.breaker.state is not BreakerState.OPEN)

    def views(self, now: Optional[float] = None) -> List[ReplicaView]:
        """Frozen policy-layer snapshot of the whole fleet under one lock
        acquisition — the autoscaler's input to
        :func:`policies.scale_decision` (and the same shape the fleet
        simulator feeds it, so sim-tuned bands transfer)."""
        with self._lock:
            t = self._clock() if now is None else now
            return [self.view_of(r, t) for r in self._replicas]

    def snapshot(self) -> List[Dict[str, Any]]:
        """Per-replica status table for the router's ``/healthz`` body."""
        with self._lock:
            rows = [dict(url=r.url, index=r.index, healthy=r.healthy,
                         inflight=r.inflight, queue_depth=r.queue_depth,
                         reported_in_flight=r.reported_in_flight,
                         decode_free_slots=r.decode_free_slots,
                         decode_pages_free=r.decode_pages_free,
                         decode_spec_accept_rate=r.decode_spec_accept_rate,
                         mesh_shape=r.mesh_shape, tp=r.tp, ep=r.ep, pp=r.pp,
                         kv_dtype=r.kv_dtype,
                         kv_bytes_per_page=r.kv_bytes_per_page,
                         version=r.version, last_probe_t=r.last_probe_t,
                         successes=r.successes, failures=r.failures,
                         hedges=r.hedges, last_probe_error=r.last_probe_error)
                    for r in self._replicas]
        for row, r in zip(rows, self.replicas):
            row["breaker"] = r.breaker.state.value
            row["ejections"] = r.breaker.ejections
        return rows

    def publish_gauges(self) -> None:
        """Export the fleet table as Prometheus gauges:
        ``router/replica<i>/{healthy,ejected,inflight,error_rate,hedges,
        kv_pages_free,kv_dtype_code,kv_bytes_per_page,spec_accept_rate,
        tp,ep,pp,version}``."""
        for row in self.snapshot():
            prefix = f"router/replica{row['index']}"
            total = row["successes"] + row["failures"]
            ejected = row["breaker"] != BreakerState.CLOSED.value
            self.metrics.gauge(f"{prefix}/healthy",
                               1.0 if row["healthy"] and not ejected else 0.0)
            self.metrics.gauge(f"{prefix}/ejected", 1.0 if ejected else 0.0)
            self.metrics.gauge(f"{prefix}/inflight", float(row["inflight"]))
            self.metrics.gauge(f"{prefix}/error_rate",
                               row["failures"] / total if total else 0.0)
            self.metrics.gauge(f"{prefix}/hedges", float(row["hedges"]))
            self.metrics.gauge(f"{prefix}/kv_pages_free",
                               float(row["decode_pages_free"]))
            # quantized-pool capacity: dtype code (0=bf16, 1=int8, 2=fp8;
            # -1 unknown) and bytes-per-page, so a dashboard can plot
            # effective byte headroom (pages_free x bytes_per_page) on a
            # mixed-precision fleet
            code = (float(quant.KV_DTYPES.index(row["kv_dtype"]))
                    if row["kv_dtype"] in quant.KV_DTYPES else -1.0)
            self.metrics.gauge(f"{prefix}/kv_dtype_code", code)
            self.metrics.gauge(f"{prefix}/kv_bytes_per_page",
                               float(row["kv_bytes_per_page"]))
            self.metrics.gauge(f"{prefix}/spec_accept_rate",
                               float(row["decode_spec_accept_rate"]))
            # model-parallel degrees: a fleet dashboard reading capacity off
            # pages_free needs to know pages are per-replica (sharded over
            # tp heads / pp layers), and a mixed tp=1/tp=2 or pp=1/pp=2
            # rollout shows up here
            self.metrics.gauge(f"{prefix}/tp", float(row["tp"]))
            self.metrics.gauge(f"{prefix}/ep", float(row["ep"]))
            self.metrics.gauge(f"{prefix}/pp", float(row["pp"]))
            # live-weight version per replica: a rollout (or a rollback)
            # is visible as this gauge stepping across the fleet
            self.metrics.gauge(f"{prefix}/version", float(row["version"]))
