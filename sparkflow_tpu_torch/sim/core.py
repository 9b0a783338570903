"""Deterministic discrete-event fleet simulator — carried unchanged from
the JAX package's ``sim/core.py``.

Replays a request trace (:mod:`sparkflow_tpu_torch.sim.trace`) against a
simulated fleet whose *decisions* come from the exact policy code the
real serving plane runs — :mod:`sparkflow_tpu_torch.serving.policies` for
pick order / outcome classification / staleness, the real
:class:`~sparkflow_tpu_torch.serving.membership.CircuitBreaker` and
:class:`~sparkflow_tpu_torch.serving.router.TokenBucket` (both on the
simulator's virtual clock), the real
:class:`~sparkflow_tpu_torch.serving.router.CanaryController` when canary
dispatch is on, and the real
:class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy` backoff schedule.
Only *transport and compute* are simulated: instead of HTTP and a card,
each replica prices its work with a :class:`~sparkflow_tpu_torch.sim.costmodel.
CostModel` fitted from bench measurements. That separation is the whole
design — a policy bug found here is a policy bug in production code, not
in a reimplementation.

Determinism contract: one ``seed`` drives every random draw (canary
coin, retry jitter), the event heap breaks time ties with a monotone
sequence number, and no wall-clock value is ever read. Same trace + same
fleet + same seed => byte-identical event log (asserted via the running
sha256 ``digest`` in :class:`SimReport`, which is computed even when
per-event records are not retained).

Scale: picks use a lazy min-heap over the pure pick keys rather than the
O(n log n) full sort the real router can afford at its fleet sizes. The
least-served tie-break in ``policies`` makes every key a function of one
replica's state alone, so each dispatch/finish/probe invalidates exactly
one heap entry — 1000 replicas x 1M requests runs in seconds. A parity
test pins heap-argmin == ``policies.pick_order(...)[0]``; canary runs
use the full sort + real ``filter_replicas`` path (canary fleets are
small).

Reported vs true state mirrors production: the pick sees each replica's
*last probe report* (queue depth, free slots, free pages refreshed every
``probe_interval_s``, staggered per replica) plus the router-side live
``inflight`` counter — never the replica's instantaneous truth. Routing
pathologies caused by stale load reports reproduce here for free.
"""

from __future__ import annotations

import hashlib
import heapq
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..resilience.retry import RetryPolicy
from ..serving import policies
from ..serving.membership import BreakerState, CircuitBreaker
from ..serving.policies import ReplicaView
from ..serving.router import CanaryController, TokenBucket

__all__ = ["ReplicaSpec", "SimReplica", "SimReport", "FleetSimulator",
           "SimAutoscaler", "legacy_generate_pick_key"]

# event kinds (ints: compared only via the heap's (t, seq) prefix)
_ARRIVE, _PROBE, _FINISH, _RETRY, _CHAOS, _SCALE, _SPAWN = range(7)


def legacy_generate_pick_key(view: ReplicaView) -> Tuple:
    """The pre-debit generate pick rule, kept for what-if A/B runs.

    Trusts the probe's ``decode_pages_free`` figure as-is. That report is
    up to a probe interval stale, so during a burst this rule keeps
    dispatching to replicas whose pools already paged out and pays a
    queue_full reroute storm once they shed — the failure mode the
    simulator surfaced and the inflight debit in
    ``policies.generate_pick_key`` fixes.
    """
    starved = 1 if (view.decode_pages_free == 0
                    or view.decode_free_slots == 0) else 0
    return (starved, view.inflight, -view.free_kv_bytes,
            view.dispatched, view.index)


@dataclass(frozen=True)
class SimAutoscaler:
    """Elastic-fleet hook for :class:`FleetSimulator`: runs the REAL
    :func:`sparkflow_tpu_torch.serving.policies.scale_decision` on the virtual
    clock, so a :class:`~sparkflow_tpu_torch.serving.policies.ScaleTargets`
    candidate is A/B-tuned against deterministic traffic steps before the
    live :class:`~sparkflow_tpu_torch.serving.autoscaler.Autoscaler` ever spawns
    a process.

    ``specs`` passed to the simulator describe the *physical pool* (the
    machines the fleet could occupy); ``initial`` of them start live and
    ``targets.max_replicas`` bounds growth. ``spawn_delay_s`` models
    boot-to-serving time — the quantity the zero-compile cold start
    attacks, and exactly what makes a sluggish policy visible: capacity
    ordered at the band edge arrives ``spawn_delay_s`` late."""

    targets: policies.ScaleTargets = field(
        default_factory=policies.ScaleTargets)
    initial: int = 1
    decide_interval_s: float = 1.0
    spawn_delay_s: float = 2.0
    queue_wait_window: int = 256   # samples in the rolling p95 window


@dataclass(frozen=True)
class ReplicaSpec:
    """Static description of one simulated replica."""

    slots: int = 8                    # concurrent decode lanes / predict
    pages_total: int = 4096           # KV pool size, pages
    kv_bytes_per_page: int = 1 << 20  # pool bytes one page costs
    version: int = 0                  # live-weight version it serves
    speed: float = 1.0                # service-time divisor (hetero rigs)


class SimReplica:
    """Mutable per-replica simulation state (truth + last probe report)."""

    __slots__ = ("index", "spec", "up", "probe_healthy", "probe_misses",
                 "inflight", "active", "pages_free", "queue", "running",
                 "epoch", "reported_queue_depth", "reported_free_slots",
                 "reported_pages_free", "last_probe_t", "dispatched",
                 "completed", "busy_s", "breaker", "version",
                 "_breaker_state", "in_fleet", "draining")

    def __init__(self, index: int, spec: ReplicaSpec,
                 clock: Callable[[], float],
                 failure_threshold: int, recovery_s: float):
        self.index = index
        self.spec = spec
        self.up = True                 # chaos truth
        self.probe_healthy = True      # router's belief
        self.probe_misses = 0          # consecutive failed probes
        self.inflight = 0              # router-side live counter
        self.active = 0                # lanes busy (replica truth)
        self.pages_free = spec.pages_total
        self.queue: deque = deque()    # rids waiting for a lane
        self.running: Dict[int, int] = {}   # rid -> pages pinned
        self.epoch = 0                 # bumped on chaos kill
        self.reported_queue_depth = 0
        self.reported_free_slots = spec.slots
        self.reported_pages_free = spec.pages_total
        self.last_probe_t = 0.0
        self.dispatched = 0
        self.completed = 0
        self.busy_s = 0.0
        self.version = spec.version
        self.in_fleet = True           # registered with the router
        self.draining = False          # scale-down in progress
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                      recovery_s=recovery_s, clock=clock)
        self._breaker_state = BreakerState.CLOSED

    def view(self) -> ReplicaView:
        """The pick's-eye view: last probe report + live inflight.

        Mirrors ``Membership.view_of``; probe staleness needs no runtime
        ``now`` here because a down replica fails its probe (-> excluded
        as unhealthy) before its report could go stale.
        """
        return ReplicaView(
            index=self.index, healthy=self.probe_healthy,
            inflight=self.inflight, queue_depth=self.reported_queue_depth,
            decode_free_slots=self.reported_free_slots,
            decode_pages_free=self.reported_pages_free,
            kv_bytes_per_page=self.spec.kv_bytes_per_page,
            version=self.version, dispatched=self.dispatched,
            probe_misses=self.probe_misses)


@dataclass
class SimReport:
    """Everything a run produced. ``digest`` is the sha256 of the full
    event stream (computed even when ``events`` retention is off)."""

    requests: int = 0
    completed: int = 0
    rejected: int = 0
    failed_dispatches: int = 0
    reroutes: int = 0
    queue_full: int = 0
    admission_rejects: int = 0
    breaker_transitions: int = 0
    canary_promotions: int = 0
    canary_rollbacks: int = 0
    scale_ups: int = 0          # scale-up decisions taken
    scale_downs: int = 0        # scale-down decisions taken
    replacements: int = 0       # crashed replicas respawned
    final_fleet_size: int = 0   # live replicas when the run ended
    sim_time_s: float = 0.0
    wall_s: float = 0.0
    ttft_p50_ms: float = 0.0
    ttft_p95_ms: float = 0.0
    latency_p50_ms: float = 0.0
    latency_p95_ms: float = 0.0
    throughput_rps: float = 0.0
    digest: str = ""
    per_replica: List[Dict[str, Any]] = field(default_factory=list)
    events: Optional[List[str]] = None
    latencies_ms: List[float] = field(default_factory=list)
    ttfts_ms: List[float] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in (
            "requests", "completed", "rejected", "failed_dispatches",
            "reroutes", "queue_full", "admission_rejects",
            "breaker_transitions", "canary_promotions",
            "canary_rollbacks", "scale_ups", "scale_downs",
            "replacements", "final_fleet_size",
            "sim_time_s", "wall_s", "ttft_p50_ms",
            "ttft_p95_ms", "latency_p50_ms", "latency_p95_ms",
            "throughput_rps", "digest")}
        d["per_replica"] = self.per_replica
        return d


class FleetSimulator:
    """One simulation run: ``FleetSimulator(specs, trace, ...).run()``.

    Parameters
    ----------
    specs : sequence of ReplicaSpec
        The fleet. Heterogeneity (slots, pool size, bytes/page, speed)
        is the interesting case.
    trace : sequence of trace.Request
        The workload, sorted by arrival time.
    cost : CostModel
        Prices compute; see :mod:`sparkflow_tpu_torch.sim.costmodel`.
    mode : "generate" | "predict"
        Which serving plane to model: paged-KV decode (TTFT + per-token)
        or flat-latency predict.
    pick_key : callable(ReplicaView) -> tuple, optional
        Override the pick policy for what-if runs (default: the real
        ``policies.generate_pick_key`` / ``predict_pick_key``).
    admission_rate / admission_burst : float, optional
        Wire a real ``TokenBucket`` (virtual clock) at the front door.
    canary : bool
        Route through a real ``CanaryController`` (full-sort pick path).
    chaos : sequence of (t, index, "down"|"up"|("version", v))
        Scheduled replica kills/recoveries/hot-swaps.
    record_events : bool
        Retain the event log lines in the report (the digest is always
        computed).
    """

    def __init__(self, specs: Sequence[ReplicaSpec], trace: Sequence,
                 cost, *, mode: str = "generate", seed: int = 0,
                 probe_interval_s: float = 2.0,
                 pick_key: Optional[Callable[[ReplicaView], Tuple]] = None,
                 admission_rate: Optional[float] = None,
                 admission_burst: Optional[float] = None,
                 canary: bool = False,
                 canary_kwargs: Optional[Dict[str, Any]] = None,
                 chaos: Sequence[Tuple] = (),
                 autoscaler: Optional[SimAutoscaler] = None,
                 max_attempts: int = 5,
                 failure_threshold: int = 3, recovery_s: float = 2.0,
                 record_events: bool = False):
        if mode not in ("generate", "predict"):
            raise ValueError(f"mode must be generate|predict, got {mode!r}")
        if not specs:
            raise ValueError("specs must describe at least one replica")
        self.mode = mode
        self.cost = cost
        self.seed = seed
        self.probe_interval_s = float(probe_interval_s)
        self.max_attempts = int(max_attempts)
        self._now = 0.0
        clock = lambda: self._now  # noqa: E731 - the virtual clock
        self.replicas = [SimReplica(i, s, clock, failure_threshold,
                                    recovery_s)
                         for i, s in enumerate(specs)]
        self.trace = list(trace)
        self._pick_key = pick_key or (
            policies.generate_pick_key if mode == "generate"
            else policies.predict_pick_key)
        self._custom_key = pick_key is not None
        self.bucket = None
        if admission_rate is not None:
            self.bucket = TokenBucket(admission_rate,
                                      burst=admission_burst, clock=clock)
        self.canary = None
        if canary:
            kw = dict(min_requests=20, seed=seed)
            kw.update(canary_kwargs or {})
            self.canary = CanaryController(**kw)
        self.retry = RetryPolicy(max_attempts=max_attempts, base_s=0.05,
                                 multiplier=2.0, max_s=1.0, jitter=0.5,
                                 seed=seed, clock=clock,
                                 sleep=lambda _s: None)
        self.chaos = sorted(chaos, key=lambda c: (c[0], c[1]))
        self.record_events = record_events
        # elastic-fleet hook: specs are the physical pool; replicas past
        # ``initial`` start deactivated and the real scale_decision (on
        # the virtual clock) activates/drains them
        self.autoscaler = autoscaler
        self._scale_state = policies.AutoscalerState(
            desired=autoscaler.initial if autoscaler else len(self.replicas))
        self._pending_spawn: set = set()
        self._wait_samples: deque = deque(
            maxlen=autoscaler.queue_wait_window if autoscaler else 256)
        if autoscaler is not None:
            if not 0 < autoscaler.initial <= len(self.replicas):
                raise ValueError("autoscaler.initial must be within the "
                                 "physical pool size")
            for r in self.replicas[autoscaler.initial:]:
                r.in_fleet = False
        # per-request mutable state
        n = len(self.trace)
        self._attempts = [0] * n
        self._t_first = [0.0] * n
        self._t_done = [0.0] * n
        self._pages = [0] * n
        # event machinery
        self._heap: List[Tuple] = []
        self._seq = 0
        self._hash = hashlib.sha256()
        self._events: List[str] = []
        # lazy pick heap: (key, index, stamp); stale stamps are skipped
        self._pick_heap: List[Tuple] = []
        self._stamp = [0] * len(self.replicas)
        self._probe_live = [False] * len(self.replicas)
        self.report = SimReport(requests=n)

    # -- event plumbing ----------------------------------------------------

    def _push(self, t: float, kind: int, a: int = 0, b: int = 0) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, a, b))

    def _log(self, line: str) -> None:
        rec = f"{self._now:.6f} {line}"
        self._hash.update(rec.encode())
        self._hash.update(b"\n")
        if self.record_events:
            self._events.append(rec)

    def _note_breaker(self, r: SimReplica) -> None:
        st = r.breaker.state
        if st is not r._breaker_state:
            self._log(f"breaker r{r.index} "
                      f"{r._breaker_state.value}->{st.value}")
            r._breaker_state = st
            self.report.breaker_transitions += 1

    def _reindex(self, r: SimReplica) -> None:
        """Refresh one replica's pick-heap entry (its key changed)."""
        i = r.index
        self._stamp[i] += 1
        if r.probe_healthy and r.in_fleet:
            heapq.heappush(self._pick_heap,
                           (self._pick_key(r.view()), i, self._stamp[i]))

    # -- pick --------------------------------------------------------------

    def _pick(self, exclude: frozenset) -> Optional[SimReplica]:
        """Heap-argmin pick: same order as ``policies.pick_order`` under
        the active key, then the real breaker walk."""
        if self.canary is not None:
            return self._pick_full_sort(exclude)
        heap, stamp = self._pick_heap, self._stamp
        setaside = []
        found = None
        while heap:
            entry = heap[0]
            key, i, stm = entry
            r = self.replicas[i]
            if stm != stamp[i] or not r.probe_healthy or not r.in_fleet:
                heapq.heappop(heap)      # stale, dead, or drained entry
                continue
            if i in exclude:
                setaside.append(heapq.heappop(heap))
                continue
            if r.breaker.allow():
                self._note_breaker(r)
                found = r
                break
            self._note_breaker(r)
            setaside.append(heapq.heappop(heap))
        for e in setaside:
            heapq.heappush(heap, e)
        return found

    def _pick_full_sort(self, exclude: frozenset) -> Optional[SimReplica]:
        """The real router's exact path: full policy sort + canary
        filter + breaker walk. Used when canary routing is on."""
        cand = [r for r in self.replicas
                if r.in_fleet and r.index not in exclude]
        views = [r.view() for r in cand]
        if self._custom_key:
            order = [v.index for v in sorted(
                (v for v in views if v.healthy), key=self._pick_key)]
        else:
            order = policies.pick_order(views, signal=self.mode)
        by_index = {r.index: r for r in cand}
        ordered = [by_index[i] for i in order]
        if self.canary is not None:
            ordered = self.canary.filter_replicas(
                ordered, lambda r: r.version)
        for r in ordered:
            ok = r.breaker.allow()
            self._note_breaker(r)
            if ok:
                return r
        return None

    # -- request lifecycle -------------------------------------------------

    def _try_dispatch(self, rid: int) -> None:
        """One client attempt: admission, then pick+dispatch with
        same-instant reroutes (the router's in-attempt walk), then
        backoff retry or terminal rejection."""
        req = self.trace[rid]
        if self.bucket is not None and not self.bucket.try_acquire():
            self.report.admission_rejects += 1
            self._log(f"admit_reject rid={rid}")
            self._backoff_or_reject(rid)
            return
        exclude = set()
        for _ in range(len(self.replicas)):
            r = self._pick(frozenset(exclude))
            if r is None:
                break
            verdict = self._dispatch(rid, req, r)
            if verdict is None:          # accepted (running or queued)
                return
            exclude.add(r.index)
            if verdict == policies.OUTCOME_REROUTE:
                self.report.reroutes += 1
            else:
                self.report.failed_dispatches += 1
        self._backoff_or_reject(rid)

    def _backoff_or_reject(self, rid: int) -> None:
        self._attempts[rid] += 1
        att = self._attempts[rid]
        if att >= self.max_attempts:
            self.report.rejected += 1
            self._log(f"reject rid={rid} attempts={att}")
            return
        delay = self.retry.backoff(att - 1)
        self._push(self._now + delay, _RETRY, rid)

    def _dispatch(self, rid: int, req, r: SimReplica) -> Optional[str]:
        """Send one request to one replica. Returns ``None`` when the
        replica accepted it, else the ``policies`` outcome verdict."""
        if not r.up:
            # wire error: the real router classifies this FAILURE and
            # records it on the breaker
            verdict = policies.classify_outcome("", wire_error=True)
            r.breaker.record_failure()
            self._note_breaker(r)
            self._log(f"dispatch_fail rid={rid} r{r.index} {verdict}")
            return verdict
        pages = 0
        if self.mode == "generate":
            pages = self.cost.pages_for(req.prompt_tokens,
                                        req.output_tokens)
            if pages > r.pages_free:
                # replica-side admission: queue_full 503 -> reroute,
                # breaker NOT recorded (backpressure is not ill health)
                verdict = policies.classify_outcome(503, "queue_full")
                self.report.queue_full += 1
                self._log(f"queue_full rid={rid} r{r.index}")
                return verdict
            r.pages_free -= pages
        r.inflight += 1
        r.dispatched += 1
        self._pages[rid] = pages
        self._log(f"dispatch rid={rid} r{r.index}")
        if r.active < r.spec.slots:
            self._start(rid, req, r)
        else:
            r.queue.append(rid)
        self._reindex(r)
        return None

    def _start(self, rid: int, req, r: SimReplica) -> None:
        """Begin service on a free lane; schedules the finish event."""
        # queue-wait sample: arrival -> service start, the autoscaler's
        # overload signal (covers replica queueing AND client retries)
        self._wait_samples.append((self._now - req.arrival_s) * 1e3)
        before = r.active
        r.active += 1
        speed = r.spec.speed
        if self.mode == "generate":
            ttft = self.cost.ttft_s(req.prompt_tokens, before,
                                    r.spec.slots) / speed
            dur = ttft + self.cost.decode_s(req.output_tokens, before,
                                            r.spec.slots) / speed
        else:
            dur = self.cost.predict_s(before, r.spec.slots) / speed
            ttft = dur
        self._t_first[rid] = self._now + ttft
        r.running[rid] = self._pages[rid]
        r.busy_s += dur
        self._push(self._now + dur, _FINISH, rid, r.index | (r.epoch << 32))

    def _finish(self, rid: int, packed: int) -> None:
        idx, epoch = packed & 0xFFFFFFFF, packed >> 32
        r = self.replicas[idx]
        if epoch != r.epoch:
            return                      # killed by chaos; already failed
        req = self.trace[rid]
        r.active -= 1
        r.inflight = max(0, r.inflight - 1)
        r.pages_free += r.running.pop(rid, 0)
        r.completed += 1
        self._t_done[rid] = self._now
        lat_ms = (self._now - req.arrival_s) * 1e3
        self.report.completed += 1
        self.report.latencies_ms.append(lat_ms)
        self.report.ttfts_ms.append(
            (self._t_first[rid] - req.arrival_s) * 1e3)
        r.breaker.record_success()
        self._note_breaker(r)
        if self.canary is not None:
            self.canary.observe(r.version, True, latency_ms=lat_ms)
        self._log(f"finish rid={rid} r{idx} lat_ms={lat_ms:.3f}")
        if r.queue:
            nxt = r.queue.popleft()
            self._start(nxt, self.trace[nxt], r)
        if r.draining and r.active == 0 and not r.queue:
            r.draining = False
            self._log(f"scale_down_complete r{idx}")
        self._reindex(r)

    # -- probes and chaos --------------------------------------------------

    def _probe(self, idx: int) -> None:
        r = self.replicas[idx]
        if not r.in_fleet:
            # deregistered (drained): the probe chain dies; a respawn
            # restarts it — mirrors Membership.deregister cancelling probes
            self._probe_live[idx] = False
            return
        if r.up:
            was = r.probe_healthy
            r.probe_healthy = True
            r.probe_misses = 0
            r.reported_queue_depth = len(r.queue)
            r.reported_free_slots = max(0, r.spec.slots - r.active)
            r.reported_pages_free = r.pages_free
            r.last_probe_t = self._now
            if not was:
                self._log(f"probe_recover r{idx}")
            self._reindex(r)
        else:
            if r.probe_healthy:
                self._log(f"probe_fail r{idx}")
            r.probe_healthy = False
            r.probe_misses += 1
            self._stamp[idx] += 1       # drop its pick-heap entry
        self._push(self._now + self.probe_interval_s, _PROBE, idx)

    def _chaos(self, idx: int, action) -> None:
        r = self.replicas[idx]
        if isinstance(action, tuple) and action[0] == "version":
            r.version = int(action[1])
            self._log(f"chaos r{idx} version={r.version}")
            self._reindex(r)
            return
        if action == "down":
            r.up = False
            r.epoch += 1
            self._log(f"chaos r{idx} down "
                      f"killed={len(r.running) + len(r.queue)}")
            victims = list(r.running) + list(r.queue)
            r.running.clear()
            r.queue.clear()
            r.active = 0
            r.inflight = 0
            r.pages_free = r.spec.pages_total
            for rid in victims:
                # each broken connection is a recorded failure, and the
                # client re-enters through the retry path
                r.breaker.record_failure()
                self._note_breaker(r)
                self.report.failed_dispatches += 1
                self._push(self._now + self.cost.net_rtt_ms / 1e3,
                           _RETRY, rid)
            # the router does NOT know yet: the replica stays pickable
            # (and fails at the wire, feeding the breaker) until its next
            # probe marks it unhealthy — exactly the production window
            self._reindex(r)
        elif action == "up":
            r.up = True
            self._log(f"chaos r{idx} up")
        else:
            raise ValueError(f"unknown chaos action {action!r}")

    # -- elastic scaling ---------------------------------------------------

    def _scale_tick(self) -> None:
        """One autoscaler decision on the virtual clock: build views of
        the registered fleet, run the REAL ``policies.scale_decision``,
        apply the action. Mirrors ``Autoscaler.tick``'s overlays: a
        breaker-OPEN replica is dead to the policy past the probe-miss
        debounce (detection at request cadence, not probe cadence), and a
        spawn already in flight counts as live-but-booting capacity — the
        real autoscaler spawns synchronously inside its tick, so without
        the synthetic view every tick during ``spawn_delay_s`` would
        re-order the same deficit and overshoot the target."""
        a = self.autoscaler
        views = []
        for r in self.replicas:
            if not r.in_fleet or r.index in self._pending_spawn:
                continue
            v = r.view()
            if r.breaker.state is BreakerState.OPEN:
                v = replace(v, healthy=False,
                            probe_misses=max(v.probe_misses,
                                             a.targets.dead_after_misses))
            views.append(v)
        for i in sorted(self._pending_spawn):
            spec = self.replicas[i].spec
            views.append(ReplicaView(
                index=i, healthy=True,
                decode_free_slots=spec.slots,
                decode_pages_free=spec.pages_total,
                kv_bytes_per_page=spec.kv_bytes_per_page))
        wait = (policies.percentile_nearest_rank(
                    list(self._wait_samples), 95.0)
                if self._wait_samples else None)
        action = policies.scale_decision(views, a.targets,
                                         self._scale_state, self._now,
                                         queue_wait_p95_ms=wait)
        self._scale_state = action.state
        if action.kind == policies.SCALE_REPLACE:
            for idx in action.targets:
                if idx in self._pending_spawn:
                    continue
                self._pending_spawn.add(idx)
                self.report.replacements += 1
                self._log(f"scale replace r{idx} ({action.reason})")
                self._push(self._now + a.spawn_delay_s, _SPAWN, idx)
        elif action.kind == policies.SCALE_UP:
            spare = [r.index for r in self.replicas
                     if not r.in_fleet and not r.draining
                     and r.index not in self._pending_spawn]
            took = spare[:action.count]
            if took:
                self.report.scale_ups += 1
                self._log(f"scale up +{len(took)} {took} "
                          f"({action.reason})")
            for idx in took:
                self._pending_spawn.add(idx)
                self._push(self._now + a.spawn_delay_s, _SPAWN, idx)
        elif action.kind == policies.SCALE_DOWN:
            self.report.scale_downs += 1
            for idx in action.targets:
                r = self.replicas[idx]
                r.in_fleet = False       # deregister: out of the pick now
                r.draining = r.active > 0 or bool(r.queue)
                self._stamp[idx] += 1    # drop its pick-heap entry
                self._log(f"scale down r{idx} draining={r.draining} "
                          f"({action.reason})")
        self._push(self._now + a.decide_interval_s, _SCALE)

    def _spawned(self, idx: int) -> None:
        """Spawn complete after ``spawn_delay_s``: the replica boots (or
        reboots, for a crash replacement) into a clean serving state and
        registers with the fleet."""
        r = self.replicas[idx]
        self._pending_spawn.discard(idx)
        r.up = True
        r.in_fleet = True
        r.draining = False
        r.probe_healthy = True
        r.probe_misses = 0
        # a replacement is a NEW process in production: its breaker starts
        # CLOSED, so the respawned slot must not stay dead to the policy
        r.breaker.record_success()
        self._note_breaker(r)
        r.active = 0
        r.inflight = 0
        r.queue.clear()
        r.running.clear()
        r.pages_free = r.spec.pages_total
        r.reported_queue_depth = 0
        r.reported_free_slots = r.spec.slots
        r.reported_pages_free = r.spec.pages_total
        r.last_probe_t = self._now
        self._log(f"spawned r{idx}")
        self._reindex(r)
        if not self._probe_live[idx]:
            self._probe_live[idx] = True
            self._push(self._now + self.probe_interval_s, _PROBE, idx)

    # -- run ---------------------------------------------------------------

    def run(self) -> SimReport:
        wall0 = time.monotonic()
        # prime: first probe per replica, staggered so reports do not
        # refresh in lockstep (mirrors independent probe loops)
        nrep = len(self.replicas)
        for r in self.replicas:
            if not r.in_fleet:
                continue                 # deactivated pool slot
            self._reindex(r)
            self._probe_live[r.index] = True
            self._push((r.index + 1) * self.probe_interval_s / (nrep + 1),
                       _PROBE, r.index)
        if self.autoscaler is not None:
            self._push(self.autoscaler.decide_interval_s, _SCALE)
        for rid, req in enumerate(self.trace):
            self._push(req.arrival_s, _ARRIVE, rid)
        for t, idx, action in self.chaos:
            self._seq += 1
            heapq.heappush(self._heap, (t, self._seq, _CHAOS, idx, action))
        heap = self._heap
        rep = self.report
        total = rep.requests
        while heap and rep.completed + rep.rejected < total:
            t, _seq, kind, a, b = heapq.heappop(heap)
            self._now = t
            if kind == _ARRIVE or kind == _RETRY:
                self._try_dispatch(a)
            elif kind == _FINISH:
                self._finish(a, b)
            elif kind == _PROBE:
                self._probe(a)
            elif kind == _CHAOS:
                self._chaos(a, b)
            elif kind == _SCALE:
                self._scale_tick()
            elif kind == _SPAWN:
                self._spawned(a)
        self._finalize(time.monotonic() - wall0)
        return self.report

    def _finalize(self, wall_s: float) -> None:
        rep = self.report
        rep.sim_time_s = self._now
        rep.wall_s = wall_s
        rep.final_fleet_size = sum(1 for r in self.replicas if r.in_fleet)
        lat = sorted(rep.latencies_ms)
        ttft = sorted(rep.ttfts_ms)
        rep.latency_p50_ms = policies.percentile_nearest_rank(lat, 50.0)
        rep.latency_p95_ms = policies.percentile_nearest_rank(lat, 95.0)
        rep.ttft_p50_ms = policies.percentile_nearest_rank(ttft, 50.0)
        rep.ttft_p95_ms = policies.percentile_nearest_rank(ttft, 95.0)
        if self._now > 0:
            rep.throughput_rps = rep.completed / self._now
        if self.canary is not None:
            stats = self.canary.stats()
            rep.canary_promotions = stats.get("promotions", 0)
            rep.canary_rollbacks = stats.get("rollbacks", 0)
        for r in self.replicas:
            util = (r.busy_s / (r.spec.slots * self._now)
                    if self._now > 0 else 0.0)
            rep.per_replica.append({
                "index": r.index, "dispatched": r.dispatched,
                "completed": r.completed, "busy_s": round(r.busy_s, 6),
                "utilization": round(util, 6),
                "kv_bytes_per_page": r.spec.kv_bytes_per_page,
                "pages_total": r.spec.pages_total,
                "breaker": r.breaker.state.value})
        rep.digest = self._hash.hexdigest()
        if self.record_events:
            rep.events = self._events
