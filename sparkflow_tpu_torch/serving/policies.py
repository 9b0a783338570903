# graftcheck: pure-policy
"""Pure fleet policies: every routing/health/gate *decision*, no transport
— carried unchanged from the JAX package's ``serving/policies.py``.

The fleet-scale simulator (:mod:`sparkflow_tpu_torch.sim`) replays million-request
traces against the SAME policy code the live router runs — which is only
sound if the policies are deterministic functions of observed state. This
module is that contract, enforced by graftcheck rule **GC-S501**
(impure-policy): nothing here may read a wall clock, draw randomness, sleep,
or touch sockets/files. Time arrives as a ``now`` argument; randomness
arrives pre-drawn (``prefer_canary`` is a bool the caller rolled); state
arrives as frozen snapshots (:class:`ReplicaView`, :class:`VersionStats`).

The serving plane (``membership.py`` / ``router.py``) and the simulator
(``sim/core.py``) both call these functions — the HTTP stack supplies
``time.monotonic`` snapshots and live counters, the simulator supplies a
virtual clock and modelled replicas, and the decisions are identical by
construction (pinned by the parity tests in ``tests/test_torch_policies.py``,
which also hold every decision equal to the JAX package's).

Decisions covered
-----------------
- :func:`pick_order` / :func:`predict_pick_key` / :func:`generate_pick_key`
  — least-loaded replica ranking, with the least-served tie-break
  (equal-load ties go to the replica with the fewest cumulative dispatches
  instead of always the lowest index — the bias the deterministic replay
  exposed) and the **inflight-debited byte-headroom** generate rule that
  predicts KV exhaustion from stale probe reports before the replica
  sheds (found in sim, confirmed on a live fleet).
- :func:`classify_outcome` — what one dispatch outcome means: success,
  eject-and-reroute (draining), reroute-without-breaker (overload),
  breaker-feeding failure (5xx/wire error), or authoritative client error.
- :func:`canary_gate` / :func:`canary_reorder` — the promote/rollback/
  continue verdict over per-version stats and the version-aware reorder of
  a load-sorted candidate list.
- :func:`token_bucket_admit` — the admission refill/spend arithmetic.
- :func:`probe_is_stale` — whether a replica's load report is too old to
  trust (its decision half lives here; reading the clock stays the
  caller's job).
- :func:`scale_decision` / :func:`scale_down_order` — the elastic-fleet
  control law: crash replacement first, then hysteresis-banded scale
  up/down with cooldowns and min/max bounds. The live
  :class:`~sparkflow_tpu_torch.serving.autoscaler.Autoscaler` and the
  simulator's ``SimAutoscaler`` hook run the SAME function, so the
  policy is tuned against deterministic traffic steps before it ever
  spawns a real process.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ReplicaView", "VersionStats", "OUTCOME_SUCCESS", "OUTCOME_EJECT",
    "OUTCOME_REROUTE", "OUTCOME_FAILURE", "OUTCOME_CLIENT_ERROR",
    "GATE_CONTINUE", "GATE_PROMOTE", "GATE_ROLLBACK",
    "predict_pick_key", "generate_pick_key", "pick_order",
    "classify_outcome", "canary_gate", "canary_reorder",
    "token_bucket_admit", "probe_is_stale", "percentile_nearest_rank",
    "ScaleTargets", "AutoscalerState", "ScaleAction",
    "SCALE_HOLD", "SCALE_UP", "SCALE_DOWN", "SCALE_REPLACE",
    "scale_decision", "scale_down_order",
]


@dataclass(frozen=True)
class ReplicaView:
    """Frozen snapshot of one replica's observed state — the ONLY replica
    shape policies see. ``Membership`` builds these under its lock from
    live :class:`~sparkflow_tpu_torch.serving.membership.Replica` records; the
    simulator builds them from modelled replicas."""

    index: int
    healthy: bool = True
    inflight: int = 0
    queue_depth: int = 0
    decode_free_slots: int = -1
    decode_pages_free: int = -1
    kv_bytes_per_page: int = -1
    version: int = -1
    dispatched: int = 0  # cumulative dispatches ever sent to this replica
    # consecutive failed health probes (0 while probes pass). The scaling
    # policy declares a replica dead only past ScaleTargets.dead_after_misses
    # — a single miss is most likely the replica saturated, not gone.
    # Definitive death evidence (exit-code reap, breaker OPEN) is overlaid
    # by the autoscaler as misses >= the threshold.
    probe_misses: int = 0
    # does a supervisor own this replica's process? Unmanaged (founding-
    # fleet) replicas can be routed around but never destroyed, drained,
    # or deregistered by the autoscaler — there is no process handle to
    # respawn, and a transient probe failure must not permanently evict
    # a replica that would re-admit on recovery.
    managed: bool = True

    @property
    def free_kv_bytes(self) -> int:
        """Effective decode byte headroom: pages_free weighted by the
        replica's bytes-per-page (unknown byte figure weights 1, so a fleet
        that never reports bytes ranks by raw pages exactly as before)."""
        if self.decode_pages_free <= 0:
            return self.decode_pages_free
        bpp = self.kv_bytes_per_page if self.kv_bytes_per_page > 0 else 1
        return self.decode_pages_free * bpp


def predict_pick_key(view: ReplicaView) -> Tuple:
    """Sort key for predict dispatch: router-side in-flight, then the
    replica-reported queue depth, then the **least-served** tie-break
    (cumulative dispatches, then index).

    The old tie-break was the bare index: an idle or perfectly balanced
    fleet sent EVERY tied pick to replica 0 — deterministic replay in the
    simulator showed replica 0 absorbing the whole head of each burst
    while the tail idled. Tie-breaking on the cumulative dispatch count is
    self-balancing (the tied replica that has served least wins, and
    serving bumps its count past its peers), deterministic, and — unlike a
    rotating counter — a pure function of the view, so an incremental
    argmin structure (the simulator's lazy heap) only re-keys the one
    replica that changed."""
    return (view.inflight, view.queue_depth, view.dispatched, view.index)


# Pages one live stream is assumed to consume beyond the last probe
# report (the debit below). 32 pages x 16-token pages = a ~512-token
# prompt+completion — the workload median, not the tail; the debit is a
# steering signal, the replica's own admission is the hard limit.
EST_PAGES_PER_STREAM = 32


def generate_pick_key(view: ReplicaView,
                      est_pages_per_stream: int = EST_PAGES_PER_STREAM
                      ) -> Tuple:
    """Sort key for generate (decode) dispatch: least-loaded with
    **inflight-debited byte headroom**.

    Ranks by (starved, inflight, -effective-free-bytes, least-served
    tie) — queue depth is deliberately NOT a generate signal (the decode
    plane's own slot/page figures say more than the predict-plane queue)
    — where the effective headroom debits the *stale* probe report by
    the router's *live* in-flight count:

    ``eff_pages = decode_pages_free - est_pages_per_stream * inflight``

    - ``starved``: zero free pages or slots — or an effective headroom
      debited to <= 0 — sorts last outright (still dispatchable as a
      final resort: the replica's own 503 is the real backpressure).
    - The probe report is up to a probe interval old; every dispatch the
      router sent since then is eating pages the report still shows as
      free. Deterministic trace replay in the simulator showed the
      undebited rule happily piling bursts onto replicas whose pools had
      already paged out, then paying a queue_full reroute storm per
      burst; the debit predicts exhaustion *before* the replica sheds
      (sim: fewer queue_full reroutes and 30-70% lower p95 across
      homogeneous and mixed-pool fleets; confirmed on a live fleet).
    - ``-eff_bytes`` (debited pages weighted by the replica's
      ``kv_bytes_per_page``) breaks equal-inflight ties toward the pool
      with the most remaining capacity, so heterogeneous bf16/int8
      fleets fill proportionally.
    - Replicas with unknown headroom (no decode plane probed yet) keep
      their raw figure as the tie value — after known-positive headroom
      at equal load, exactly as before.
    """
    starved = 1 if (view.decode_pages_free == 0
                    or view.decode_free_slots == 0) else 0
    pages = view.decode_pages_free
    if pages > 0:
        eff = pages - est_pages_per_stream * view.inflight
        if eff <= 0:
            starved = 1
        bpp = (view.kv_bytes_per_page if view.kv_bytes_per_page > 0
               else 1)
        eff_bytes = eff * bpp
    else:
        eff_bytes = pages   # unknown (-1) / zero: passthrough, as before
    return (starved, view.inflight, -eff_bytes, view.dispatched,
            view.index)


def pick_order(views: Sequence[ReplicaView], signal: str = "predict"
               ) -> List[int]:
    """Full dispatch preference order (healthy views only) as a list of
    ``view.index`` values, best first. The caller walks it until a breaker
    admits one — breaker state is live/mutable, so consulting it stays
    outside the pure layer."""
    key = generate_pick_key if signal == "generate" else predict_pick_key
    return [v.index for v in sorted((v for v in views if v.healthy),
                                    key=key)]


# -- dispatch-outcome classification -----------------------------------------

OUTCOME_SUCCESS = "success"            # 200: record_success
OUTCOME_EJECT = "eject"                # draining 503: eject now, reroute
OUTCOME_REROUTE = "reroute"            # overload 503: reroute, no breaker
OUTCOME_FAILURE = "failure"            # 5xx / wire error: feed the breaker
OUTCOME_CLIENT_ERROR = "client_error"  # 4xx: authoritative, pass through


def classify_outcome(status: Optional[int], error_code: str = "",
                     wire_error: bool = False) -> str:
    """What one dispatch outcome means for membership/retry bookkeeping.

    ``status`` is the HTTP status (None with ``wire_error=True`` for a
    connection-level failure), ``error_code`` the structured error code
    from the body. The verdicts map 1:1 onto the router's historical
    behavior: draining 503s eject immediately; queue_full 503s reroute
    without feeding the breaker (overloaded, not broken — least-loaded
    pick already steers away); other 5xx and wire errors count against
    the breaker; 4xx is the client's problem."""
    if wire_error:
        return OUTCOME_FAILURE
    if status == 200:
        return OUTCOME_SUCCESS
    if status == 503 and error_code == "draining":
        return OUTCOME_EJECT
    if status == 503:
        return OUTCOME_REROUTE
    if status is None or status >= 500:
        return OUTCOME_FAILURE
    return OUTCOME_CLIENT_ERROR


# -- canary gate -------------------------------------------------------------

GATE_CONTINUE = "continue"
GATE_PROMOTE = "promote"
GATE_ROLLBACK = "rollback"


@dataclass(frozen=True)
class VersionStats:
    """Per-version outcome counters the canary gate judges over."""

    requests: int = 0
    errors: int = 0
    nans: int = 0
    latencies_ms: Tuple[float, ...] = field(default_factory=tuple)

    @property
    def error_rate(self) -> float:
        return self.errors / self.requests if self.requests else 0.0

    @property
    def latency_p95(self) -> float:
        return percentile_nearest_rank(self.latencies_ms, 95.0)


def percentile_nearest_rank(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile matching the canary gate's historical p95
    (``sorted[min(n-1, round(q/100 * (n-1)))]``); 0.0 on no samples."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))]


def canary_gate(canary: VersionStats, incumbent: Optional[VersionStats], *,
                min_requests: int, error_rate_margin: float,
                latency_factor: float, latency_floor_ms: float
                ) -> Tuple[str, str]:
    """Judge a canary version against the incumbent: ``(verdict, reason)``
    where verdict is GATE_CONTINUE / GATE_PROMOTE / GATE_ROLLBACK.

    The order of checks is the contract (pinned by the parity tests):
    any NaN/Inf rolls back instantly; before ``min_requests`` the trial
    continues; an error rate exceeding the incumbent's by more than
    ``error_rate_margin`` rolls back; a latency p95 above
    ``max(latency_floor_ms, latency_factor x incumbent p95)`` rolls back
    (skipped while the incumbent has no latency history); otherwise the
    canary promotes."""
    if canary.nans:
        return GATE_ROLLBACK, "NaN/Inf outputs"
    if canary.requests < min_requests:
        return GATE_CONTINUE, (f"{canary.requests}/{min_requests} "
                               f"requests observed")
    inc_err = incumbent.error_rate if incumbent is not None else 0.0
    err = canary.error_rate
    if err > inc_err + error_rate_margin:
        return GATE_ROLLBACK, (f"error rate {err:.3f} vs incumbent "
                               f"{inc_err:.3f}")
    inc_p95 = incumbent.latency_p95 if incumbent is not None else 0.0
    if inc_p95 > 0.0:
        p95 = canary.latency_p95
        bar = max(latency_floor_ms, latency_factor * inc_p95)
        if p95 > bar:
            return GATE_ROLLBACK, f"latency p95 {p95:.1f}ms > {bar:.1f}ms"
    return GATE_PROMOTE, "healthy at min_requests"


def canary_reorder(indices: Sequence[int], versions: Dict[int, int],
                   canary: Optional[int], quarantined: frozenset,
                   prefer_canary: bool) -> List[int]:
    """Version-aware reorder of a load-sorted candidate list (indices into
    the fleet, best first). Quarantined versions are dropped outright —
    zero post-gate traffic, an all-quarantined fleet yields ``[]`` and the
    router 503s rather than serve bad weights. With a canary under trial,
    ``prefer_canary`` (the caller's pre-drawn ~``canary_fraction`` coin)
    puts the canary group first, else last; relative load order inside
    each group is preserved."""
    live = [i for i in indices if versions.get(i, -1) not in quarantined]
    if canary is None:
        return live
    cgroup = [i for i in live if versions.get(i, -1) == canary]
    rest = [i for i in live if versions.get(i, -1) != canary]
    if not cgroup or not rest:
        return live
    return cgroup + rest if prefer_canary else rest + cgroup


# -- admission ---------------------------------------------------------------

def token_bucket_admit(tokens: float, last: float, now: float, *,
                       rate: float, burst: float, n: float = 1.0
                       ) -> Tuple[bool, float, float]:
    """One token-bucket admission decision: refill from ``last`` to ``now``
    at ``rate`` (capped at ``burst``), spend ``n`` if available. Returns
    ``(admitted, tokens_after, now)`` — the caller stores the last two as
    the bucket's new state under its own lock."""
    tokens = min(burst, tokens + (now - last) * rate)
    if tokens >= n:
        return True, tokens - n, now
    return False, tokens, now


# -- probe staleness ---------------------------------------------------------

def probe_is_stale(last_probe_t: float, now: float,
                   probe_interval_s: float, factor: float = 3.0) -> bool:
    """Is a replica's probed load report too old to trust? True once the
    report is older than ``factor`` probe intervals (a wedged prober must
    not freeze stale 'idle' load figures into the pick forever). A replica
    never probed (``last_probe_t <= 0``) is not stale — optimistic until
    the first report, matching the historical bootstrap behavior."""
    if last_probe_t <= 0.0:
        return False
    return (now - last_probe_t) > factor * probe_interval_s


# -- elastic scaling ----------------------------------------------------------

SCALE_HOLD = "hold"        # inside the band / cooling down: do nothing
SCALE_UP = "up"            # queue wait above the high band: add replicas
SCALE_DOWN = "down"        # queue wait below the low band: drain replicas
SCALE_REPLACE = "replace"  # a replica died: respawn it, bypassing cooldowns


@dataclass(frozen=True)
class ScaleTargets:
    """The autoscaler's tuning knobs — the full control law is a function
    of these plus the observed fleet, so an A/B in the simulator is just
    two ``ScaleTargets`` values replayed over the same trace.

    The hysteresis band ``(queue_wait_low_ms, queue_wait_high_ms)`` is the
    do-nothing region: scale up only above the high edge, down only below
    the low edge. A single threshold oscillates — the capacity added at
    the threshold drops queue wait just below it, which immediately votes
    to scale down again; the band plus per-direction cooldowns is the
    classic damping."""

    min_replicas: int = 1
    max_replicas: int = 8
    queue_wait_high_ms: float = 200.0   # above: under-provisioned
    queue_wait_low_ms: float = 50.0     # below: over-provisioned
    up_cooldown_s: float = 10.0         # min gap between scale-ups
    down_cooldown_s: float = 60.0       # min gap between scale-downs
    max_step_up: int = 2                # replicas added per decision, cap
    starved_fraction_up: float = 0.5    # fleet starvation scale-up trigger
    # consecutive probe misses before an unhealthy view counts as DEAD
    # (replace/refill) rather than SUSPECT (hold). Probe timeouts are most
    # likely exactly when the replica is saturated, so acting on a single
    # miss turns the autoscaler into a load-correlated failure amplifier —
    # it would kill capacity during the overload that made the probe slow.
    dead_after_misses: int = 3


@dataclass(frozen=True)
class AutoscalerState:
    """What the control law remembers between decisions: the current
    desired size and when it last moved in each direction (cooldowns are
    judged against these, so a replacement — which doesn't change
    ``desired`` — never resets them)."""

    desired: int = 1
    last_up_t: float = float("-inf")
    last_down_t: float = float("-inf")


@dataclass(frozen=True)
class ScaleAction:
    """One decision: ``kind`` is SCALE_HOLD/UP/DOWN/REPLACE, ``count`` how
    many replicas to add (up/replace) or drain (down), ``targets`` the
    view indices to act on (dead indices for replace, drain order for
    down, empty for up — the supervisor picks ports), ``state`` the
    successor :class:`AutoscalerState`, ``reason`` a human-readable why."""

    kind: str
    count: int = 0
    targets: Tuple[int, ...] = ()
    state: "AutoscalerState" = field(default_factory=lambda: AutoscalerState())
    reason: str = ""


def scale_down_order(views: Sequence[ReplicaView]) -> List[int]:
    """Drain preference order for scale-down, best victim first: the
    replica with zero in-flight generate slots drains free, a busy decode
    replica drains last (its streams must finish before the process can
    exit, holding the scale-down open). Ranks by (inflight, queue_depth,
    -index) — the index tie-break prefers the HIGHEST index so a fleet
    that scaled 0..n-1 up shrinks from the top, keeping the stable core
    at low indices (and keeping the order deterministic for replay)."""
    return [v.index for v in
            sorted(views, key=lambda v: (v.inflight, v.queue_depth,
                                         -v.index))]


def scale_decision(views: Sequence[ReplicaView], targets: ScaleTargets,
                   state: AutoscalerState, now: float, *,
                   queue_wait_p95_ms: Optional[float] = None) -> ScaleAction:
    """One tick of the elastic-fleet control law. Priority order is the
    contract (pinned by the fake-clock units in ``tests/test_torch_autoscaler.py``):

    1. **Crash replacement** — DEAD managed views are respawned
       immediately, bypassing both cooldowns and (if the fleet is at max)
       the size check: a replacement restores capacity the fleet already
       decided it needs, it is not growth. Dead means *debounced* dead:
       ``probe_misses >= targets.dead_after_misses`` (the autoscaler
       overlays definitive evidence — exit-code reap, breaker OPEN — as
       misses past the threshold). An unhealthy view below the threshold
       is a SUSPECT: it still counts as capacity and nothing is killed —
       a probe timeout is most likely the replica saturated, and killing
       it would amplify the very overload that slowed the probe.
       Unmanaged views are NEVER replace targets (no process handle to
       respawn; a recovered probe re-admits them); one past the threshold
       simply stops counting as capacity, so the below-min rule refills
       the fleet with fresh managed replicas around it.
    2. **Below-min catch-up** — fewer presumed-alive replicas (healthy +
       suspects) than ``min_replicas`` scales up without cooldown (the
       floor is a hard bound, not a preference).
    3. **Scale up** — queue-wait p95 above the high band edge, or a
       ``starved_fraction_up`` share of the live fleet starved (zero free
       decode slots/pages), adds ``ceil``-style capacity: one replica per
       full band-multiple of overshoot, capped at ``max_step_up`` and
       ``max_replicas``, gated on ``up_cooldown_s``.
    4. **Scale down** — queue-wait p95 below the low band edge (and no
       starvation) drains ONE replica per decision — the
       :func:`scale_down_order` victim among MANAGED live views (an
       unmanaged replica cannot be drained, and electing one would burn
       the down-cooldown on a no-op) — gated on ``down_cooldown_s`` since
       the last move in EITHER direction (shrinking right after growing
       is the oscillation the band exists to prevent), floored at
       ``min_replicas``.
    5. **Hold** otherwise.

    ``queue_wait_p95_ms`` is None when the histogram has no samples yet
    (idle fleet): treated as 0 for the down path so an idle oversized
    fleet does shrink, and as no-signal for the up path."""
    threshold = max(1, targets.dead_after_misses)
    live = [v for v in views if v.healthy]
    dead = tuple(v.index for v in views
                 if v.managed and not v.healthy
                 and v.probe_misses >= threshold)
    # unhealthy but under the miss threshold (either ownership): presumed
    # returning, counts as capacity, never acted on this tick
    suspects = [v for v in views
                if not v.healthy and v.probe_misses < threshold]
    fleet = len(live) + len(suspects)

    if dead:
        return ScaleAction(SCALE_REPLACE, count=len(dead), targets=dead,
                           state=state,
                           reason=f"{len(dead)} replica(s) down")

    if fleet < targets.min_replicas:
        n = targets.min_replicas - fleet
        return ScaleAction(
            SCALE_UP, count=n,
            state=AutoscalerState(desired=fleet + n,
                                  last_up_t=now,
                                  last_down_t=state.last_down_t),
            reason=f"below min_replicas ({fleet} < "
                   f"{targets.min_replicas})")

    starved = sum(1 for v in live
                  if v.decode_free_slots == 0 or v.decode_pages_free == 0)
    fleet_starved = (len(live) > 0 and
                     starved >= targets.starved_fraction_up * len(live))
    wait = queue_wait_p95_ms
    overloaded = (wait is not None and wait > targets.queue_wait_high_ms)

    if (overloaded or fleet_starved) and fleet < targets.max_replicas:
        if now - state.last_up_t < targets.up_cooldown_s:
            return ScaleAction(SCALE_HOLD, state=state,
                               reason="up-cooldown")
        if overloaded:
            # one replica per full band-width of overshoot: a 2x step in
            # queue wait asks for proportionally more capacity than a 5%
            # drift over the edge, without a model of service rate
            band = max(targets.queue_wait_high_ms, 1e-9)
            step = 1 + int((wait - targets.queue_wait_high_ms) / band)
        else:
            step = 1
        step = min(step, targets.max_step_up,
                   targets.max_replicas - fleet)
        why = (f"queue wait p95 {wait:.0f}ms > "
               f"{targets.queue_wait_high_ms:.0f}ms" if overloaded
               else f"{starved}/{len(live)} replicas starved")
        return ScaleAction(
            SCALE_UP, count=step,
            state=AutoscalerState(desired=fleet + step,
                                  last_up_t=now,
                                  last_down_t=state.last_down_t),
            reason=why)

    idle_wait = wait if wait is not None else 0.0
    candidates = [v for v in live if v.managed]
    if (idle_wait < targets.queue_wait_low_ms and not fleet_starved
            and len(live) > targets.min_replicas and candidates):
        ref = max(state.last_down_t, state.last_up_t)
        if now - ref < targets.down_cooldown_s:
            return ScaleAction(SCALE_HOLD, state=state,
                               reason="down-cooldown")
        victim = scale_down_order(candidates)[0]
        return ScaleAction(
            SCALE_DOWN, count=1, targets=(victim,),
            state=AutoscalerState(desired=len(live) - 1,
                                  last_up_t=state.last_up_t,
                                  last_down_t=now),
            reason=f"queue wait p95 {idle_wait:.0f}ms < "
                   f"{targets.queue_wait_low_ms:.0f}ms")

    return ScaleAction(SCALE_HOLD, state=state, reason="in band")
