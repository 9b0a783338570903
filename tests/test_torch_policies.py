"""PyTorch port, ``serving/policies.py``: the JAX suite's policy cases run
on the port's carried copy, and seeded fleets get the same decisions from
both packages' ``pick_order``, ``scale_decision`` and ``canary_gate``.

The cases below are the JAX suite's (``tests/test_policies.py``): the pure
functions in ``serving/policies.py`` make exactly the decisions the serving
plane historically made.

These tests pin the refactor seam. ``membership.pick`` / the router's
outcome handling / the canary gate / token-bucket admission all delegate
to ``policies`` now; each test here states the historical decision table
directly against the pure function, and the integration tests in
``test_torch_router.py`` keep pinning the same behavior through the HTTP stack
— if the two ever disagree, the seam leaked.
"""

import random

import pytest

from sparkflow_tpu.serving import policies as jax_policies

from sparkflow_tpu_torch.serving import policies
from sparkflow_tpu_torch.serving.membership import Membership
from sparkflow_tpu_torch.serving.policies import ReplicaView, VersionStats
from sparkflow_tpu_torch.serving.router import TokenBucket


def view(i, **kw):
    return ReplicaView(index=i, **kw)


# -- pick order --------------------------------------------------------------


def test_predict_pick_least_loaded_then_queue_depth():
    views = [view(0, inflight=2), view(1, inflight=0, queue_depth=3),
             view(2, inflight=0, queue_depth=1)]
    assert policies.pick_order(views, signal="predict") == [2, 1, 0]


def test_pick_order_excludes_unhealthy():
    views = [view(0, healthy=False), view(1, inflight=5), view(2,
             healthy=False)]
    assert policies.pick_order(views, signal="predict") == [1]
    assert policies.pick_order(views, signal="generate") == [1]


def test_predict_tie_break_least_served_then_index():
    # equal load: the replica that has served least wins — NOT always the
    # lowest index (the bias deterministic replay exposed); equal service
    # falls back to the index
    views = [view(0, dispatched=7), view(1, dispatched=2),
             view(2, dispatched=7)]
    assert policies.pick_order(views, signal="predict") == [1, 0, 2]


def test_generate_pick_ranks_by_debited_byte_headroom():
    # equal inflight: more effective free KV bytes wins; bytes-per-page
    # weights pages (int8 pool with more pages can beat a bigger-paged
    # bf16 pool and vice versa)
    views = [view(0, decode_pages_free=10, kv_bytes_per_page=4,
                  decode_free_slots=2),
             view(1, decode_pages_free=30, kv_bytes_per_page=2,
                  decode_free_slots=2)]
    assert policies.pick_order(views, signal="generate") == [1, 0]


def test_generate_pick_starved_sorts_last_not_dropped():
    views = [view(0, decode_pages_free=0, decode_free_slots=2),
             view(1, decode_pages_free=8, decode_free_slots=0),
             view(2, decode_pages_free=8, decode_free_slots=2)]
    # both starved replicas stay dispatchable, after the healthy one;
    # within the starved group remaining byte headroom still orders them
    assert policies.pick_order(views, signal="generate") == [2, 1, 0]


def test_generate_pick_unknown_headroom_after_known():
    views = [view(0, decode_pages_free=-1), view(1, decode_pages_free=16)]
    assert policies.pick_order(views, signal="generate") == [1, 0]


def test_generate_pick_queue_depth_is_not_a_signal():
    # the decode plane's own figures outrank the predict-plane queue
    views = [view(0, decode_pages_free=40, queue_depth=50),
             view(1, decode_pages_free=10, queue_depth=0)]
    assert policies.pick_order(views, signal="generate") == [0, 1]


def test_generate_pick_inflight_debits_stale_page_report():
    # the sim-found improvement: a burst of live dispatches debits the
    # stale probe report; a replica whose report still says "plenty free"
    # but already absorbed inflight >= report/est sorts as starved
    est = policies.EST_PAGES_PER_STREAM
    fresh = view(0, decode_pages_free=4 * est, inflight=0)
    bursted = view(1, decode_pages_free=4 * est, inflight=5)
    assert policies.generate_pick_key(bursted)[0] == 1   # debited starved
    assert policies.generate_pick_key(fresh)[0] == 0
    assert policies.pick_order([fresh, bursted],
                               signal="generate") == [0, 1]


def test_membership_pick_matches_policy_order():
    # the seam itself: Membership.pick walks exactly policies.pick_order
    # over its own views
    m = Membership([f"http://127.0.0.1:{p}" for p in (1, 2, 3)],
                   probe_interval_s=60.0)
    ra, rb, rc = m.replicas
    ra.inflight, rb.inflight, rc.inflight = 2, 0, 1
    views = [m.view_of(r) for r in m.replicas]
    order = policies.pick_order(views, signal="predict")
    assert m.pick(signal="predict").index == order[0]
    assert m.pick(exclude=[m.replicas[order[0]]],
                  signal="predict").index == order[1]
    m.stop()


def test_view_of_carries_dispatched_counter():
    m = Membership(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                   probe_interval_s=60.0)
    ra, rb = m.replicas
    m.begin_dispatch(ra)
    m.end_dispatch(ra)
    assert m.view_of(ra).dispatched == 1
    assert m.view_of(rb).dispatched == 0
    # all-idle tie now prefers the least-served replica
    assert m.pick(signal="predict") is rb
    m.stop()


# -- outcome classification --------------------------------------------------


@pytest.mark.parametrize("status,code,wire,want", [
    (200, "", False, policies.OUTCOME_SUCCESS),
    (503, "draining", False, policies.OUTCOME_EJECT),
    (503, "queue_full", False, policies.OUTCOME_REROUTE),
    (503, "", False, policies.OUTCOME_REROUTE),
    (500, "", False, policies.OUTCOME_FAILURE),
    (None, "", True, policies.OUTCOME_FAILURE),
    (404, "", False, policies.OUTCOME_CLIENT_ERROR),
    (400, "bad_request", False, policies.OUTCOME_CLIENT_ERROR),
])
def test_classify_outcome_table(status, code, wire, want):
    assert policies.classify_outcome(status, code, wire_error=wire) == want


def test_only_client_error_is_terminal():
    # the router retries everything except an authoritative 4xx
    terminal = {policies.OUTCOME_CLIENT_ERROR}
    for status, code, wire in [(200, "", False), (503, "draining", False),
                               (503, "queue_full", False), (500, "", False),
                               (None, "", True)]:
        assert policies.classify_outcome(status, code, wire) not in terminal


# -- canary gate -------------------------------------------------------------


GATE_KW = dict(min_requests=10, error_rate_margin=0.05,
               latency_factor=2.0, latency_floor_ms=5.0)


def test_canary_gate_nan_rolls_back_before_min_requests():
    # check order is the contract: NaN beats the min_requests grace
    v, why = policies.canary_gate(VersionStats(requests=1, nans=1),
                                  VersionStats(requests=100), **GATE_KW)
    assert v == policies.GATE_ROLLBACK and "NaN" in why


def test_canary_gate_waits_for_min_requests():
    v, _ = policies.canary_gate(VersionStats(requests=9, errors=9),
                                VersionStats(requests=100), **GATE_KW)
    assert v == policies.GATE_CONTINUE


def test_canary_gate_error_rate_margin():
    inc = VersionStats(requests=100, errors=5)          # 5%
    bad = VersionStats(requests=20, errors=3)           # 15% > 5% + 5%
    ok = VersionStats(requests=20, errors=1)            # 5% within margin
    assert policies.canary_gate(bad, inc, **GATE_KW)[0] == \
        policies.GATE_ROLLBACK
    assert policies.canary_gate(ok, inc, **GATE_KW)[0] == \
        policies.GATE_PROMOTE


def test_canary_gate_latency_bar_and_floor():
    inc = VersionStats(requests=50, latencies_ms=tuple([10.0] * 50))
    slow = VersionStats(requests=20, latencies_ms=tuple([25.0] * 20))
    fast = VersionStats(requests=20, latencies_ms=tuple([19.0] * 20))
    assert policies.canary_gate(slow, inc, **GATE_KW)[0] == \
        policies.GATE_ROLLBACK          # 25 > max(5, 2 x 10)
    assert policies.canary_gate(fast, inc, **GATE_KW)[0] == \
        policies.GATE_PROMOTE
    # no incumbent latency history -> the latency check is skipped
    v, _ = policies.canary_gate(slow, VersionStats(requests=100), **GATE_KW)
    assert v == policies.GATE_PROMOTE


def test_canary_reorder_quarantine_and_coin():
    versions = {0: 1, 1: 2, 2: 1, 3: 3}
    live = policies.canary_reorder([0, 1, 2, 3], versions, canary=2,
                                   quarantined=frozenset({3}),
                                   prefer_canary=True)
    assert live == [1, 0, 2]            # canary group first, load order kept
    live = policies.canary_reorder([0, 1, 2, 3], versions, canary=2,
                                   quarantined=frozenset({3}),
                                   prefer_canary=False)
    assert live == [0, 2, 1]
    # all quarantined -> empty: the router 503s rather than serve bad
    assert policies.canary_reorder([0, 1], {0: 9, 1: 9}, canary=None,
                                   quarantined=frozenset({9}),
                                   prefer_canary=True) == []


# -- token bucket ------------------------------------------------------------


def test_token_bucket_admit_matches_real_bucket():
    # the pure arithmetic drives the real TokenBucket; replaying the same
    # clock script through both must agree decision for decision
    t = [0.0]
    bucket = TokenBucket(2.0, burst=2.0, clock=lambda: t[0])
    tokens, last = 2.0, 0.0
    script = [(0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.6, 1.0), (10.0, 1.0),
              (10.0, 1.0), (10.0, 1.0), (10.4, 1.0)]
    for now, n in script:
        t[0] = now
        ok, tokens, last = policies.token_bucket_admit(
            tokens, last, now, rate=2.0, burst=2.0, n=n)
        assert bucket.try_acquire(n) == ok
    # refill is capped at burst
    ok, tokens, _ = policies.token_bucket_admit(0.0, 0.0, 1e9, rate=2.0,
                                                burst=2.0, n=1.0)
    assert ok and tokens == 1.0


# -- staleness + percentile --------------------------------------------------


def test_probe_is_stale_thresholds():
    assert not policies.probe_is_stale(0.0, 1e9, 1.0)      # never probed
    assert not policies.probe_is_stale(10.0, 12.9, 1.0)    # < 3 intervals
    assert policies.probe_is_stale(10.0, 13.1, 1.0)
    assert not policies.probe_is_stale(10.0, 16.0, 1.0, factor=10.0)


def test_stale_report_degrades_view_to_unknown():
    m = Membership(["http://127.0.0.1:1"], probe_interval_s=1.0)
    (r,) = m.replicas
    r.decode_pages_free, r.decode_free_slots, r.queue_depth = 64, 4, 7
    r.last_probe_t = 100.0
    fresh = m.view_of(r, now=101.0)
    assert fresh.decode_pages_free == 64 and fresh.queue_depth == 7
    stale = m.view_of(r, now=200.0)
    assert stale.decode_pages_free == -1 and stale.decode_free_slots == -1
    assert stale.queue_depth == 0
    m.stop()


def test_percentile_nearest_rank_pins_router_p95():
    assert policies.percentile_nearest_rank([], 95.0) == 0.0
    assert policies.percentile_nearest_rank([3.0], 95.0) == 3.0
    samples = list(range(1, 101))
    # historical formula: sorted[min(n-1, round(0.95 * (n-1)))]
    assert policies.percentile_nearest_rank(samples, 95.0) == \
        samples[min(99, int(round(0.95 * 99)))]
    assert policies.percentile_nearest_rank([5.0, 1.0, 3.0], 50.0) == 3.0


def test_free_kv_bytes_weighting():
    assert view(0, decode_pages_free=8, kv_bytes_per_page=4).free_kv_bytes \
        == 32
    assert view(0, decode_pages_free=8).free_kv_bytes == 8   # unknown bpp
    assert view(0, decode_pages_free=-1,
                kv_bytes_per_page=4).free_kv_bytes == -1     # passthrough
    assert view(0, decode_pages_free=0,
                kv_bytes_per_page=4).free_kv_bytes == 0


# -- parity with the JAX package ---------------------------------------------


def _seeded_views(mod, rng, n, decode=True):
    """``n`` replica views with seeded load, KV and health fields, built
    from ``mod``'s own ``ReplicaView`` (both packages draw the same);
    ``decode=False`` gives a predict fleet (no KV report)."""
    out = []
    for i in range(n):
        out.append(mod.ReplicaView(
            index=i, healthy=rng.random() > 0.15,
            inflight=rng.randrange(0, 6), queue_depth=rng.randrange(0, 9),
            dispatched=rng.randrange(0, 4),
            decode_free_slots=rng.choice([-1, 0, 1, 2, 4]),
            decode_pages_free=rng.choice([-1, 0, 3, 17, 64, 200]),
            kv_bytes_per_page=rng.choice([-1, 1024, 4096]),
            version=rng.choice([1, 2]), managed=rng.random() > 0.2,
            probe_misses=rng.randrange(0, 5)))
        if not decode:
            out[-1] = mod.ReplicaView(**{**out[-1].__dict__,
                                         "decode_free_slots": -1,
                                         "decode_pages_free": -1})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_pick_order_equals_jax(seed):
    for signal in ("predict", "generate"):
        tv = _seeded_views(policies, random.Random(seed), 9)
        jv = _seeded_views(jax_policies, random.Random(seed), 9)
        assert policies.pick_order(tv, signal=signal) == \
            jax_policies.pick_order(jv, signal=signal)


@pytest.mark.parametrize("seed", range(10))
def test_scale_decision_equals_jax(seed):
    rng = random.Random(100 + seed)
    n = rng.randrange(1, 7)
    kw = dict(min_replicas=rng.randrange(1, 3),
              max_replicas=rng.randrange(3, 8), up_cooldown_s=5.0,
              down_cooldown_s=7.0)
    st = dict(desired=n, last_up_t=rng.choice([float("-inf"), 0.0, 95.0]),
              last_down_t=rng.choice([float("-inf"), 0.0, 98.0]))
    wait = rng.choice([None, 0.5, 10.0, 100.0, 400.0])
    actions = []
    for mod in (policies, jax_policies):
        views = _seeded_views(mod, random.Random(seed), n,
                              decode=seed % 2 == 0)
        act = mod.scale_decision(views, mod.ScaleTargets(**kw),
                                 mod.AutoscalerState(**st), 100.0,
                                 queue_wait_p95_ms=wait)
        actions.append((act.kind, act.count, tuple(act.targets),
                        act.reason, act.state.desired, act.state.last_up_t,
                        act.state.last_down_t))
    assert actions[0] == actions[1]


@pytest.mark.parametrize("seed", range(6))
def test_canary_gate_equals_jax(seed):
    rng = random.Random(200 + seed)

    def stats(mod):
        r = random.Random(seed)
        mk = lambda n: mod.VersionStats(  # noqa: E731
            requests=n, errors=r.randrange(0, max(1, n // 3)),
            nans=r.choice([0, 0, 0, 1]),
            latencies_ms=tuple(r.uniform(1, 40) for _ in range(n)))
        return mk(r.randrange(0, 30)), mk(r.randrange(0, 60))

    kw = dict(min_requests=rng.randrange(1, 15),
              error_rate_margin=rng.choice([0.0, 0.05, 0.2]),
              latency_factor=rng.choice([1.2, 2.0]),
              latency_floor_ms=rng.choice([1.0, 5.0]))
    assert policies.canary_gate(*stats(policies), **kw) == \
        jax_policies.canary_gate(*stats(jax_policies), **kw)
