"""PyTorch port, ``sim/``: the JAX suite's simulator cases on the port's
carried copy, and the packages' parity — the same seed gives the same
synthetic trace and the same sha256 event-log digest in both.

The JAX suite's cases (``tests/test_sim.py``): determinism, policy parity,
chaos/canary dynamics, calibration against a real fleet (here: the port's
``RouterServer`` over the port's ``InferenceServer`` replicas), and the
sim-found pick improvement.

The contracts pinned here:

- **byte-identical determinism** — same trace + fleet + seed replays to
  the same event log, asserted on the full event lines AND the running
  sha256 digest (which must agree between record-and-discard modes);
- **pick parity** — the simulator's lazy-heap argmin selects exactly
  ``policies.pick_order(...)[0]`` for arbitrary replica states, so sim
  picks ARE production picks;
- **calibration** — replaying one trace against a real 3-replica HTTP
  fleet and against the sim (cost model fitted only on the real run's
  median) lands the p95 and the per-replica dispatch split within pinned
  factors;
- **the improvement** — the inflight-debited byte-headroom generate rule
  beats the legacy rule on tail latency in the heterogeneous what-if
  that motivated it.
"""

import pytest

import sparkflow_tpu.sim as jax_sim
import sparkflow_tpu_torch.sim as torch_sim

from sparkflow_tpu_torch.serving import policies
from sparkflow_tpu_torch.sim import (CostModel, FleetSimulator, ReplicaSpec,
                               legacy_generate_pick_key, synthetic_trace)
from sparkflow_tpu_torch.sim.trace import Request, bounded_pareto, load, save


def small_fleet(n=4, **kw):
    kw.setdefault("slots", 8)
    kw.setdefault("pages_total", 2048)
    return [ReplicaSpec(**kw) for _ in range(n)]


def run_sim(specs, tr, **kw):
    kw.setdefault("mode", "generate")
    kw.setdefault("seed", 0)
    return FleetSimulator(specs, tr, CostModel.from_bench_notes(),
                         **kw).run()


# -- trace -------------------------------------------------------------------


def test_synthetic_trace_deterministic_and_sorted():
    a = synthetic_trace(500, seed=11)
    b = synthetic_trace(500, seed=11)
    assert a == b
    assert a != synthetic_trace(500, seed=12)
    assert all(x.arrival_s <= y.arrival_s for x, y in zip(a, a[1:]))
    assert len(a) == 500


def test_synthetic_trace_has_sessions_and_heavy_tail():
    tr = synthetic_trace(2000, seed=5, session_fraction=0.5)
    sessions = [r for r in tr if r.session]
    assert sessions and any(r.turn > 0 for r in sessions)
    # multi-turn prompts grow (conversation accumulates)
    by_sid = {}
    for r in sessions:
        by_sid.setdefault(r.session, []).append(r)
    multi = [rs for rs in by_sid.values() if len(rs) > 1]
    assert multi
    rs = sorted(multi[0], key=lambda r: r.turn)
    assert rs[-1].prompt_tokens >= rs[0].prompt_tokens
    # heavy tail: max prompt dwarfs the median
    prompts = sorted(r.prompt_tokens for r in tr)
    assert prompts[-1] > 8 * prompts[len(prompts) // 2]


def test_bounded_pareto_respects_bounds():
    import random
    rng = random.Random(3)
    draws = [bounded_pareto(rng, 1.5, 16, 4096) for _ in range(2000)]
    assert min(draws) >= 16 and max(draws) <= 4096


def test_trace_jsonl_round_trip(tmp_path):
    tr = synthetic_trace(50, seed=2)
    p = str(tmp_path / "trace.jsonl")
    assert save(p, tr) == 50
    assert load(p) == tr
    assert load(p, limit=7) == tr[:7]


# -- determinism -------------------------------------------------------------


def test_event_log_byte_identical_same_seed():
    tr = synthetic_trace(800, seed=4, rate_rps=300.0)
    specs = small_fleet()
    a = run_sim(specs, tr, record_events=True)
    b = run_sim(specs, tr, record_events=True)
    assert a.events == b.events          # byte-identical replay
    assert a.digest == b.digest
    assert a.completed == b.completed and a.rejected == b.rejected
    assert a.latencies_ms == b.latencies_ms


def test_digest_computed_identically_without_event_retention():
    tr = synthetic_trace(400, seed=4, rate_rps=300.0)
    kept = run_sim(small_fleet(), tr, record_events=True)
    dropped = run_sim(small_fleet(), tr, record_events=False)
    assert dropped.events is None
    assert dropped.digest == kept.digest


def test_different_trace_different_log():
    specs = small_fleet()
    a = run_sim(specs, synthetic_trace(400, seed=4, rate_rps=300.0))
    b = run_sim(specs, synthetic_trace(400, seed=5, rate_rps=300.0))
    assert a.digest != b.digest


# -- pick parity -------------------------------------------------------------


def test_heap_pick_matches_policy_order_argmin():
    # arbitrary replica states: the lazy-heap argmin must agree with the
    # full pure sort, including after dispatches mutate the keys
    tr = synthetic_trace(1, seed=0)
    sim = FleetSimulator(small_fleet(6), tr, CostModel.from_bench_notes(),
                         mode="generate", seed=0)
    states = [(3, 500), (0, 2048), (1, 16), (5, 0), (2, 900), (4, 2048)]
    for r, (inflight, pages) in zip(sim.replicas, states):
        r.inflight = inflight
        r.reported_pages_free = pages
        sim._reindex(r)
    for _ in range(6):
        views = [r.view() for r in sim.replicas]
        expect = policies.pick_order(views, signal="generate")
        got = sim._pick(frozenset())
        assert got is not None and got.index == expect[0]
        # mutate the picked replica the way a dispatch would
        got.inflight += 1
        got.dispatched += 1
        sim._reindex(got)


def test_sim_uses_real_policy_by_default_and_balances_ties():
    tr = synthetic_trace(200, seed=9, rate_rps=20.0)  # sparse: no overlap
    rep = run_sim(small_fleet(4), tr)
    counts = [r["dispatched"] for r in rep.per_replica]
    # least-served tie-break spreads an idle fleet evenly
    assert max(counts) - min(counts) <= 1
    assert rep.completed == 200


# -- dynamics ----------------------------------------------------------------


def test_all_requests_accounted():
    tr = synthetic_trace(1500, seed=6, rate_rps=600.0)
    rep = run_sim(small_fleet(4), tr)
    assert rep.completed + rep.rejected == 1500
    assert rep.latency_p95_ms >= rep.latency_p50_ms > 0
    assert rep.ttft_p95_ms <= rep.latency_p95_ms


def test_chaos_kill_trips_breaker_and_recovers():
    tr = synthetic_trace(1200, seed=7, rate_rps=200.0)
    span = tr[-1].arrival_s
    chaos = [(span * 0.3, 0, "down"), (span * 0.6, 0, "up")]
    rep = run_sim(small_fleet(3), tr, chaos=chaos, record_events=True)
    assert rep.completed + rep.rejected == 1200
    assert rep.breaker_transitions > 0
    ev = "\n".join(rep.events)
    assert "chaos r0 down" in ev and "probe_fail r0" in ev
    assert "probe_recover r0" in ev
    # the dead replica's in-flight work was rerouted, not lost
    assert rep.failed_dispatches > 0
    # after recovery replica 0 served again: its completions exceed what
    # it finished before the kill plus nothing (i.e. it has completions
    # logged after the 'up' event)
    post_up = ev.split("chaos r0 up", 1)[1]
    assert "finish rid=" in post_up and " r0 " in post_up


def test_admission_token_bucket_sheds_in_sim():
    tr = synthetic_trace(400, seed=8, rate_rps=400.0)
    rep = run_sim(small_fleet(4), tr, admission_rate=50.0,
                  admission_burst=10.0, max_attempts=2)
    assert rep.admission_rejects > 0
    assert rep.rejected > 0
    assert rep.completed + rep.rejected == 400


def test_canary_promotes_healthy_version_in_sim():
    tr = synthetic_trace(600, seed=10, rate_rps=150.0)
    span = tr[-1].arrival_s
    # replica 2 hot-swaps to version 1 early; the real CanaryController
    # trials it and promotes once min_requests healthy outcomes accrue
    chaos = [(span * 0.1, 2, ("version", 1))]
    rep = run_sim(small_fleet(3), tr, canary=True,
                  canary_kwargs=dict(min_requests=10), chaos=chaos)
    assert rep.canary_promotions == 1
    assert rep.canary_rollbacks == 0
    assert rep.completed + rep.rejected == 600


# -- the sim-found policy improvement ----------------------------------------


def test_debited_pick_beats_legacy_on_heterogeneous_fleet():
    # the what-if that motivated the generate-rule change: mixed pool
    # sizes/bytes-per-page under bursty load. The legacy rule trusts the
    # stale page report and pays a queue_full storm per burst; the debit
    # rule predicts exhaustion and keeps tail latency down.
    cost = CostModel.from_bench_notes()
    specs = ([ReplicaSpec(slots=16, pages_total=8192,
                          kv_bytes_per_page=4 << 20) for _ in range(2)] +
             [ReplicaSpec(slots=16, pages_total=1024,
                          kv_bytes_per_page=1 << 20) for _ in range(6)])
    tr = synthetic_trace(20000, seed=3, rate_rps=900.0)
    legacy = FleetSimulator(specs, tr, cost, mode="generate", seed=0,
                            pick_key=legacy_generate_pick_key).run()
    new = FleetSimulator(specs, tr, cost, mode="generate", seed=0).run()
    assert new.completed == legacy.completed == 20000
    assert new.latency_p95_ms < 0.7 * legacy.latency_p95_ms
    assert new.ttft_p95_ms < legacy.ttft_p95_ms


# -- calibration against a real fleet ----------------------------------------


def test_calibration_pins_sim_vs_real_agreement():
    # the acceptance gate: same trace through a REAL 3-replica HTTP fleet
    # and through the sim (cost model fitted only on the real median);
    # p95 within 3x, per-replica dispatch split within 2.5x
    from sparkflow_tpu_torch.sim.calibrate import calibrate

    tr = synthetic_trace(90, seed=1, rate_rps=60.0, session_fraction=0.0,
                         burst_factor=2.0)
    res = calibrate(tr, num_replicas=3, service_delay_s=0.01,
                    slots_per_replica=8)
    assert res.real.errors == 0
    assert len(res.real.latencies_ms) == 90
    assert res.sim_report.completed == 90
    assert res.p95_ratio < 3.0, res.summary()
    assert res.max_count_ratio < 2.5, res.summary()


# -- scale (slow tier) -------------------------------------------------------


@pytest.mark.slow
def test_scale_1000_replicas_1m_requests():
    # the headline claim: fleet-scale what-ifs are cheap. 1000 replicas x
    # 1M requests, fully accounted, deterministic, bounded wall-clock
    cost = CostModel.from_bench_notes()
    tr = synthetic_trace(1_000_000, seed=7, rate_rps=40000.0,
                         prompt_range=(16, 1024), output_range=(8, 256))
    specs = [ReplicaSpec(slots=8, pages_total=4096) for _ in range(1000)]
    rep = FleetSimulator(specs, tr, cost, mode="generate", seed=0).run()
    assert rep.completed + rep.rejected == 1_000_000
    assert rep.wall_s < 300.0
    assert sum(r["dispatched"] for r in rep.per_replica) >= 1_000_000


# -- parity with the JAX package ---------------------------------------------


def _both(mod, seed, mode, **fleet):
    tr = mod.synthetic_trace(600, seed=seed, rate_rps=300.0)
    specs = [mod.ReplicaSpec(slots=8, pages_total=512, **fleet)
             for _ in range(4)]
    rep = mod.FleetSimulator(specs, tr, mod.CostModel.from_bench_notes(),
                             mode=mode, seed=seed,
                             chaos=[(0.5, 1, "down"), (1.2, 1, "up")],
                             admission_rate=250.0, admission_burst=40.0
                             ).run()
    return tr, rep


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_trace_and_digest_identical_to_jax(seed):
    for mode in ("generate", "predict"):
        ttr, trep = _both(torch_sim, seed, mode)
        jtr, jrep = _both(jax_sim, seed, mode)
        assert [tuple(vars(r).values()) for r in ttr] == \
            [tuple(vars(r).values()) for r in jtr]
        assert trep.digest == jrep.digest
        assert trep.completed > 0 and trep.breaker_transitions > 0
        assert (trep.completed, trep.rejected, trep.reroutes) == \
            (jrep.completed, jrep.rejected, jrep.reroutes)
