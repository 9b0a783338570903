"""PyTorch port, the elastic autoscaler: the JAX suite's cases
(``tests/test_autoscaler.py``) on the port's carried ``Autoscaler`` /
``ReplicaManager`` / ``policies`` / ``sim``, plus a real port
``InferenceServer`` replica process spawned, routed to, SIGKILLed and
replaced. The JAX suite's contract: the self-healing fleet.

Four layers, mirroring the policy/transport split:

- **fake-clock policy units** — :func:`policies.scale_decision`'s priority
  order (replace > below-min > up > down > hold), hysteresis band edges,
  per-direction cooldowns, overshoot-proportional step, min/max bounds,
  and the idle-victim preference of :func:`policies.scale_down_order` are
  a pinned decision table;
- **sim-driven dynamics** — the SAME policy inside ``FleetSimulator``: a
  2x load step recovers tail latency with a bounded number of scale-up
  decisions, a chaos kill is replaced, idle trailing load drains the
  zero-inflight victim (byte-identical determinism throughout);
- **live control loop** — :class:`Autoscaler` + :class:`ReplicaManager`
  over fake process handles: crash reaping -> replacement within one
  tick, fault-injected ``autoscaler.spawn`` bounded by ``RetryPolicy``,
  ``autoscaler.drain`` fired on scale-down, ``autoscaler/*`` gauges;
- **real-subprocess e2e** — spawn/drain/crash-replace against actual OS
  processes and signals (stdlib HTTP stubs, no jax import cost).

Plus the static gates: the policy module stays GC-S501-pure and the new
transport modules stay GC-L30x lock-clean.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from sparkflow_tpu.analysis import locks, policy_lint
from sparkflow_tpu_torch.resilience import faults
from sparkflow_tpu_torch.resilience.retry import RetryExhausted, RetryPolicy
from sparkflow_tpu_torch.serving import policies
from sparkflow_tpu_torch.serving.autoscaler import Autoscaler, ReplicaManager
from sparkflow_tpu_torch.serving.membership import Membership
from sparkflow_tpu_torch.serving.policies import (AutoscalerState,
                                                  ReplicaView, ScaleTargets,
                                                  scale_decision,
                                                  scale_down_order)
from sparkflow_tpu_torch.sim import (CostModel, FleetSimulator, ReplicaSpec,
                                     SimAutoscaler, synthetic_trace)
from sparkflow_tpu_torch.utils.metrics import Metrics


def view(i, **kw):
    return ReplicaView(index=i, **kw)


def healthy_fleet(n, **kw):
    kw.setdefault("decode_free_slots", 4)
    kw.setdefault("decode_pages_free", 100)
    return [view(i, **kw) for i in range(n)]


T = ScaleTargets(min_replicas=1, max_replicas=8, queue_wait_high_ms=200.0,
                 queue_wait_low_ms=50.0, up_cooldown_s=10.0,
                 down_cooldown_s=60.0, max_step_up=2)
S0 = AutoscalerState(desired=2)


# -- policy units (fake clock) ----------------------------------------------


def test_replace_beats_everything_and_bypasses_cooldowns():
    views = healthy_fleet(3)
    views[1] = view(1, healthy=False, probe_misses=T.dead_after_misses)
    # heavily overloaded AND inside both cooldowns: replacement still wins
    st = AutoscalerState(desired=3, last_up_t=99.0, last_down_t=99.0)
    act = scale_decision(views, T, st, now=100.0, queue_wait_p95_ms=999.0)
    assert act.kind == policies.SCALE_REPLACE
    assert act.targets == (1,) and act.count == 1
    assert act.state == st  # replacement is not growth: state untouched


def test_replace_applies_even_at_max_replicas():
    t = ScaleTargets(min_replicas=1, max_replicas=3)
    views = healthy_fleet(3)
    views[0] = view(0, healthy=False, probe_misses=t.dead_after_misses)
    act = scale_decision(views, t, S0, now=0.0)
    assert act.kind == policies.SCALE_REPLACE and act.targets == (0,)


def test_single_probe_miss_is_debounced_not_dead():
    # one failed probe = most likely a saturated replica, not a dead one:
    # it leaves rotation but is NOT replaced (killing it would amplify
    # the very overload that slowed the probe)
    views = healthy_fleet(3)
    views[1] = view(1, healthy=False, probe_misses=1)
    st = AutoscalerState(desired=3, last_up_t=99.0, last_down_t=99.0)
    act = scale_decision(views, T, st, now=100.0, queue_wait_p95_ms=100.0)
    assert act.kind == policies.SCALE_HOLD
    # the suspect still counts as presumed capacity: no below-min spawn
    t = ScaleTargets(min_replicas=3, max_replicas=8)
    act = scale_decision(views, t, st, now=100.0, queue_wait_p95_ms=100.0)
    assert act.kind == policies.SCALE_HOLD
    # threshold crossed: now it is a death and replacement fires
    views[1] = view(1, healthy=False, probe_misses=T.dead_after_misses)
    act = scale_decision(views, T, st, now=100.0, queue_wait_p95_ms=100.0)
    assert act.kind == policies.SCALE_REPLACE and act.targets == (1,)


def test_unmanaged_replica_is_never_killed_or_deregistered():
    # an unmanaged (founding-fleet) replica past the death threshold is
    # presumed gone but never a replace target — there is no process to
    # respawn; the below-min rule refills the fleet AROUND it, and the
    # record re-admits if its probe recovers
    views = healthy_fleet(3)
    views[0] = view(0, healthy=False, probe_misses=99, managed=False)
    st = AutoscalerState(desired=3, last_up_t=99.0, last_down_t=99.0)
    act = scale_decision(views, T, st, now=100.0, queue_wait_p95_ms=100.0)
    assert act.kind != policies.SCALE_REPLACE
    t = ScaleTargets(min_replicas=3, max_replicas=8)
    act = scale_decision(views, t, st, now=100.0, queue_wait_p95_ms=100.0)
    assert act.kind == policies.SCALE_UP and act.count == 1
    assert "below min_replicas" in act.reason


def test_scale_down_victim_is_managed_only():
    # the idle unmanaged replica would top scale_down_order, but electing
    # it would burn the down-cooldown on an inapplicable drain: the
    # victim must be the best MANAGED candidate
    views = [view(0, managed=False, decode_free_slots=4,
                  decode_pages_free=100),
             view(1, inflight=2, decode_free_slots=4,
                  decode_pages_free=100)]
    st = AutoscalerState(desired=2)
    act = scale_decision(views, T, st, now=1000.0, queue_wait_p95_ms=1.0)
    assert act.kind == policies.SCALE_DOWN and act.targets == (1,)
    # an all-unmanaged fleet above min holds instead of deciding a no-op
    views = [view(0, managed=False), view(1, managed=False)]
    act = scale_decision(views, T, st, now=1000.0, queue_wait_p95_ms=1.0)
    assert act.kind == policies.SCALE_HOLD


def test_below_min_scales_up_without_cooldown():
    t = ScaleTargets(min_replicas=3, max_replicas=8, up_cooldown_s=10.0)
    st = AutoscalerState(desired=3, last_up_t=99.5)  # mid up-cooldown
    act = scale_decision(healthy_fleet(1), t, st, now=100.0)
    assert act.kind == policies.SCALE_UP and act.count == 2
    assert act.state.desired == 3 and act.state.last_up_t == 100.0


def test_up_requires_high_band_and_respects_cooldown():
    views = healthy_fleet(2)
    # inside the band: hold
    act = scale_decision(views, T, S0, now=100.0, queue_wait_p95_ms=100.0)
    assert act.kind == policies.SCALE_HOLD
    # above the band but still cooling down from the last up: hold
    st = AutoscalerState(desired=2, last_up_t=95.0)
    act = scale_decision(views, T, st, now=100.0, queue_wait_p95_ms=300.0)
    assert act.kind == policies.SCALE_HOLD and "cooldown" in act.reason
    # cooldown expired: up
    act = scale_decision(views, T, st, now=106.0, queue_wait_p95_ms=300.0)
    assert act.kind == policies.SCALE_UP and act.count == 1
    assert act.state.last_up_t == 106.0 and act.state.desired == 3


def test_up_step_proportional_to_overshoot_and_capped():
    views = healthy_fleet(2)
    # 2.5x the band edge = one extra band-width of overshoot -> step 2
    act = scale_decision(views, T, S0, now=100.0, queue_wait_p95_ms=500.0)
    assert act.kind == policies.SCALE_UP and act.count == 2
    # absurd overshoot is still capped by max_step_up
    act = scale_decision(views, T, S0, now=100.0, queue_wait_p95_ms=9000.0)
    assert act.count == T.max_step_up
    # and by max_replicas
    t = ScaleTargets(max_replicas=3, max_step_up=4)
    act = scale_decision(views, t, S0, now=100.0, queue_wait_p95_ms=9000.0)
    assert act.count == 1
    # at max: hold, however overloaded
    t2 = ScaleTargets(max_replicas=2)
    act = scale_decision(views, t2, S0, now=100.0, queue_wait_p95_ms=9000.0)
    assert act.kind == policies.SCALE_HOLD


def test_starvation_scales_up_without_wait_signal():
    # an empty histogram (wait=None) must not mask page exhaustion
    views = [view(0, decode_free_slots=0, decode_pages_free=0),
             view(1, decode_free_slots=0, decode_pages_free=50)]
    act = scale_decision(views, T, S0, now=100.0, queue_wait_p95_ms=None)
    assert act.kind == policies.SCALE_UP and "starved" in act.reason


def test_down_gated_on_both_direction_cooldowns_and_min_floor():
    views = healthy_fleet(3)
    # below the low band, but a recent UP also blocks the down path —
    # shrinking right after growing is the oscillation the band prevents
    st = AutoscalerState(desired=3, last_up_t=90.0, last_down_t=0.0)
    act = scale_decision(views, T, st, now=100.0, queue_wait_p95_ms=10.0)
    assert act.kind == policies.SCALE_HOLD and "down-cooldown" in act.reason
    # both cooldowns expired: down by exactly one
    st = AutoscalerState(desired=3, last_up_t=0.0, last_down_t=0.0)
    act = scale_decision(views, T, st, now=100.0, queue_wait_p95_ms=10.0)
    assert act.kind == policies.SCALE_DOWN and act.count == 1
    assert act.state.desired == 2 and act.state.last_down_t == 100.0
    # at the floor: hold forever, however idle
    t = ScaleTargets(min_replicas=3)
    act = scale_decision(views, t, st, now=100.0, queue_wait_p95_ms=0.0)
    assert act.kind == policies.SCALE_HOLD


def test_idle_fleet_with_no_signal_scales_down():
    # wait=None (no samples yet) counts as idle for the down path
    st = AutoscalerState(desired=2)
    act = scale_decision(healthy_fleet(2), T, st, now=1000.0,
                         queue_wait_p95_ms=None)
    assert act.kind == policies.SCALE_DOWN


def test_scale_down_order_prefers_idle_then_highest_index():
    views = [view(0, inflight=0, queue_depth=0),
             view(1, inflight=3, queue_depth=1),
             view(2, inflight=0, queue_depth=2),
             view(3, inflight=0, queue_depth=0)]
    order = scale_down_order(views)
    # zero-inflight zero-queue first; ties break to the HIGHEST index
    # (latest addition leaves first); the busy replica drains last
    assert order == [3, 0, 2, 1]
    act = scale_decision(views, T, AutoscalerState(desired=4), now=1000.0,
                         queue_wait_p95_ms=1.0)
    assert act.kind == policies.SCALE_DOWN and act.targets == (3,)


def test_scale_policy_is_pure_s501():
    findings = policy_lint.lint_file(policies.__file__)
    assert findings == [], "\n".join(f"{f.rule}: {f.message}"
                                     for f in findings)


# -- sim-driven dynamics ----------------------------------------------------


def sim_fleet(n, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("pages_total", 512)
    return [ReplicaSpec(**kw) for _ in range(n)]


def run_autoscaled(tr, n=6, autoscaler=None, **kw):
    kw.setdefault("mode", "generate")
    kw.setdefault("seed", 0)
    return FleetSimulator(sim_fleet(n), tr, CostModel.from_bench_notes(),
                         autoscaler=autoscaler, **kw).run()


def test_sim_step_response_recovers_with_bounded_decisions():
    tr = synthetic_trace(1200, seed=11, rate_rps=60.0, burst_factor=4.0,
                         session_fraction=0.0)
    asc = SimAutoscaler(
        targets=ScaleTargets(min_replicas=1, max_replicas=6,
                             queue_wait_high_ms=150.0,
                             queue_wait_low_ms=30.0,
                             up_cooldown_s=1.0, down_cooldown_s=8.0,
                             max_step_up=2),
        initial=1, decide_interval_s=0.5, spawn_delay_s=0.5)
    small = run_autoscaled(tr, n=6,
                           autoscaler=SimAutoscaler(
                               targets=ScaleTargets(min_replicas=1,
                                                    max_replicas=1),
                               initial=1, decide_interval_s=0.5))
    scaled = run_autoscaled(tr, n=6, autoscaler=asc)
    assert scaled.completed + scaled.rejected == 1200
    # capacity actually arrived...
    assert scaled.scale_ups >= 1
    assert scaled.final_fleet_size > 1
    # ...in a bounded number of decisions (not thrash): never more
    # decisions than it takes to walk min -> max in max_step_up strides
    assert scaled.scale_ups <= 10
    # and the tail is measurably better than the pinned-1 fleet's
    assert scaled.latency_p95_ms < 0.7 * small.latency_p95_ms


def test_sim_autoscaler_is_deterministic():
    tr = synthetic_trace(400, seed=5, rate_rps=40.0, session_fraction=0.0)
    asc = SimAutoscaler(targets=ScaleTargets(min_replicas=1, max_replicas=4,
                                             up_cooldown_s=1.0,
                                             down_cooldown_s=5.0),
                        initial=1, decide_interval_s=0.5)
    a = run_autoscaled(tr, n=4, autoscaler=asc)
    b = run_autoscaled(tr, n=4, autoscaler=asc)
    assert a.digest == b.digest
    assert (a.scale_ups, a.scale_downs, a.replacements) == \
        (b.scale_ups, b.scale_downs, b.replacements)


def test_sim_chaos_kill_is_replaced():
    tr = synthetic_trace(800, seed=7, rate_rps=60.0, session_fraction=0.0)
    span = tr[-1].arrival_s
    asc = SimAutoscaler(targets=ScaleTargets(min_replicas=2, max_replicas=4,
                                             up_cooldown_s=1.0,
                                             down_cooldown_s=30.0),
                        initial=2, decide_interval_s=0.5,
                        spawn_delay_s=0.5)
    rep = run_autoscaled(tr, n=4, autoscaler=asc,
                         chaos=[(span * 0.4, 0, "down")],
                         record_events=True)
    assert rep.replacements >= 1
    assert rep.completed + rep.rejected == 800
    ev = "\n".join(rep.events)
    assert "scale replace r0" in ev and "spawned r" in ev


def test_sim_scale_down_drains_idle_victim():
    # load that ends early, then a long idle tail: the fleet must shrink
    # back toward min and the drained replica must finish its work first
    tr = synthetic_trace(300, seed=9, rate_rps=80.0, session_fraction=0.0)
    asc = SimAutoscaler(targets=ScaleTargets(min_replicas=1, max_replicas=4,
                                             queue_wait_high_ms=100.0,
                                             queue_wait_low_ms=40.0,
                                             up_cooldown_s=0.5,
                                             down_cooldown_s=2.0),
                        initial=3, decide_interval_s=0.5)
    rep = run_autoscaled(tr, n=4, autoscaler=asc, record_events=True)
    assert rep.scale_downs >= 1
    assert rep.completed + rep.rejected == 300
    ev = "\n".join(rep.events)
    assert "scale_down_complete" in ev
    # nothing was lost to a drain: every request completed or was an
    # admission-path reject, never a mid-flight kill from scale-down
    assert rep.completed == 300 - rep.rejected


def test_sim_below_min_does_not_reorder_pending_spawns():
    # initial < min with a spawn delay spanning several decide intervals:
    # the deficit must be ordered ONCE (booting spares count as live
    # capacity), not re-ordered every tick until the spawns land
    tr = synthetic_trace(100, seed=3, rate_rps=20.0, session_fraction=0.0)
    asc = SimAutoscaler(targets=ScaleTargets(min_replicas=3,
                                             max_replicas=6),
                        initial=1, decide_interval_s=0.5,
                        spawn_delay_s=3.0)
    rep = run_autoscaled(tr, n=6, autoscaler=asc)
    assert rep.scale_ups == 1
    assert rep.final_fleet_size == 3


# -- membership elasticity --------------------------------------------------


def test_register_assigns_never_recycled_index():
    mem = Membership(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                     metrics=Metrics())
    r2 = mem.register("http://127.0.0.1:3")
    assert r2.index == 2
    mem.deregister(r2)
    r3 = mem.register("http://127.0.0.1:4")
    assert r3.index == 3  # identity not reused even after deregister
    assert [r.index for r in mem.replicas] == [0, 1, 3]


def test_deregister_drops_gauges_and_rotation():
    metrics = Metrics()
    mem = Membership(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                     metrics=metrics)
    for r in mem.replicas:
        r.healthy = True
    mem.publish_gauges()
    assert any(k.startswith("router/replica0/") for k in metrics.gauges())
    victim = mem.replicas[0]
    mem.deregister(victim)
    # the ghost's gauges are gone, the survivor's stay
    assert not any(k.startswith("router/replica0/")
                   for k in metrics.gauges())
    assert any(k.startswith("router/replica1/") for k in metrics.gauges())
    # and it can never be picked again
    for _ in range(8):
        assert mem.pick() is not victim
    # idempotent: a second deregister is a no-op
    mem.deregister(victim)
    assert len(mem.replicas) == 1


def test_views_matches_view_of():
    mem = Membership(["http://127.0.0.1:1"], metrics=Metrics())
    mem.replicas[0].healthy = True
    (v,) = mem.views(now=0.0)
    assert v == mem.view_of(mem.replicas[0], 0.0)


def test_probe_misses_accumulate_and_reset_on_recovery():
    mem = Membership(["http://127.0.0.1:1"], metrics=Metrics())
    r = mem.replicas[0]
    mem.probe_all()        # nothing listens on the port: miss
    mem.probe_all()
    assert not r.healthy and r.probe_misses == 2
    (v,) = mem.views(now=0.0)
    assert v.probe_misses == 2 and not v.healthy
    # a green probe re-admits AND clears the miss streak
    r.probe_client.healthz = (
        lambda timeout_s=None: {"status": "ok", "queue_depth": 0})
    mem.probe_all()
    assert r.healthy and r.probe_misses == 0


# -- live control loop (fake processes) -------------------------------------


class FakeProc:
    """Popen-shaped handle the manager can terminate/kill/reap."""

    def __init__(self):
        self.rc = None
        self.terminated = False

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated = True
        self.rc = 0

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        if self.rc is None:
            raise RuntimeError("still running")
        return self.rc


class FakeFleet:
    """A Membership + no-health-wait ReplicaManager over FakeProcs."""

    def __init__(self, **rm_kw):
        self.metrics = Metrics()
        self.membership = Membership(["http://127.0.0.1:1"],
                                     metrics=self.metrics)
        self.membership.deregister(self.membership.replicas[0])
        self.ports = iter(range(9100, 9200))
        self.procs = {}

        fleet = self

        class _RM(ReplicaManager):
            def _wait_healthy(self, url, proc):
                return  # fake servers are born healthy

        def launcher(port):
            p = FakeProc()
            fleet.procs[port] = p
            return p

        rm_kw.setdefault("retry", RetryPolicy(max_attempts=3, base_s=0.0,
                                              jitter=0.0))
        self.manager = _RM(launcher, membership=self.membership,
                           port_factory=lambda: next(self.ports), **rm_kw)

    def mark_all_healthy(self):
        for r in self.membership.replicas:
            r.healthy = True
            r.probe_misses = 0

    def proc_of(self, replica):
        return self.manager._managed[replica.index].proc


def make_autoscaler(fleet, wait_box, **targets_kw):
    targets_kw.setdefault("min_replicas", 2)
    targets_kw.setdefault("max_replicas", 4)
    targets_kw.setdefault("up_cooldown_s", 0.0)
    targets_kw.setdefault("down_cooldown_s", 0.0)
    return Autoscaler(fleet.membership, fleet.manager,
                      targets=ScaleTargets(**targets_kw),
                      metrics=fleet.metrics,
                      queue_wait_signal=lambda: wait_box[0])


def test_autoscaler_full_lifecycle_and_gauges():
    fleet = FakeFleet()
    wait = [None]
    a = make_autoscaler(fleet, wait)

    # below min: spawn up to the floor without any signal
    act = a.tick()
    assert act.kind == policies.SCALE_UP
    assert len(fleet.membership.replicas) == 2
    fleet.mark_all_healthy()

    # overload: grow
    wait[0] = 900.0
    act = a.tick()
    assert act.kind == policies.SCALE_UP
    assert len(fleet.membership.replicas) == 4
    fleet.mark_all_healthy()

    # crash: reaped and replaced within ONE tick, not a probe cycle
    victim = fleet.manager.managed()[0]
    fleet.proc_of(victim).rc = -9
    wait[0] = 100.0
    act = a.tick()
    assert act.kind == policies.SCALE_REPLACE
    assert a.replacements == 1
    assert len(fleet.membership.replicas) == 4
    assert victim.index not in {r.index for r in fleet.membership.replicas}
    fleet.mark_all_healthy()

    # idle: shrink by one, draining (SIGTERM path) the victim
    wait[0] = 1.0
    act = a.tick()
    assert act.kind == policies.SCALE_DOWN
    assert a.drains == 1
    assert len(fleet.membership.replicas) == 3

    g = fleet.metrics.gauges()
    assert g["autoscaler/replicas"] == 3.0
    assert g["autoscaler/target"] == 3.0
    assert g["autoscaler/spawns"] == 5.0
    assert g["autoscaler/drains"] == 1.0
    assert g["autoscaler/replacements"] == 1.0
    assert g["autoscaler/last_decision"] == 2.0  # down


def test_spawn_fault_is_retry_bounded():
    fleet = FakeFleet()
    # first attempt fails, retry succeeds: the fleet still comes up
    with faults.inject("autoscaler.spawn", fail_calls=[0]) as spec:
        replica = fleet.manager.spawn()
    assert spec.calls == 2 and spec.failures == 1
    assert replica in fleet.membership.replicas
    # every attempt fails: bounded exhaustion, not a hang
    with faults.inject("autoscaler.spawn", fail_calls=[0, 1, 2]):
        with pytest.raises(RetryExhausted):
            fleet.manager.spawn()
    # the failed spawn registered nothing
    assert len(fleet.membership.replicas) == 1


def test_spawn_failure_retried_next_tick():
    fleet = FakeFleet()
    wait = [None]
    a = make_autoscaler(fleet, wait, min_replicas=1)
    with faults.inject("autoscaler.spawn", fail_calls=[0, 1, 2]):
        a.tick()  # below-min spawn exhausts its retries
    assert a.spawn_failures == 1
    assert len(fleet.membership.replicas) == 0
    a.tick()  # faults gone: the next tick converges to min
    assert len(fleet.membership.replicas) == 1


def test_drain_fires_fault_point_and_reaps_clean_exit():
    fleet = FakeFleet()
    r = fleet.manager.spawn()
    fleet.mark_all_healthy()
    with faults.inject("autoscaler.drain", fail_calls=[]) as spec:
        fleet.manager.drain(r)
    assert spec.calls == 1
    assert fleet.membership.replicas == []
    assert fleet.manager.managed_count == 0
    # a drained process got SIGTERM, not SIGKILL
    assert next(iter(fleet.procs.values())).terminated


def test_reap_reports_exits_without_acting():
    fleet = FakeFleet()
    a_r = fleet.manager.spawn()
    b_r = fleet.manager.spawn()
    fleet.proc_of(b_r).rc = 1
    dead = fleet.manager.reap()
    assert [(r.index, rc) for r, rc in dead] == [(b_r.index, 1)]
    # reap is an observation: the record stays managed for the tick loop
    assert fleet.manager.owns(b_r) and fleet.manager.owns(a_r)


# -- real-subprocess e2e ----------------------------------------------------


_REPLICA_STUB = textwrap.dedent("""\
    import json, os, signal, sys
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        def _reply(self):
            body = json.dumps({"status": "ok", "queue_depth": 0}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        do_GET = do_POST = _reply
        def log_message(self, *a):
            pass

    signal.signal(signal.SIGTERM, lambda *a: os._exit(0))
    srv = ThreadingHTTPServer(("127.0.0.1", int(sys.argv[1])), H)
    srv.serve_forever()
""")


def stub_launcher(port):
    return subprocess.Popen([sys.executable, "-c", _REPLICA_STUB, str(port)])


@pytest.fixture
def live_fleet():
    metrics = Metrics()
    mem = Membership(["http://127.0.0.1:1"], metrics=metrics,
                     probe_interval_s=0.1)
    mem.deregister(mem.replicas[0])
    rm = ReplicaManager(stub_launcher, membership=mem,
                        retry=RetryPolicy(max_attempts=2, base_s=0.1),
                        health_timeout_s=20.0, drain_timeout_s=5.0,
                        poll_interval_s=0.05)
    try:
        yield mem, rm, metrics
    finally:
        rm.stop_all(kill=True)
        mem.stop()


def test_subprocess_spawn_drain_and_crash_replace(live_fleet):
    mem, rm, metrics = live_fleet
    wait = [None]
    a = Autoscaler(mem, rm,
                   targets=ScaleTargets(min_replicas=2, max_replicas=3,
                                        up_cooldown_s=0.0,
                                        down_cooldown_s=0.0),
                   metrics=metrics, queue_wait_signal=lambda: wait[0])

    # spawn to the floor: two real processes, both probed healthy
    act = a.tick()
    assert act.kind == policies.SCALE_UP
    assert len(mem.replicas) == 2
    assert all(r.healthy for r in mem.replicas)

    # SIGKILL one replica out from under the fleet: one tick reaps the
    # exit code and a real replacement process comes up healthy
    victim = rm.managed()[0]
    victim_proc = rm._managed[victim.index].proc
    victim_proc.send_signal(signal.SIGKILL)
    victim_proc.wait(timeout=10.0)
    act = a.tick()
    assert act.kind == policies.SCALE_REPLACE
    assert a.replacements == 1
    assert len(mem.replicas) == 2
    assert victim.index not in {r.index for r in mem.replicas}
    assert all(r.healthy for r in mem.replicas)
    # the dead replica's gauges went with it
    mem.publish_gauges()
    assert not any(k.startswith(f"router/replica{victim.index}/")
                   for k in metrics.gauges())

    # scale down: SIGTERM drain, process really exits (its handler does a
    # clean exit 0), record and membership row both gone
    survivor = rm.managed()[0]
    survivor_proc = rm._managed[survivor.index].proc
    rm.drain(survivor)
    assert rm.managed_count == 1
    assert len(mem.replicas) == 1
    assert survivor_proc.poll() == 0


def test_subprocess_spawn_survives_first_port_failure(live_fleet):
    mem, rm, _ = live_fleet
    with faults.inject("autoscaler.spawn", fail_calls=[0]) as spec:
        replica = rm.spawn()
    assert spec.calls == 2
    assert replica.healthy


# -- static gates -----------------------------------------------------------


SERVING_DIR = os.path.join(os.path.dirname(__file__), os.pardir,
                           "sparkflow_tpu_torch", "serving")


@pytest.mark.parametrize("fname", ["autoscaler.py", "coldstart.py",
                                   "membership.py"])
def test_lock_lint_clean(fname):
    findings = locks.lint_file(os.path.join(SERVING_DIR, fname))
    bad = [f for f in findings
           if f.rule in ("GC-L301", "GC-L302", "GC-L303")]
    assert not bad, "\n".join(f"{f.rule}: {f.message}" for f in bad)


# -- a real port replica: the InferenceServer process the fleet runs ---------

_PORT_REPLICA = textwrap.dedent("""\
    import sys, time
    import numpy as np
    import sparkflow_tpu_torch.nn as nn
    from sparkflow_tpu_torch.graph_utils import build_graph
    from sparkflow_tpu_torch.resilience.lifecycle import ServerState
    from sparkflow_tpu_torch.serving import InferenceEngine, InferenceServer

    def mlp():
        x = nn.placeholder([None, 4], name="x")
        h = nn.dense(x, 3, activation="relu")
        out = nn.dense(h, 2, name="out")
        nn.mean_squared_error(x, out)

    rs = np.random.RandomState(0)
    w = [rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32),
         rs.randn(3, 2).astype(np.float32), rs.randn(2).astype(np.float32)]
    eng = InferenceEngine(build_graph(mlp), w, input_name="x:0",
                          output_name="out/BiasAdd:0", max_batch=8,
                          device="cpu", executable_dir=sys.argv[2])
    srv = InferenceServer(eng, port=int(sys.argv[1]), max_delay_ms=1.0,
                          memory_watch=False, flight_dir=sys.argv[2])
    srv.start()
    srv.install_signal_handlers()
    while srv.lifecycle.state in (ServerState.STARTING, ServerState.SERVING):
        time.sleep(0.05)
    srv.stop()
""")


def test_port_replica_processes_route_crash_and_replace(tmp_path):
    """The port's own InferenceServer replicas as processes: the manager
    spawns them, the router answers through them (the manual forward
    within 1e-5), a SIGKILLed one is reaped and replaced in one tick, its
    flight record is harvested, and scale-down drains with exit 0."""
    import numpy as np
    from sparkflow_tpu_torch.serving import RouterServer, ServingClient
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))

    def launcher(port):
        return subprocess.Popen([sys.executable, "-c", _PORT_REPLICA,
                                 str(port), str(tmp_path)], env=env)

    router = RouterServer(["http://127.0.0.1:1"], probe_interval_s=0.1,
                          dispatch_retries=4)
    router.membership.deregister(router.membership.replicas[0])
    router.start()
    rm = ReplicaManager(launcher, membership=router.membership,
                        health_timeout_s=60.0, drain_timeout_s=10.0,
                        poll_interval_s=0.05, flight_dir=str(tmp_path))
    a = Autoscaler(router.membership, rm,
                   targets=ScaleTargets(min_replicas=2, max_replicas=2),
                   queue_wait_signal=lambda: None)
    rs = np.random.RandomState(0)
    w = [rs.randn(4, 3), rs.randn(3), rs.randn(3, 2), rs.randn(2)]
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    want = np.maximum(x @ w[0] + w[1], 0.0) @ w[2] + w[3]
    try:
        assert a.tick().kind == policies.SCALE_UP
        assert rm.managed_count == 2
        cli = ServingClient(router.url, retries=0)
        np.testing.assert_allclose(cli.predict(x), want, atol=1e-5)
        victim = rm.managed()[0]
        proc = rm._managed[victim.index].proc
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        np.testing.assert_allclose(cli.predict(x), want, atol=1e-5)
        assert a.tick().kind == policies.SCALE_REPLACE
        assert rm.managed_count == 2 and a.replacements == 1
        assert any(r["harvest_reason"] == "crash" for r in rm.flight_reports)
        for _ in range(4):
            np.testing.assert_allclose(cli.predict(x), want, atol=1e-5)
        survivor = rm.managed()[0]
        sproc = rm._managed[survivor.index].proc
        rm.drain(survivor)
        assert sproc.poll() == 0
    finally:
        rm.stop_all(kill=True)
        router.stop()
