"""PyTorch port, the fleet router: the JAX suite's router cases
(``tests/test_router.py``) on the port's ``RouterServer`` / ``Membership``
in front of the port's ``InferenceServer`` replicas (engines on the CPU),
and the packages' interchange — each package's router in front of the
other package's replicas gives the same predictions (within 1e-5) and the
same greedy tokens.

The JAX suite's contract: health-gated router, circuit breakers,
admission, hedging, result cache, and chaos-tested failover; with 3
replicas under sustained load, killing and restarting one replica produces
zero client-visible failures (the router retries/reroutes), and every
routed response echoes the originating ``X-Request-Id`` end to end.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

import sparkflow_tpu_torch.nn as nn
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.obs.spans import Tracer
from sparkflow_tpu_torch.resilience import faults
from sparkflow_tpu_torch.resilience.lifecycle import ServerState
from sparkflow_tpu_torch.serving import (BreakerState, CircuitBreaker,
                                         InferenceEngine, InferenceServer,
                                         Membership, ResultCache,
                                         RouterServer, ServingClient,
                                         ServingError, TokenBucket)
from test_torch_shared import CFG, numpy_params, torch_model

IN, OUT = "x:0", "out/BiasAdd:0"


def mlp_graph():
    x = nn.placeholder([None, 4], name="x")
    h = nn.dense(x, 3, activation="relu")
    out = nn.dense(h, 2, name="out")
    nn.mean_squared_error(x, out)


@pytest.fixture(scope="module")
def graph_json():
    return build_graph(mlp_graph)


@pytest.fixture(scope="module")
def weights():
    rs = np.random.RandomState(0)
    return [rs.randn(4, 3).astype(np.float32),
            rs.randn(3).astype(np.float32),
            rs.randn(3, 2).astype(np.float32),
            rs.randn(2).astype(np.float32)]


@pytest.fixture(scope="module")
def manual(weights):
    def fwd(x):
        h = np.maximum(np.asarray(x) @ weights[0] + weights[1], 0.0)
        return h @ weights[2] + weights[3]
    return fwd


@pytest.fixture(scope="module")
def make_engine(graph_json, weights):
    def make():
        return InferenceEngine(graph_json, weights, input_name=IN,
                               output_name=OUT, max_batch=16, device="cpu")
    return make


class SlowEngine:
    """Stub engine whose predict sleeps — the straggler replica."""
    max_batch = 16
    _multi = False
    _in_shapes = [(4,)]

    def __init__(self, delay_s=0.4):
        self.delay_s = delay_s

    def predict(self, x):
        time.sleep(self.delay_s)
        return np.asarray(x)[:, :2]

    def stats(self):
        return {}


# -- circuit breaker ---------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_opens_after_consecutive_failures():
    clk = FakeClock()
    br = CircuitBreaker(failure_threshold=3, recovery_s=5.0, clock=clk)
    assert br.state is BreakerState.CLOSED
    br.record_failure()
    br.record_failure()
    assert br.state is BreakerState.CLOSED and br.allow()
    br.record_failure()
    assert br.state is BreakerState.OPEN
    assert not br.allow()
    assert br.ejections == 1


def test_breaker_success_resets_consecutive_count():
    br = CircuitBreaker(failure_threshold=2, clock=FakeClock())
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state is BreakerState.CLOSED  # never two in a row


def test_breaker_half_open_single_trial_then_close_or_reopen():
    clk = FakeClock()
    br = CircuitBreaker(failure_threshold=1, recovery_s=2.0, clock=clk)
    br.record_failure()
    assert br.state is BreakerState.OPEN and not br.allow()
    clk.t = 2.5
    assert br.allow()          # the single half-open trial
    assert br.state is BreakerState.HALF_OPEN
    assert not br.allow()      # second caller must NOT sneak through
    br.record_failure()        # trial failed -> re-open for another window
    assert br.state is BreakerState.OPEN and not br.allow()
    clk.t = 5.0
    assert br.allow()
    br.record_success()        # trial passed -> closed, traffic resumes
    assert br.state is BreakerState.CLOSED and br.allow()


def test_breaker_trip_forces_open():
    br = CircuitBreaker(failure_threshold=100, clock=FakeClock())
    br.trip()
    assert br.state is BreakerState.OPEN and not br.allow()


# -- token bucket / cache ----------------------------------------------------

def test_token_bucket_sheds_then_refills():
    clk = FakeClock()
    bucket = TokenBucket(rate=10.0, burst=2.0, clock=clk)
    assert bucket.try_acquire()
    assert bucket.try_acquire()
    assert not bucket.try_acquire()   # burst spent, no time has passed
    clk.t = 0.1                       # 10/s * 0.1s = 1 token back
    assert bucket.try_acquire()
    assert not bucket.try_acquire()


def test_result_cache_lru_and_counters():
    cache = ResultCache(max_entries=2)
    k1, k2, k3 = (ResultCache.key(b) for b in (b"a", b"b", b"c"))
    assert cache.get(k1) is None
    cache.put(k1, {"predictions": [1]})
    cache.put(k2, {"predictions": [2]})
    assert cache.get(k1) == {"predictions": [1]}   # refreshes k1's recency
    cache.put(k3, {"predictions": [3]})            # evicts k2, not k1
    assert cache.get(k2) is None
    assert cache.get(k1) is not None
    assert cache.stats() == {"entries": 2, "hits": 2, "misses": 2}


# -- membership --------------------------------------------------------------

def test_membership_picks_least_loaded_and_respects_gates():
    m = Membership(["http://127.0.0.1:1", "http://127.0.0.1:2",
                    "http://127.0.0.1:3"], probe_interval_s=60.0)
    a, b, c = m.replicas
    m.begin_dispatch(a)
    m.begin_dispatch(a)
    m.begin_dispatch(b)
    assert m.pick() is c                      # least loaded wins
    assert m.pick(exclude=[c]) is b           # then next-least
    c.breaker.trip()
    assert m.pick() is b                      # ejected replica skipped
    m.eject(b, "draining")
    assert m.pick() is a                      # unhealthy replica skipped
    m.eject(a)
    assert m.pick() is None                   # nobody left
    assert m.healthy_count() == 0
    m.stop()


def test_membership_snapshot_and_gauges():
    from sparkflow_tpu.utils.metrics import Metrics
    metrics = Metrics()
    m = Membership(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                   probe_interval_s=60.0, metrics=metrics)
    m.record_failure(m.replicas[0], "test")
    m.publish_gauges()
    g = metrics.gauges()
    assert g["router/replica0/error_rate"] == 1.0
    assert g["router/replica0/healthy"] == 1.0   # breaker still closed
    assert g["router/replica1/error_rate"] == 0.0
    rows = m.snapshot()
    assert [r["url"] for r in rows] == ["http://127.0.0.1:1",
                                        "http://127.0.0.1:2"]
    assert rows[0]["failures"] == 1 and rows[0]["breaker"] == "closed"
    m.stop()


def test_generate_pick_prefers_kv_headroom():
    """Generate dispatch ranks replicas by decode KV headroom, not queue
    depth: page-/slot-starved replicas sort last (still dispatchable — the
    replica's own 503 is the real backpressure), unknown headroom after any
    known-positive one. Predict picks are untouched."""
    m = Membership(["http://127.0.0.1:1", "http://127.0.0.1:2",
                    "http://127.0.0.1:3"], probe_interval_s=60.0)
    ra, rb, rc = m.replicas
    ra.decode_pages_free, ra.decode_free_slots = 0, 2    # page-starved
    rb.decode_pages_free, rb.decode_free_slots = 10, 1
    rc.decode_pages_free, rc.decode_free_slots = 40, 3
    assert m.pick(signal="generate") is rc               # most headroom
    assert m.pick(exclude=[rc], signal="generate") is rb
    assert m.pick(exclude=[rb, rc], signal="generate") is ra  # last resort
    rc.queue_depth = 50
    rb.queue_depth = 1   # strict predict order: break the equal-load tie
    assert m.pick(signal="generate") is rc  # queue depth is not the signal
    assert m.pick(signal="predict") is ra   # predict ranking unchanged
    rb.decode_pages_free = -1               # unknown sorts after known
    assert m.pick(exclude=[rc], signal="generate") is rb  # but before starved
    m.stop()


def test_page_starved_replica_keeps_predict_loses_generate(make_engine):
    """End to end: a replica whose decode pool is exhausted stops receiving
    /v1/generate traffic from the router but keeps serving /v1/predict."""
    from sparkflow_tpu_torch.convert import params_from_jax
    from sparkflow_tpu_torch.serving import ContinuousBatcher, DecodeEngine
    model = torch_model()
    params = params_from_jax(model, numpy_params(model.param_specs(), 0))
    engines = [DecodeEngine(model, params, num_slots=2, page_size=8, seed=0)
               for _ in range(2)]
    cbs = [ContinuousBatcher(e, max_queue=8) for e in engines]
    servers = [InferenceServer(make_engine(), generate_batcher=cb,
                               max_delay_ms=1.0).start() for cb in cbs]
    # starve replica 0's decode plane before the router ever probes it:
    # every slot (and its page reservation) is occupied, nothing decodes
    for slot in range(2):
        engines[0].kv.alloc(slot, 1, engines[0].max_seq_len)
    pre = [e.stats()["prefills"] for e in engines]
    router = RouterServer([s.url for s in servers], probe_interval_s=0.05,
                          dispatch_retries=2).start()
    try:
        m = router.membership
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if (m.replicas[0].decode_free_slots == 0
                    and m.replicas[1].decode_free_slots > 0):
                break
            time.sleep(0.02)
        else:
            pytest.fail("probes never harvested the decode headroom")
        assert m.pick(signal="generate") is m.replicas[1]
        assert m.pick(signal="predict") is m.replicas[0]
        cli = ServingClient(router.url, timeout=60)
        for _ in range(3):
            r = cli.generate([3, 1, 4], max_new_tokens=4)
            assert r["num_tokens"] == 4
        assert engines[0].stats()["prefills"] == pre[0]  # starved: bypassed
        assert engines[1].stats()["prefills"] == pre[1] + 3
        out = cli.predict(np.zeros((2, 4), np.float32))  # predict still up
        assert out.shape == (2, 2)
    finally:
        router.stop()
        for cb in cbs:
            cb.close()
        for s in servers:
            s.stop()


# -- replica /healthz load signal (satellite) --------------------------------

def test_replica_healthz_reports_queue_depth_and_in_flight(make_engine):
    with InferenceServer(make_engine(), max_delay_ms=1.0) as srv:
        health = ServingClient(srv.url).healthz()
        assert health["queue_depth"] == 0
        assert health["in_flight"] == 0
        assert health["status"] == "ok"


# -- client keep-alive + per-request timeout (satellite) ---------------------

def test_client_reuses_keepalive_connection(make_engine):
    with InferenceServer(make_engine(), max_delay_ms=1.0) as srv:
        client = ServingClient(srv.url)
        client.healthz()
        assert len(client._pool._idle) == 1
        conn = client._pool._idle[0]
        client.healthz()
        client.predict(np.zeros((2, 4), np.float32))
        assert client._pool._idle[0] is conn   # same socket, three calls
        client.close()
        assert client._pool._idle == []


def test_client_per_request_timeout():
    with InferenceServer(SlowEngine(0.5), max_delay_ms=0.0) as srv:
        srv._httpd.handle_error = lambda *a: None  # quiet the torn writes
        client = ServingClient(srv.url, retries=0)
        with pytest.raises(OSError):
            client.predict(np.zeros((2, 4), np.float32), timeout_s=0.05)
        out = client.predict(np.zeros((2, 4), np.float32), timeout_s=5.0)
        assert out.shape == (2, 2)


# -- router end to end -------------------------------------------------------

@pytest.fixture()
def fleet(make_engine):
    servers = [InferenceServer(make_engine(), max_delay_ms=1.0).start()
               for _ in range(3)]
    router = RouterServer([s.url for s in servers], probe_interval_s=0.1,
                          recovery_s=0.5, dispatch_retries=4).start()
    yield router, servers
    router.stop()
    for s in servers:
        if s.lifecycle.state is not ServerState.STOPPED:
            s.stop()


def test_router_parity_and_request_id_echo(fleet, manual, rng):
    router, _servers = fleet
    client = ServingClient(router.url)
    x = rng.randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(client.predict(x), manual(x),
                               rtol=1e-4, atol=1e-4)
    full = client.predict_full(x, request_id="rid-router-1")
    assert full["request_id"] == "rid-router-1"
    assert full["x_request_id_header"] == "rid-router-1"
    assert "timing_ms" in full          # the replica's decomposition rides
    assert full["rows"] == 5            # through the router untouched


def test_router_healthz_lists_fleet(fleet):
    router, _servers = fleet
    health = ServingClient(router.url).healthz()
    assert health["status"] == "ok" and health["role"] == "router"
    assert health["healthy_replicas"] == 3
    assert len(health["replicas"]) == 3
    assert all(r["breaker"] == "closed" for r in health["replicas"])


def test_router_400_passes_through_without_retry(fleet):
    router, _servers = fleet
    client = ServingClient(router.url, retries=0)
    with pytest.raises(ServingError) as exc_info:
        client.predict(np.zeros((2, 9), np.float32))  # wrong feature dim
    assert exc_info.value.status == 400
    assert exc_info.value.code == "bad_request"
    metrics = ServingClient(router.url).metrics()
    assert metrics["counters"].get("router/rerouted", 0) == 0


def test_router_admission_token_bucket_sheds(make_engine):
    with InferenceServer(make_engine(), max_delay_ms=1.0) as srv:
        with RouterServer([srv.url], probe_interval_s=60.0,
                          admission_rate=0.001, admission_burst=1.0) as router:
            client = ServingClient(router.url, retries=0)
            assert client.predict(np.zeros((1, 4), np.float32)).shape == (1, 2)
            with pytest.raises(ServingError) as exc_info:
                client.predict(np.zeros((1, 4), np.float32))
            assert exc_info.value.status == 503
            assert exc_info.value.code == "queue_full"
            assert exc_info.value.retry_after is not None
            m = ServingClient(router.url).metrics()
            assert m["counters"]["router/admission_rejections"] == 1


def test_router_sheds_on_inflight_cap(make_engine):
    with InferenceServer(make_engine(), max_delay_ms=1.0) as srv:
        with RouterServer([srv.url], probe_interval_s=60.0,
                          max_inflight=0) as router:
            client = ServingClient(router.url, retries=0)
            with pytest.raises(ServingError) as exc_info:
                client.predict(np.zeros((1, 4), np.float32))
            assert exc_info.value.status == 503
            assert exc_info.value.code == "queue_full"


def test_router_result_cache_hit_skips_replicas(fleet, rng):
    router, _servers = fleet
    router.cache = ResultCache(max_entries=8)
    client = ServingClient(router.url)
    x = rng.randn(2, 4).astype(np.float32)
    first = client.predict_full(x, request_id="miss-1")
    assert "cache" not in first
    second = client.predict_full(x, request_id="hit-1")
    assert second["cache"] == "hit"
    assert second["request_id"] == "hit-1"   # id is per-request, not cached
    assert second["predictions"] == first["predictions"]
    assert router.cache.stats()["hits"] == 1


def test_router_reroutes_on_injected_dispatch_failure(fleet, manual, rng):
    router, _servers = fleet
    client = ServingClient(router.url, retries=0)
    x = rng.randn(3, 4).astype(np.float32)
    with faults.inject("replica.predict", fail_calls=[0]) as spec:
        out = client.predict(x)
    np.testing.assert_allclose(out, manual(x), rtol=1e-4, atol=1e-4)
    assert spec.failures == 1
    m = ServingClient(router.url).metrics()
    assert m["counters"]["router/rerouted"] >= 1


def test_router_dispatch_fault_surfaces_as_500(fleet):
    router, _servers = fleet
    client = ServingClient(router.url, retries=0)
    with faults.inject("router.dispatch", fail_calls=[0]):
        with pytest.raises(ServingError) as exc_info:
            client.predict(np.zeros((1, 4), np.float32))
    assert exc_info.value.status == 500
    assert exc_info.value.code == "internal"


def test_router_all_replicas_down_returns_structured_503(make_engine):
    srv = InferenceServer(make_engine(), max_delay_ms=1.0).start()
    router = RouterServer([srv.url], probe_interval_s=0.05,
                          dispatch_retries=1,
                          failure_threshold=1).start()
    try:
        srv.kill()
        time.sleep(0.2)  # let the prober notice
        client = ServingClient(router.url, retries=0)
        with pytest.raises(ServingError) as exc_info:
            client.predict(np.zeros((1, 4), np.float32))
        assert exc_info.value.status == 503
        assert exc_info.value.code in ("no_healthy_replicas", "draining")
        assert exc_info.value.retry_after is not None
    finally:
        router.stop()


def test_router_spans_carry_request_id(make_engine):
    tracer = Tracer()
    with InferenceServer(make_engine(), max_delay_ms=1.0) as srv:
        with RouterServer([srv.url], probe_interval_s=60.0,
                          tracer=tracer) as router:
            ServingClient(router.url).predict_full(
                np.zeros((1, 4), np.float32), request_id="span-rid")
    names = {}
    for sp in tracer.spans():
        names.setdefault(sp.name, sp)
    req = names.get("router/request")
    assert req is not None and req.args["request_id"] == "span-rid"
    dispatch = names.get("router/dispatch")
    assert dispatch is not None and dispatch.parent_id is not None


def test_router_prometheus_exposes_per_replica_gauges(fleet):
    router, _servers = fleet
    client = ServingClient(router.url)
    client.predict(np.zeros((1, 4), np.float32))
    text = client.metrics_prometheus()
    assert "router_replica0_healthy 1.0" in text
    assert "router_replica1_ejected 0.0" in text
    assert "router_replica2_error_rate" in text
    assert "router_requests" in text


def test_router_hedges_around_straggler_replica(make_engine, manual, rng):
    slow = InferenceServer(SlowEngine(0.6), max_delay_ms=0.0).start()
    slow._httpd.handle_error = lambda *a: None  # hedge losers tear sockets
    fast = InferenceServer(make_engine(), max_delay_ms=1.0).start()
    router = RouterServer([slow.url, fast.url], probe_interval_s=60.0,
                          hedge=True, hedge_delay_ms=50.0,
                          dispatch_retries=1).start()
    try:
        client = ServingClient(router.url)
        x = rng.randn(2, 4).astype(np.float32)
        t0 = time.perf_counter()
        out = client.predict(x)        # primary -> slow (index 0), hedged
        elapsed = time.perf_counter() - t0
        np.testing.assert_allclose(out, manual(x), rtol=1e-4, atol=1e-4)
        assert elapsed < 0.55          # did NOT wait out the straggler
        m = ServingClient(router.url).metrics()
        assert m["counters"]["router/hedges"] >= 1
        assert m["counters"]["router/hedge_wins"] >= 1
    finally:
        router.stop()
        fast.stop()
        slow.kill()                    # its worker is mid-sleep; don't drain


# -- drain under load (satellite) --------------------------------------------

def test_drain_under_load_sigterm_ejects_and_reroutes(make_engine, manual):
    """SIGTERM one replica mid-burst: every in-flight request completes, the
    router ejects it on the Draining 503, and retried requests land on the
    survivor — zero client-visible failures."""
    victim = InferenceServer(make_engine(), max_delay_ms=1.0).start()
    survivor = InferenceServer(make_engine(), max_delay_ms=1.0).start()
    assert victim.install_signal_handlers()
    router = RouterServer([victim.url, survivor.url], probe_interval_s=0.1,
                          dispatch_retries=4).start()
    errors, done = [], []

    def worker(k):
        client = ServingClient(router.url, retries=0)
        local = np.random.RandomState(k)
        for j in range(10):
            x = local.randn(1 + j % 3, 4).astype(np.float32)
            try:
                np.testing.assert_allclose(client.predict(x), manual(x),
                                           rtol=1e-4, atol=1e-4)
                done.append(1)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
        client.close()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)                       # burst is in flight
        os.kill(os.getpid(), signal.SIGTERM)   # real preemption signal
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[:3]
        assert len(done) == 40
        deadline = time.time() + 5
        while (victim.lifecycle.state is not ServerState.DRAINING
               and time.time() < deadline):
            time.sleep(0.02)
        assert victim.lifecycle.state is ServerState.DRAINING
        health = ServingClient(router.url).healthz()
        assert health["healthy_replicas"] >= 1
        victim_row = next(r for r in health["replicas"]
                          if r["url"] == victim.url)
        assert not victim_row["healthy"]       # ejected from rotation
    finally:
        router.stop()
        survivor.stop()
        victim.stop()                          # also restores the handler


# -- the pinned acceptance test ----------------------------------------------

def test_chaos_fleet_kill_restart_zero_client_failures(make_engine, manual):
    """3 replicas under sustained load; one is hard-killed mid-burst and
    later restarted on the same port. Every request must succeed (router
    retries absorb the failure) and every response must echo its
    originating X-Request-Id end to end."""
    servers = [InferenceServer(make_engine(), max_delay_ms=1.0).start()
               for _ in range(3)]
    victim_port = servers[0].port
    router = RouterServer([s.url for s in servers], probe_interval_s=0.1,
                          recovery_s=0.3, dispatch_retries=5).start()
    errors, echoes = [], []
    stop_load = threading.Event()

    def worker(k):
        client = ServingClient(router.url, retries=0)
        local = np.random.RandomState(1000 + k)
        for j in range(14):
            rid = f"chaos-{k}-{j}"
            x = local.randn(1 + j % 4, 4).astype(np.float32)
            try:
                full = client.predict_full(x, request_id=rid,
                                           timeout_s=30.0)
                np.testing.assert_allclose(np.asarray(full["predictions"]),
                                           manual(x), rtol=1e-4, atol=1e-4)
                echoes.append((rid, full["request_id"],
                               full["x_request_id_header"]))
            except Exception as exc:  # noqa: BLE001
                errors.append((rid, exc))
        client.close()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.1)
        servers[0].kill()                               # SIGKILL semantics
        time.sleep(0.3)
        servers[0] = InferenceServer(make_engine(), port=victim_port,
                                     max_delay_ms=1.0).start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stop_load.set()
        # zero client-visible failures: the router absorbed the kill
        assert not errors, f"{len(errors)} failed, first: {errors[:3]}"
        assert len(echoes) == 6 * 14
        # every response echoed its originating request id, body and header
        for rid, body_rid, header_rid in echoes:
            assert body_rid == rid and header_rid == rid
        # the restarted replica rejoins the rotation
        deadline = time.time() + 10
        health = None
        while time.time() < deadline:
            health = ServingClient(router.url).healthz()
            if health["healthy_replicas"] == 3:
                break
            time.sleep(0.1)
        assert health is not None and health["healthy_replicas"] == 3, health
        m = ServingClient(router.url).metrics()
        assert m["counters"]["router/http_200"] >= 6 * 14
    finally:
        router.stop()
        for s in servers:
            if s.lifecycle.state is not ServerState.STOPPED:
                s.stop()


# -- graftcheck keeps the router's shared state clean ------------------------

PORT_SERVING = os.path.join(os.path.dirname(__file__), os.pardir,
                            "sparkflow_tpu_torch", "serving")


@pytest.mark.parametrize("fname", ["router.py", "membership.py",
                                   "autoscaler.py", "coldstart.py",
                                   "client.py", "server.py", "batcher.py"])
def test_router_lock_lint_is_clean(fname):
    """GC-L301/302/303 (the JAX package's lock lint) over the port's fleet
    layer: the same concurrency conventions as the JAX serving stack."""
    from sparkflow_tpu.analysis.locks import lint_paths
    findings = lint_paths([os.path.join(PORT_SERVING, fname)])
    assert findings == [], [str(f) for f in findings]


# -- interchange: each package's router in front of the other's replicas -----

def _jax_lm_replica(npp, jax_engine):
    import jax
    import jax.numpy as jnp
    from sparkflow_tpu.models.registry import (build_registry_spec,
                                               model_from_json)
    from sparkflow_tpu.serving import (ContinuousBatcher as JaxCB,
                                       DecodeEngine as JaxDE,
                                       InferenceServer as JaxServer)
    jm = model_from_json(build_registry_spec("transformer_lm", **CFG))
    de = JaxDE(jm, jax.tree.map(jnp.asarray, npp), num_slots=2,
               page_size=8, seed=0)
    cb = JaxCB(de, max_queue=8)
    return JaxServer(jax_engine, generate_batcher=cb,
                     max_delay_ms=1.0).start(), cb


def _torch_lm_replica(npp, engine):
    from sparkflow_tpu_torch.convert import params_from_jax
    from sparkflow_tpu_torch.serving import ContinuousBatcher, DecodeEngine
    tm = torch_model()
    de = DecodeEngine(tm, params_from_jax(tm, npp), num_slots=2,
                      page_size=8, seed=0)
    cb = ContinuousBatcher(de, max_queue=8)
    return InferenceServer(engine, generate_batcher=cb,
                           max_delay_ms=1.0).start(), cb


def test_routers_interchange_with_the_jax_package(graph_json, weights, rng):
    """The JAX RouterServer in front of port replicas, and the port's in
    front of JAX replicas: predictions within 1e-5 of both engines, greedy
    tokens identical through either hop."""
    from sparkflow_tpu.serving import (InferenceEngine as JaxEngine,
                                       RouterServer as JaxRouter,
                                       ServingClient as JaxClient)
    jeng = JaxEngine(graph_json, weights, input_name=IN, output_name=OUT,
                     max_batch=16)
    teng = InferenceEngine(graph_json, weights, input_name=IN,
                           output_name=OUT, max_batch=16, device="cpu")
    npp = numpy_params(torch_model().param_specs(), seed=2)
    port_reps = [_torch_lm_replica(npp, teng) for _ in range(2)]
    jax_reps = [_jax_lm_replica(npp, jeng) for _ in range(2)]
    routers = [JaxRouter([s.url for s, _ in port_reps],
                         probe_interval_s=0.1).start(),
               RouterServer([s.url for s, _ in jax_reps],
                            probe_interval_s=0.1).start()]
    try:
        x = rng.randn(7, 4).astype(np.float32)
        want_t, want_j = teng.predict(x), np.asarray(jeng.predict(x))
        prompts = [[5, 2, 8], list(range(1, 20)), [33, 7]]
        tokens = []
        for router, client_cls in zip(routers, (JaxClient, ServingClient)):
            cli = client_cls(router.url, timeout=60)
            got = np.asarray(cli.predict(x))
            np.testing.assert_allclose(got, want_t, rtol=0, atol=1e-5)
            np.testing.assert_allclose(got, want_j, rtol=0, atol=1e-5)
            tokens.append([cli.generate(p, max_new_tokens=6)["tokens"]
                           for p in prompts])
        assert tokens[0] == tokens[1]
        assert len({tuple(t) for t in tokens[0]}) > 1
        # each router really spread its generations over both replicas
        for router in routers:
            rows = router.membership.snapshot()
            assert all(r["successes"] >= 1 for r in rows), rows
    finally:
        for router in routers:
            router.stop()
        for srv, cb in port_reps + jax_reps:
            cb.close()
            srv.stop()


def test_healthz_carries_every_key_membership_harvests(make_engine):
    """The port's ``/healthz`` has the JAX server's keys (top level, trace
    and decode blocks), and a port ``Membership`` probe harvests each of
    them from a port decode replica, speculative accept rate included."""
    from sparkflow_tpu.serving import InferenceEngine as JaxEngine
    from sparkflow_tpu_torch.convert import params_from_jax
    from sparkflow_tpu_torch.serving import ContinuousBatcher, DecodeEngine
    npp = numpy_params(torch_model().param_specs(), seed=2)
    port_srv, port_cb = _torch_lm_replica(npp, make_engine())
    jax_srv, jax_cb = _jax_lm_replica(npp, JaxEngine(
        build_graph(mlp_graph), [np.zeros((4, 3), np.float32),
                                 np.zeros(3, np.float32),
                                 np.zeros((3, 2), np.float32),
                                 np.zeros(2, np.float32)],
        input_name=IN, output_name=OUT, max_batch=4))
    tm = torch_model()
    spec_eng = DecodeEngine(tm, params_from_jax(tm, npp), num_slots=2,
                            page_size=8, seed=0, spec_k=2)
    spec_cb = ContinuousBatcher(spec_eng, max_queue=8)
    spec_srv = InferenceServer(make_engine(), generate_batcher=spec_cb,
                               max_delay_ms=1.0).start()
    m = Membership([port_srv.url, spec_srv.url], probe_interval_s=60.0)
    try:
        ServingClient(spec_srv.url).generate([3, 1, 4], max_new_tokens=4)
        mine = ServingClient(port_srv.url).healthz()
        theirs = ServingClient(jax_srv.url).healthz()
        assert set(mine) == set(theirs)
        assert set(mine["trace"]) == set(theirs["trace"])
        assert set(mine["decode"]) == set(theirs["decode"])
        m.probe_all()
        plain, spec = m.replicas
        for r in (plain, spec):
            assert r.healthy and r.queue_depth == 0
            assert r.reported_in_flight == 0 and r.version == 0
            assert r.decode_free_slots == 2 and r.decode_pages_free > 0
            assert r.kv_dtype == mine["decode"]["kv_dtype"]
            assert r.kv_bytes_per_page == mine["decode"]["kv_bytes_per_page"]
            assert r.kv_bytes_per_page > 0
            assert (r.tp, r.ep, r.pp, r.mesh_shape) == (1, 1, 1, None)
            assert r.trace_process == ServingClient(
                r.url).healthz()["trace"]["process"]
        assert plain.decode_spec_accept_rate == -1.0
        assert spec.decode_spec_accept_rate >= 0.0
    finally:
        m.stop()
        for srv, cb in ((port_srv, port_cb), (jax_srv, jax_cb),
                        (spec_srv, spec_cb)):
            cb.close()
            srv.stop()
