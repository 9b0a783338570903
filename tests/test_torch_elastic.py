"""PyTorch port, bounded-staleness elastic async data parallelism
(``parallel.elastic``), its ``Trainer(strategy="elastic_dp")`` and
``HogwildSparkModel`` entries and the ``RWLock``, against the JAX package's
on the CPU.

The gradient codec's indices equal JAX's bit for bit. The store's rules
(staleness bound, dampening, leases) are held on the JAX suite's cases,
number for number. ``run_virtual`` replays stragglers, a mid-step
preemption, late joins and injected delays / drops on both engines with the
same specs and data: accepted, rejected, dropped and final version equal
exactly, final params within 1e-5. A pulled parameter tree is bit-identical
after later pushes (the store publishes a fresh tree per version).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkflow_tpu.parallel.elastic import ElasticDPEngine as JaxEngine
from sparkflow_tpu.parallel.elastic import ReplicaSpec as JaxSpec
from sparkflow_tpu.parallel.elastic import encode_grads as jax_encode
from sparkflow_tpu.resilience import faults as jax_faults
from sparkflow_tpu.utils.metrics import Metrics as JaxMetrics
from sparkflow_tpu_torch.optimizers import build_optimizer
from sparkflow_tpu_torch.parallel import (ElasticDPEngine, ElasticParamStore,
                                          ReplicaSpec, SparseRows,
                                          decode_grads, encode_grads)
from sparkflow_tpu_torch.resilience import faults
from sparkflow_tpu_torch.utils.metrics import Metrics

N, D = 256, 4


def _problem():
    rs = np.random.RandomState(0)
    X = rs.rand(N, D).astype(np.float32)
    w = np.array([[1.0], [-2.0], [3.0], [0.5]], np.float32)
    Y = X @ w + 0.01 * rs.randn(N, 1).astype(np.float32)
    return X, Y


def _jax_loss(params, x, y, mask, rng):
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def _loss(params, x, y, mask, generator):
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


def _shards(X, Y, k):
    return [(X[i::k], Y[i::k]) for i in range(k)]


def _engines(**kw):
    """(the JAX engine, the port's) on the same problem: adam 0.05 from
    zero weights."""
    return (JaxEngine(_jax_loss, optax.adam(0.05),
                      {"w": jnp.zeros((D, 1)), "b": jnp.zeros((1,))},
                      metrics=JaxMetrics(), **kw),
            ElasticDPEngine(_loss, build_optimizer("adam", 0.05),
                            {"w": torch.zeros(D, 1), "b": torch.zeros(1)},
                            metrics=Metrics(), **kw))


# -- the dense/sparse codec ------------------------------------------------------

def test_encode_matches_jax_bit_for_bit():
    """Random row-sparse and dense leaves, several thresholds: the same
    leaves go sparse, with the same int32 indices and values and the same
    byte counts as the JAX codec; decode gives the gradient back."""
    rs = np.random.RandomState(1)
    for trial in range(6):
        g = {"emb": np.zeros((64, 8), np.float32),
             "w": rs.randn(5, 5).astype(np.float32),
             "b": rs.randn(7).astype(np.float32),
             "head": {"k": np.zeros((10, 3), np.float32)}}
        rows = rs.choice(64, size=rs.randint(0, 30), replace=False)
        g["emb"][rows] = rs.randn(rows.size, 8)
        g["head"]["k"][rs.randint(0, 10)] = 1.0
        thr = [0.25, 0.5, None, 0.0, 0.1, 1.0][trial]
        want, wdb, wwb = jax_encode(g, thr)
        got, db, wb = encode_grads(
            {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in g.items()}, thr)
        assert (db, wb) == (wdb, wwb)
        for name, ours, theirs in (("emb", got["emb"], want["emb"]),
                                   ("w", got["w"], want["w"]),
                                   ("k", got["head"]["k"], want["head"]["k"])):
            assert isinstance(ours, SparseRows) == hasattr(theirs,
                                                           "indices"), name
            if isinstance(ours, SparseRows):
                assert ours.indices.dtype == torch.int32
                np.testing.assert_array_equal(ours.indices.numpy(),
                                              theirs.indices)
                np.testing.assert_array_equal(ours.values.numpy(),
                                              theirs.values)
        dec = decode_grads(got)
        np.testing.assert_array_equal(dec["emb"].numpy(), g["emb"])
        np.testing.assert_array_equal(dec["head"]["k"].numpy(), g["head"]["k"])


def test_sparse_push_matches_dense_push():
    params = {"emb": torch.zeros(20, 4), "w": torch.zeros(3, 3)}
    g = {"emb": torch.zeros(20, 4), "w": torch.ones(3, 3)}
    g["emb"][5] = 2.0
    outs = []
    for grads in (g, encode_grads(g, 0.25)[0]):
        store = ElasticParamStore(params, build_optimizer(
            "gradient_descent", 0.1), metrics=Metrics())
        store.join("r0")
        res = store.push("r0", grads, 0)
        assert res.accepted
        outs.append(res.params)
    assert isinstance(encode_grads(g, 0.25)[0]["emb"], SparseRows)
    for k in params:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=1e-7)


# -- the store's rules -----------------------------------------------------------

def _sgd_store(**kw):
    kw.setdefault("metrics", Metrics())
    return ElasticParamStore({"w": torch.zeros(2)},
                             build_optimizer("gradient_descent", 1.0), **kw)


def _g(v=1.0):
    return {"w": torch.full((2,), v)}


def test_staleness_bound_enforced():
    store = _sgd_store(max_staleness=2, dampening="none")
    store.join("fast")
    store.join("slow")
    v0, _ = store.pull("slow")
    for _ in range(3):
        v, _p = store.pull("fast")
        assert store.push("fast", _g(), v).accepted
    res = store.push("slow", _g(), v0)
    assert not res.accepted and res.reason == "stale" and res.staleness == 3
    assert res.version == 3 and res.params is not None
    res2 = store.push("slow", _g(), res.version)
    assert res2.accepted and res2.staleness == 0
    assert store.version == 4


def test_dampening_scales_the_update_by_staleness():
    store = _sgd_store(max_staleness=5, dampening="inverse")
    store.join("a")
    store.join("b")
    va, _ = store.pull("a")
    for _ in range(3):
        v, _p = store.pull("b")
        store.push("b", _g(0.0), v)
    res = store.push("a", _g(1.0), va)  # staleness 3 -> scale 1/4
    assert res.accepted and res.scale == pytest.approx(0.25)
    np.testing.assert_allclose(res.params["w"].numpy(), [-0.25, -0.25],
                               atol=1e-6)
    store2 = _sgd_store(max_staleness=5, dampening=lambda s: 0.5)
    store2.join("a")
    assert store2.push("a", _g(1.0), 0).scale == pytest.approx(0.5)
    with pytest.raises(ValueError, match="dampening"):
        _sgd_store(dampening="bogus")
    with pytest.raises(ValueError, match="max_staleness"):
        _sgd_store(max_staleness=-1)


def test_lease_expiry_and_rejoin():
    t = [0.0]
    store = _sgd_store(lease_ttl_s=5.0, clock=lambda: t[0])
    v, _ = store.join("r0")
    assert store.alive_count() == 1
    t[0] = 3.0
    assert store.heartbeat("r0")
    t[0] = 9.1
    res = store.push("r0", _g(), v)
    assert not res.accepted and res.reason == "lease_expired"
    assert store.alive_count() == 0 and store.evictions == 1
    v2, _ = store.join("r0")
    assert store.push("r0", _g(), v2).accepted
    assert not store.heartbeat("ghost")


def test_membership_and_metrics_published():
    m = Metrics()
    store = ElasticParamStore({"w": torch.zeros(2)},
                              build_optimizer("gradient_descent", 1.0),
                              metrics=m, max_staleness=3)
    store.join("a")
    store.join("b")
    assert m.gauges()["elastic/replicas"] == 2
    v, _ = store.pull("a")
    store.push("a", _g(), v)
    store.leave("b")
    assert m.gauges()["elastic/replicas"] == 1
    mem = store.membership()
    assert set(mem) == {"a"} and mem["a"].pushes == 1
    assert m.counters()["elastic/push_accepted"] == 1
    assert m.histograms()["elastic/staleness"]["count"] == 1


def test_a_pulled_tree_never_changes_after_a_push():
    """The store publishes a fresh tree per version: a tree pulled (or
    piggybacked) before later pushes is bit-identical after them, and its
    optimizer state too; the store's own tree did move."""
    store = ElasticParamStore({"w": torch.randn(3, 2), "b": torch.zeros(2)},
                              build_optimizer("adam", 0.1), max_staleness=10,
                              metrics=Metrics())
    store.join("a")
    store.join("b")
    v0, held = store.pull("a")
    before = {k: t.clone() for k, t in held.items()}
    _v, _p, state0 = store.snapshot()
    mu0 = state0[0].mu["w"].clone() if isinstance(state0, tuple) else None
    piggy = None
    for i in range(4):
        v, _p = store.pull("b")
        res = store.push("b", {"w": torch.ones(3, 2), "b": torch.ones(2)}, v)
        assert res.accepted
        if i == 0:
            piggy = {k: t.clone() for k, t in res.params.items()}
            piggy_ref = res.params
    for k in held:
        assert torch.equal(held[k], before[k]), k
        assert torch.equal(piggy_ref[k], piggy[k]), k
        assert not torch.equal(store.snapshot()[1][k], before[k])
    if mu0 is not None:
        assert torch.equal(state0[0].mu["w"], mu0)


def test_concurrent_pushes_serialize():
    """8 threads x 25 pushes with a short switch interval: every accepted
    push bumps the version exactly once."""
    import sys
    store = _sgd_store(max_staleness=10**9, dampening="none")
    for i in range(8):
        store.join(f"r{i}")
    accepted = [0] * 8

    def worker(i):
        v, _p = store.pull(f"r{i}")
        for _ in range(25):
            res = store.push(f"r{i}", _g(0.0), v)
            v = res.version
            accepted[i] += int(res.accepted)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert sum(accepted) == 200 == store.version


# -- run_virtual against the JAX engine ------------------------------------------

SCENARIOS = {
    "straggler_10x": (4, [dict(cost_s=c) for c in (1.0, 1.0, 1.0, 10.0)],
                      dict(epochs=20, batch_size=16, deadline_s=60.0),
                      dict(max_staleness=4), None),
    "preempt_mid_step": (4, [dict(cost_s=1.0), dict(cost_s=1.0),
                             dict(cost_s=1.0, preempt_at=5.5, rejoin_at=15.0),
                             dict(cost_s=1.0)],
                         dict(epochs=12, batch_size=16),
                         dict(max_staleness=4, lease_ttl_s=3.0), None),
    "late_join": (3, [dict(cost_s=1.0), dict(cost_s=1.0),
                      dict(cost_s=1.0, join_at=10.0)],
                  dict(epochs=8, batch_size=16), dict(max_staleness=6), None),
    "delay_fault": (2, [dict(cost_s=1.0)] * 2, dict(epochs=2, batch_size=32),
                    dict(max_staleness=10),
                    dict(point="elastic.push", delay_ms=2_000_000.0)),
    "drop_fault": (2, [dict(cost_s=1.0)] * 2, dict(epochs=4, batch_size=32),
                   dict(max_staleness=10),
                   dict(point="elastic.push", fail_calls=(1, 3))),
    "persistent_straggler": (3, [dict(cost_s=1.0), dict(cost_s=1.0),
                                 dict(cost_s=10.0)],
                             dict(epochs=3, batch_size=32),
                             dict(max_staleness=0), None),
}

ACCOUNTING = ("pushes", "accepted", "rejected_stale", "rejected_lease",
              "dropped_stale", "dropped_lease", "dropped_fault", "evictions",
              "final_version", "dense_bytes", "wire_bytes",
              "per_replica_accepted")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_virtual_accounting_equals_jax(name):
    k, specs, run, eng_kw, fault = SCENARIOS[name]
    X, Y = _problem()
    jax_eng, eng = _engines(**eng_kw)
    results = []
    for e, spec_cls, mod in ((jax_eng, JaxSpec, jax_faults),
                             (eng, ReplicaSpec, faults)):
        specs_ = [spec_cls(**s) for s in specs]
        if fault is None:
            results.append(e.run_virtual(_shards(X, Y, k), specs_, seed=0,
                                         **run))
            continue
        f = dict(fault)
        with mod.inject(f.pop("point"), **f):
            results.append(e.run_virtual(_shards(X, Y, k), specs_, seed=0,
                                         **run))
    want, got = results
    for key in ACCOUNTING:
        assert got.stats[key] == want.stats[key], key
    assert got.version == want.version
    assert got.stats["membership_trace"] == [
        (float(t), int(a)) for t, a in want.stats["membership_trace"]]
    assert got.wall_s == pytest.approx(want.wall_s)
    assert got.examples == want.examples
    for key in ("w", "b"):
        np.testing.assert_allclose(got.params[key].numpy(),
                                   np.asarray(want.params[key]), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-5)


def test_single_replica_threads_are_plain_sgd():
    """One replica through ``run_threads``: staleness 0, nothing rejected,
    and the final weights those of plain SGD over the same batches (the
    runner's ``RandomState`` permutation per epoch), step for step."""
    X, Y = _problem()
    eng = ElasticDPEngine(_loss, build_optimizer("gradient_descent", 0.1),
                          {"w": torch.zeros(D, 1), "b": torch.zeros(1)},
                          max_staleness=0, metrics=Metrics())
    res = eng.run_threads(_shards(X, Y, 1), epochs=5, batch_size=32, seed=3)
    assert res.stats["rejected_stale"] == 0
    assert res.stats["accepted"] == res.version == 5 * (N // 32)
    p = {"w": torch.zeros(D, 1), "b": torch.zeros(1)}
    rs = np.random.RandomState(3)
    losses = []
    for _epoch in range(5):
        perm = rs.permutation(N)
        for i in range(N // 32):
            idx = perm[i * 32:(i + 1) * 32]
            leaves = [t.clone().requires_grad_(True) for t in p.values()]
            tree = dict(zip(p, leaves))
            loss = _loss(tree, torch.from_numpy(X[idx]),
                         torch.from_numpy(Y[idx]), None, None)
            grads = torch.autograd.grad(loss, leaves)
            p = {k: t - 0.1 * g for (k, t), g in zip(p.items(), grads)}
            losses.append(float(loss))
    for k in p:
        np.testing.assert_allclose(res.params[k].numpy(), p[k].numpy(),
                                   atol=1e-6, rtol=1e-6)
    assert res.losses[-1] < res.losses[0]


def test_threaded_replicas_converge():
    X, Y = _problem()
    _j, eng = _engines(max_staleness=4)
    res = eng.run_threads(_shards(X, Y, 4), epochs=30, batch_size=16, seed=0)
    assert res.stats["accepted"] == res.version > 0
    assert res.losses[-1] < res.losses[0]
    pred = torch.from_numpy(X) @ res.params["w"] + res.params["b"]
    assert float(torch.mean((pred - torch.from_numpy(Y)) ** 2)) < 0.05


# -- Trainer / Hogwild wiring ----------------------------------------------------

def _xor_graph():
    import sparkflow_tpu_torch.nn as nn
    from sparkflow_tpu_torch.graph_utils import build_graph

    def graph():
        x = nn.placeholder([None, 2], name="x")
        y = nn.placeholder([None, 1], name="y")
        h = nn.dense(x, 8, activation="tanh")
        out = nn.dense(h, 1, name="out")
        nn.sigmoid_cross_entropy(y, out)
    return build_graph(graph)


def _xor_data(n=128):
    rs = np.random.RandomState(0)
    X = rs.rand(n, 2).astype(np.float32)
    Y = ((X[:, 0] > 0.5) ^ (X[:, 1] > 0.5)).astype(np.float32)
    return X, Y


def test_trainer_elastic_dp_trains_and_warm_starts():
    from sparkflow_tpu_torch.trainer import Trainer
    X, Y = _xor_data()
    t = Trainer(_xor_graph(), "x:0", "y:0", optimizer="adam",
                optimizer_options={"learning_rate": 0.05}, iters=20,
                mini_batch_size=16, strategy="elastic_dp",
                elastic={"replicas": 4, "max_staleness": 4}, device="cpu")
    res = t.fit(X, Y)
    assert res.stop_reason == "completed"
    assert res.losses[-1] < res.losses[0]
    s = t.last_elastic_stats
    assert s["accepted"] == s["final_version"] > 0
    assert len(s["per_replica_accepted"]) == 4
    assert len(t.weights_list()) == 4
    res2 = t.fit(X, Y, init_params=t.params)
    assert np.isfinite(res2.losses).all()


def test_trainer_elastic_refusals_and_callbacks(tmp_path, caplog):
    from sparkflow_tpu_torch.trainer import Trainer
    X, Y = _xor_data(64)
    seen = []
    t = Trainer(_xor_graph(), "x:0", "y:0", iters=3, mini_batch_size=16,
                strategy="elastic_dp", elastic={"replicas": 2},
                loss_callback=lambda l, step, rid: seen.append((rid, step)),
                checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    with caplog.at_level("WARNING", logger="sparkflow_tpu_torch"):
        t.fit(X, Y)
    assert "ignores checkpoint_dir" in caplog.text
    assert len(seen) == t.last_elastic_stats["accepted"]
    assert {rid for rid, _s in seen} == {0, 1}
    g = _xor_graph()
    with pytest.raises(ValueError, match="strategy"):
        Trainer(g, "x:0", "y:0", strategy="warp", device="cpu")
    with pytest.raises(ValueError, match="elastic_dp"):
        Trainer(g, "x:0", "y:0", elastic={"replicas": 2}, device="cpu")
    with pytest.raises(ValueError, match="unknown elastic option"):
        Trainer(g, "x:0", "y:0", strategy="elastic_dp",
                elastic={"bogus": 1}, device="cpu")
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        Trainer(g, "x:0", "y:0", strategy="elastic_dp",
                elastic={"replicas": 0}, device="cpu").fit(X, Y)
    import sparkflow_tpu_torch.nn as nn
    from sparkflow_tpu_torch.graph_utils import build_graph

    def two_inputs():
        a = nn.placeholder([None, 2], name="a")
        b = nn.placeholder([None, 2], name="b")
        y = nn.placeholder([None, 1], name="y")
        out = nn.dense(nn.concat([a, b], axis=1), 1, name="out")
        nn.mean_squared_error(y, out)

    with pytest.raises(ValueError, match="single-input models only"):
        Trainer(build_graph(two_inputs), ["a:0", "b:0"], "y:0",
                strategy="elastic_dp", device="cpu").fit((X, X), Y)


def test_hogwild_spark_model_trains_an_rdd():
    """``HogwildSparkModel(...).train(rdd)`` on a 3-partition localml RDD:
    one replica per partition; the reference's server arguments accepted
    and ignored."""
    from sparkflow_tpu_torch.HogwildSparkModel import HogwildSparkModel
    from sparkflow_tpu_torch.localml.sql import RDD
    X, Y = _xor_data(96)
    rdd = RDD(list(zip(X, Y)), 3)
    hw = HogwildSparkModel(tensorflowGraph=_xor_graph(), iters=5,
                           tfInput="x:0", tfLabel="y:0", optimizer="adam",
                           master_url="localhost:5000", serverStartup=8,
                           port=5000, mini_batch=16, device="cpu")
    weights = hw.train(rdd)
    assert len(weights) == 4 and hw.server is None
    assert hw._trainer.elastic["replicas"] == 3
    assert len(hw.elastic_stats["per_replica_accepted"]) == 3
    assert hw.elastic_stats["accepted"] > 0
    hw.stop_server()
    assert hw.train(list(zip(X, Y))) and hw._trainer.elastic["replicas"] == 4


# -- RWLock -----------------------------------------------------------------------

def test_rwlock_readers_share_writers_exclude_and_take_priority():
    from sparkflow_tpu_torch.RWLock import RWLock
    lock = RWLock()
    lock.acquire_read()
    lock.acquire_read()  # readers share
    order = []

    def writer():
        with lock.writing():
            order.append("w")

    def reader():
        with lock.reading():
            order.append("r")

    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.05)  # the writer is waiting now
    r = threading.Thread(target=reader)
    r.start()
    time.sleep(0.05)
    assert order == []  # the late reader queues behind the waiting writer
    lock.release()
    lock.release_read()
    w.join(timeout=10)
    r.join(timeout=10)
    assert not w.is_alive() and not r.is_alive()
    assert order == ["w", "r"]
    with pytest.raises(RuntimeError, match="without a held lock"):
        lock.release()
