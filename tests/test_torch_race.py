"""PyTorch port, the runtime trackers on the port's threaded paths: the
lockset race detector (``analysis/racecheck.py``) and the resource tracker
(``analysis/restrack.py``), both carried byte for byte from the JAX
package, installed over

- the decode drain under load (``examples/race_smoke.py``'s scenario): a
  ``ContinuousBatcher`` admitting, stepping and retiring against a port
  ``DecodeEngine`` while client threads submit and a drain lands
  mid-burst; every accepted request's greedy tokens equal JAX's
  ``DecodeEngine`` on the same numpy-drawn weights;
- the swap paths (``tests/test_weightstore.py``'s race test): predict
  against watcher-driven swaps on an ``InferenceEngine``, and generates
  against five deferred swaps on a served ``DecodeEngine``;
- the elastic engine's ``run_threads``, which instruments its store itself;

plus the no-op contract without a tracker and the environment switches.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import (CFG, PAGE, _drive, jax_model, numpy_params,
                               torch_model)
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
import sparkflow_tpu_torch.nn as nn
from sparkflow_tpu_torch.analysis import racecheck, restrack
from sparkflow_tpu_torch.convert import list_to_params, params_from_jax
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.optimizers import build_optimizer
from sparkflow_tpu_torch.parallel.elastic import ElasticDPEngine
from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                         Draining, InferenceEngine,
                                         WeightStore, WeightWatcher)

VOCAB = CFG["vocab_size"]
WORKERS, REQUESTS = 4, 4          # examples/race_smoke.py's burst
SWAPS = 5


def _request(k, j):
    """Client ``k``'s ``j``-th request of the race-smoke burst."""
    return [(7 * k + j) % VOCAB, (3 + j) % VOCAB, 11], 4 + 3 * (j % 3)


@pytest.fixture(scope="module")
def weights():
    jm = jax_model()
    specs = jm.param_specs()
    trees = [numpy_params(specs, seed=s) for s in range(SWAPS + 1)]
    return jm, trees


@pytest.fixture(scope="module")
def jax_engine(weights):
    jm, trees = weights
    return JaxDecodeEngine(jm, jax.tree.map(jnp.asarray, trees[0]),
                           num_slots=4, page_size=PAGE, seed=0,
                           prefill_chunk=8)


@pytest.fixture(scope="module")
def jax_burst_tokens(jax_engine):
    return {(k, j): _drive(jax_engine, *_request(k, j))[0]
            for k in range(WORKERS) for j in range(REQUESTS)}


def _port_engine(trees, version=0, **kw):
    tm = torch_model()
    return DecodeEngine(tm, params_from_jax(tm, trees[version]),
                        num_slots=4, page_size=PAGE, seed=0, **kw)


# -- the decode drain under load ---------------------------------------------


def test_decode_drain_under_load_is_race_free_and_balanced(
        weights, jax_burst_tokens):
    """The race-smoke scenario: each client submits two requests, the
    drain begins while they run, a post-drain submit is refused, and each
    client's last two submits are refused with ``Draining``."""
    _jm, trees = weights
    tracker = racecheck.RaceTracker().install()
    retracker = restrack.ResourceTracker().install()
    try:
        engine = _port_engine(trees, prefill_chunk=8)
        # instrument before the batcher starts its worker thread, so every
        # thread only ever takes the wrapped locks
        racecheck.instrument_object(
            engine, fields=("_steps", "_tokens_out", "_prefills"),
            name="DecodeEngine")
        racecheck.instrument_object(
            engine.kv, fields=("_prefix_lookups", "_prefix_hits",
                               "_tokens_saved"), name="PagedKVCache")
        racecheck.instrument_object(engine.metrics, name="Metrics")
        restrack.instrument_engine(engine)
        batcher = ContinuousBatcher(engine, max_queue=64)
        restrack.instrument_batcher(batcher)

        accepted, refused, mu = {}, [], threading.Lock()
        half = threading.Barrier(WORKERS + 1)
        drained = threading.Event()

        def client(k):
            for j in range(REQUESTS):
                if j == REQUESTS // 2:
                    half.wait(timeout=30)
                    drained.wait(timeout=30)
                prompt, budget = _request(k, j)
                try:
                    f = batcher.submit(prompt, max_new_tokens=budget,
                                       request_id=f"race-{k}-{j}")
                    with mu:
                        accepted[k, j] = f
                except Draining:
                    with mu:
                        refused.append((k, j))
                time.sleep(0.005)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(WORKERS)]
        for t in threads:
            t.start()
        half.wait(timeout=30)          # every client has two in the queue
        live = sum(not f.done() for f in accepted.values())
        batcher.begin_drain()
        with pytest.raises(Draining):
            batcher.submit([1, 2, 3], max_new_tokens=2)
        drained.set()
        for t in threads:
            t.join()
        assert batcher.wait_drained(timeout=60.0), "drain did not complete"
        batcher.close()
    finally:
        tracker.uninstall()
        retracker.uninstall()
    assert live > 0, "the drain found no generation in flight"
    assert sorted(accepted) == [(k, j) for k in range(WORKERS)
                                for j in range(REQUESTS // 2)]
    assert sorted(refused) == [(k, j) for k in range(WORKERS)
                               for j in range(REQUESTS // 2, REQUESTS)]
    for key, f in accepted.items():
        out = f.result(timeout=60.0)
        assert out["num_tokens"] == len(out["tokens"]) == _request(*key)[1]
        assert out["tokens"] == jax_burst_tokens[key], key
    tracker.assert_clean()
    retracker.assert_balanced()
    assert len(tracker._fields) >= 6
    assert retracker.acquired == retracker.released > 0
    assert engine.kv.stats()["pages_used"] == 0


# -- the swap paths -----------------------------------------------------------


IN, OUT = "x:0", "out/BiasAdd:0"


def _mlp_graph():
    x = nn.placeholder([None, 4], name="x")
    h = nn.dense(x, 3, activation="relu")
    out = nn.dense(h, 2, name="out")
    nn.mean_squared_error(x, out)


def _mlp_weights(seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(4, 3).astype(np.float32),
            rs.randn(3).astype(np.float32),
            rs.randn(3, 2).astype(np.float32),
            rs.randn(2).astype(np.float32)]


def test_predict_swap_path_race_clean_under_lockset_detector(tmp_path):
    """Predict from one thread while a watcher lands five versions: the
    double-buffered swap holds under the detector."""
    store = WeightStore(str(tmp_path))
    graph = build_graph(_mlp_graph)
    eng = InferenceEngine(graph, _mlp_weights(0), input_name=IN,
                          output_name=OUT, max_batch=4, device="cpu")
    watcher = WeightWatcher(store, [eng], poll_interval_s=0.001)
    x = np.zeros((2, 4), np.float32)
    with racecheck.RaceTracker() as tracker:
        racecheck.instrument_object(
            eng, fields=("_copies", "_serving_version", "_swaps"))
        stop = threading.Event()

        def serve():
            while not stop.is_set():
                eng.predict(x)

        t = threading.Thread(target=serve)
        t.start()
        try:
            for s in range(1, SWAPS + 1):
                store.publish(list_to_params(eng.model, _mlp_weights(s)))
                watcher.poll_once()
        finally:
            stop.set()
            t.join()
    tracker.assert_clean()
    assert eng.serving_version() == SWAPS
    fresh = InferenceEngine(graph, _mlp_weights(SWAPS), input_name=IN,
                            output_name=OUT, max_batch=4, device="cpu")
    xs = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(eng.predict(xs)),
                                  np.asarray(fresh.predict(xs)))


def test_decode_swap_path_race_clean_under_lockset_detector(
        weights, jax_engine, tmp_path):
    """A batcher serves generates while a watcher lands five versions,
    each deferred to a drained token boundary: the detector sees the
    pending swap, the weights and the counters guarded, and the engine
    ends at version 5 with tokens equal to JAX's on it."""
    jm, trees = weights
    store = WeightStore(str(tmp_path))
    tm = torch_model()
    with racecheck.RaceTracker() as tracker:
        eng = _port_engine(trees)
        racecheck.instrument_object(
            eng, fields=("_params", "_pending_swap", "_serving_version",
                         "_swaps"), name="DecodeEngine")
        watcher = WeightWatcher(store, [eng], poll_interval_s=0.001)
        batcher = ContinuousBatcher(eng, max_queue=64)
        stop, errors = threading.Event(), []

        def serve(k):
            i = 0
            while not stop.is_set():
                try:
                    batcher.submit([1 + k, 2 + i % 7, 3],
                                   max_new_tokens=3).result(timeout=30)
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)
                i += 1

        threads = [threading.Thread(target=serve, args=(k,))
                   for k in range(2)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)       # more interleavings per swap
        for t in threads:
            t.start()
        try:
            for s in range(1, SWAPS + 1):
                store.publish(params_from_jax(tm, trees[s]))
                watcher.poll_once()
                time.sleep(0.01)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        batcher.close()
        watcher.poll_once()          # nudges a swap still pending
    tracker.assert_clean()
    assert not errors, errors[:3]
    assert eng.serving_version() == SWAPS
    assert not eng.stats()["pending_swap"]
    jax_engine.swap_params(jax.tree.map(jnp.asarray, trees[SWAPS]))
    prompt = [5, 2, 8, 9]
    assert _drive(eng, prompt, 6)[0] == _drive(jax_engine, prompt, 6)[0]
    jax_engine.swap_params(jax.tree.map(jnp.asarray, trees[0]))


# -- the elastic engine's run_threads -----------------------------------------


def test_elastic_run_threads_clean_under_tracker():
    """``run_threads`` instruments its store when a tracker is active; the
    real protocol is race-free."""
    def loss_fn(params, x, y, mask, generator):
        return torch.mean((x @ params["w"] - y) ** 2)

    rs = np.random.RandomState(0)
    X = rs.rand(64, 3).astype(np.float32)
    Y = (X @ np.array([[1.0], [-1.0], [0.5]], np.float32)).astype(np.float32)
    eng = ElasticDPEngine(loss_fn, build_optimizer("gradient_descent", 0.05),
                          {"w": torch.zeros(3, 1)})
    with racecheck.RaceTracker() as tracker:
        res = eng.run_threads([(X[0::2], Y[0::2]), (X[1::2], Y[1::2])],
                              epochs=3, batch_size=16, seed=0)
    assert res.examples > 0
    tracker.assert_clean()
    # the instrumentation engaged: the store's fields were tracked
    assert any("_version" in fs.label for fs in tracker._fields.values())


# -- the no-op contract and the environment switches --------------------------


class _Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0


def test_racecheck_noop_without_tracker():
    # with no tracker installed the object is untouched: same class, raw
    # lock, no tracking properties
    assert racecheck.active() is None
    c = _Counter()
    cls_before, lock_before = type(c), c._lock
    racecheck.instrument_object(c, fields=("n",))
    assert type(c) is cls_before and c._lock is lock_before
    assert racecheck.tracked(c, "n") is c
    assert type(c) is cls_before


def test_restrack_noop_without_tracker(weights):
    assert restrack.active() is None
    eng = _port_engine(weights[1])
    prefill, release = eng.prefill, eng.release
    assert restrack.instrument_engine(eng) is eng
    assert eng.prefill == prefill and eng.release == release
    batcher = ContinuousBatcher(eng, max_queue=4)
    admit = batcher._try_admit_locked
    assert restrack.instrument_batcher(batcher) is batcher
    assert batcher._try_admit_locked == admit
    batcher.close()


@pytest.mark.parametrize("module,var", [
    (racecheck, "SPARKFLOW_TPU_RACECHECK"),
    (restrack, "SPARKFLOW_TPU_RESTRACK")], ids=["racecheck", "restrack"])
def test_environment_switch(module, var, monkeypatch):
    monkeypatch.delenv(var, raising=False)
    assert not module.enabled()
    monkeypatch.setenv(var, "1")
    assert module.enabled()
    monkeypatch.setenv(var, "0")
    assert not module.enabled()
