"""PyTorch port, live weight publication into a decode server, held
against the JAX package (``tests/test_weightstore.py``'s decode swap tests
and ``examples/swap_smoke.py``'s scenario) on numpy-drawn weights:

- the deferred swap of a ``DecodeEngine``: at the drained token boundary,
  at once when idle, and nudged by the watcher's next poll, with greedy
  tokens equal to JAX's ``DecodeEngine`` before and after;
- a swap staged between the batcher's admission check and its prefill is
  backpressure: the port's batcher requeues the request, which then runs
  on the new weights (JAX's batcher fails it; ROADMAP queue 3);
- the swap-smoke scenario in one process: an ``InferenceServer`` with a
  ``ContinuousBatcher`` over a port ``DecodeEngine`` and a
  ``WeightWatcher`` over a ``WeightStore``, four clients generating while a
  good version and then a corrupt one are published: no client failure,
  the serving version moves 0 -> 1 once, the corrupt version is refused,
  tokens after the swap are those of a fresh engine and of JAX's on the
  good version, and a drain completes the generation in flight.
"""

import threading
import time

import jax
import jax.numpy as jnp
import pytest

from test_torch_shared import PAGE, _drive, jax_model, numpy_params, \
    torch_model
from sparkflow_tpu.serving import ContinuousBatcher as JaxBatcher
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.serving import OutOfPages as JaxOutOfPages
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.resilience import faults
from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                         InferenceServer, ServingClient,
                                         WeightStore, WeightWatcher)
from sparkflow_tpu_torch.serving.client import ServingError

WORKERS, REQUESTS = 4, 6          # examples/swap_smoke.py's burst


@pytest.fixture(scope="module")
def trees():
    specs = jax_model().param_specs()
    return [numpy_params(specs, seed=s) for s in range(3)]


@pytest.fixture(scope="module")
def jax_engine(trees):
    return JaxDecodeEngine(jax_model(), jax.tree.map(jnp.asarray, trees[0]),
                           num_slots=4, page_size=PAGE, seed=0,
                           prefill_chunk=8)


def jax_tokens(jax_engine, tree, prompt, n):
    """Greedy tokens of the JAX engine on ``tree`` (an idle swap lands at
    once); the engine is left on ``tree``."""
    assert jax_engine.swap_params(jax.tree.map(jnp.asarray, tree)) is True
    return _drive(jax_engine, prompt, n)[0]


def _engine(tree, **kw):
    tm = torch_model()
    return DecodeEngine(tm, params_from_jax(tm, tree), num_slots=2,
                        page_size=PAGE, seed=0, **kw)


def _torch_tree(tree):
    return params_from_jax(torch_model(), tree)


# -- the deferred swap (tests/test_weightstore.py's three decode tests) -------


def test_decode_swap_waits_for_token_boundary(trees, jax_engine):
    """A swap requested mid-request defers: admissions hold, the active
    request keeps decoding the old weights to completion, and the swap
    lands at the drained boundary; afterwards the engine decodes as a cold
    one on the new weights, and as JAX's."""
    eng = _engine(trees[0])
    info = eng.prefill([5, 2, 8], max_new_tokens=4, temperature=0.0)
    toks = [info["token"]]
    assert eng.swap_params(_torch_tree(trees[1]), version=1) is False
    st = eng.stats()
    assert st["pending_swap"] and st["serving_version"] == 0
    assert eng.can_admit(3, 2) is False   # admissions hold while pending
    while len(toks) < 4:
        toks.extend(eng.step().get(info["slot"], []))
    eng.release(info["slot"])
    assert toks == jax_tokens(jax_engine, trees[0], [5, 2, 8], 4)
    assert eng.maybe_swap() is True
    assert eng.serving_version() == 1 and eng.can_admit(3, 2) is True
    after = _drive(eng, [5, 2, 8], 4)[0]
    assert after == _drive(_engine(trees[1]), [5, 2, 8], 4)[0]
    assert after == jax_tokens(jax_engine, trees[1], [5, 2, 8], 4)
    assert eng.stats()["steady_traces"] == 0


def test_decode_swap_immediate_when_idle(trees, jax_engine):
    eng = _engine(trees[0])
    assert eng.swap_params(_torch_tree(trees[1]), version=3) is True
    assert eng.serving_version() == 3
    assert not eng.stats()["pending_swap"]
    got = _drive(eng, [1, 2], 3)[0]
    assert got == _drive(_engine(trees[1]), [1, 2], 3)[0]
    assert got == jax_tokens(jax_engine, trees[1], [1, 2], 3)


def test_decode_watcher_nudges_deferred_swap(trees, jax_engine, tmp_path):
    """``poll_once`` nudges ``maybe_swap`` first, so a deferred swap lands
    on the next poll after the engine drains."""
    store = WeightStore(str(tmp_path))
    eng = _engine(trees[0])
    watcher = WeightWatcher(store, [eng], poll_interval_s=0.01)
    info = eng.prefill([4, 4], max_new_tokens=3, temperature=0.0)
    store.publish(_torch_tree(trees[1]))
    # the watcher hands the version off; the engine defers it
    assert watcher.poll_once() is True
    assert eng.stats()["pending_swap"] and watcher.serving_version() == 0
    toks = [info["token"]]
    while len(toks) < 3:
        toks.extend(eng.step().get(info["slot"], []))
    eng.release(info["slot"])
    assert watcher.poll_once() is False   # no new version, but the nudge...
    assert eng.serving_version() == 1     # ...applies the pending swap
    assert watcher.serving_version() == 1
    assert toks == jax_tokens(jax_engine, trees[0], [4, 4], 3)
    assert _drive(eng, [4, 4], 3)[0] == jax_tokens(jax_engine, trees[1],
                                                   [4, 4], 3)


# -- a swap staged after the admission check ----------------------------------


class _SwapBeforePrefill:
    """An engine whose next prefill, once armed, first stages a swap to
    ``tree``: what a watcher does when it lands between the batcher's
    ``can_admit`` and its prefill. A live slot defers the swap."""

    def __init__(self, engine, tree):
        self._engine, self._tree, self.armed = engine, tree, False

    def prefill(self, *args, **kwargs):
        if self.armed:
            self.armed = False
            assert self._engine.swap_params(self._tree) is False
        return self._engine.prefill(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._engine, name)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_swap_staged_after_admission_requeues_the_request(
        trees, jax_engine, package):
    """Request A decodes; B passes ``can_admit``, then a swap is staged
    before B's prefill. The port requeues B, which runs on the new weights
    once A drains the engine; JAX's batcher fails B with the engine's
    ``OutOfPages``, though its engine's comment calls it backpressure."""
    a_prompt, b_prompt = [6, 1, 9], [2, 7, 5]
    want_a = jax_tokens(jax_engine, trees[0], a_prompt, 30)
    want_b = jax_tokens(jax_engine, trees[1], b_prompt, 4)
    if package == "port":
        inner = _engine(trees[0])
        new_tree, batcher_cls = _torch_tree(trees[1]), ContinuousBatcher
    else:
        jax_engine.swap_params(jax.tree.map(jnp.asarray, trees[0]))
        inner = jax_engine
        new_tree = jax.tree.map(jnp.asarray, trees[1])
        batcher_cls = JaxBatcher
    eng = _SwapBeforePrefill(inner, new_tree)
    batcher = batcher_cls(eng, max_queue=8)
    try:
        fa = batcher.submit(a_prompt, max_new_tokens=30)
        deadline = time.time() + 30
        while not inner.kv.active_slots().size and time.time() < deadline:
            time.sleep(0.001)
        eng.armed = True
        fb = batcher.submit(b_prompt, max_new_tokens=4)
        assert fa.result(timeout=60)["tokens"] == want_a
        if package == "jax":
            with pytest.raises(JaxOutOfPages, match="weight swap pending"):
                fb.result(timeout=60)
            return
        assert fb.result(timeout=60)["tokens"] == want_b
        assert inner.serving_version() == 1
    finally:
        batcher.close()
        if package == "jax":
            jax_engine.maybe_swap()


# -- the swap-smoke scenario in one process -----------------------------------


def _burst_request(k, j):
    """Client ``k``'s ``j``-th generate (examples/swap_smoke.py's mix over
    this vocabulary)."""
    n = 2 + (5 * k + 3 * j) % 17
    return [(i * 13 + k + j) % 61 for i in range(n)], 3 + (7 * k + j) % 12


def test_live_publication_into_a_decode_server(trees, jax_engine, tmp_path):
    store = WeightStore(str(tmp_path))
    engine = DecodeEngine(torch_model(), _torch_tree(trees[0]),
                          num_slots=4, page_size=PAGE, seed=0,
                          prefill_chunk=8)
    watcher = WeightWatcher(store, [engine], poll_interval_s=0.05)
    srv = InferenceServer(None, generate_batcher=ContinuousBatcher(
                              engine, max_queue=64),
                          weight_watcher=watcher, drain_timeout_s=60.0,
                          memory_watch=False).start()
    errors, versions, done = [], [], [0]
    stop = threading.Event()
    try:
        def worker(k):
            client = ServingClient(srv.url, timeout=120, retries=0)
            for j in range(REQUESTS):
                prompt, budget = _burst_request(k, j)
                try:
                    r = client.generate(prompt, max_new_tokens=budget,
                                        temperature=0.0,
                                        request_id=f"swap-{k}-{j}")
                    if (r["num_tokens"] != budget
                            or r["finish_reason"] != "length"):
                        errors.append(("bad completion", r))
                except Exception as exc:  # noqa: BLE001 - counted
                    errors.append(exc)
                done[0] += 1
            client.close()

        def sampler():
            c = ServingClient(srv.url, timeout=10, retries=0)
            while not stop.is_set():
                versions.append(
                    int(c.healthz()["weights"]["serving_version"]))
                time.sleep(0.01)
            c.close()

        monitor = threading.Thread(target=sampler)
        monitor.start()
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(WORKERS)]
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while done[0] < WORKERS * REQUESTS // 4 and time.time() < deadline:
            time.sleep(0.005)
        assert store.publish(_torch_tree(trees[1])) == 1
        client = ServingClient(srv.url, timeout=60, retries=0)
        deadline = time.time() + 60
        while client.healthz()["weights"]["serving_version"] != 1:
            assert time.time() < deadline, "the server never swapped to v1"
            time.sleep(0.01)
        # a second version, damaged on disk once committed; the armed
        # delay on the pull orders the damage before the watcher's read
        with faults.inject("weights.pull", delay_ms=300):
            assert store.publish(_torch_tree(trees[2])) == 2
            faults.corrupt_latest_weights(store.directory, mode="flip")
            deadline = time.time() + 60
            while client.healthz()["weights"]["pull_failures"] == 0:
                assert time.time() < deadline, "v2 was never pulled"
                time.sleep(0.01)
        for t in threads:
            t.join(timeout=120)
        stop.set()
        monitor.join()
        weights = client.healthz()["weights"]
        assert not errors, errors[:3]
        assert done[0] == WORKERS * REQUESTS
        # serving_version moved 0 -> 1 exactly once and never to 2
        seen = [v for i, v in enumerate(versions)
                if i == 0 or v != versions[i - 1]]
        assert seen == [0, 1], seen
        assert weights["serving_version"] == 1
        assert weights["pull_failures"] == 1
        assert weights["failed_versions"] == [2]

        # after the swap: a fresh port engine's and JAX's tokens on v1
        fresh = DecodeEngine(torch_model(), _torch_tree(trees[1]),
                             num_slots=4, page_size=PAGE, seed=0,
                             prefill_chunk=8)
        for prompt, budget in (_burst_request(1, 2), _burst_request(3, 5)):
            got = client.generate(prompt, max_new_tokens=budget)["tokens"]
            assert got == _drive(fresh, prompt, budget)[0]
            assert got == jax_tokens(jax_engine, trees[1], prompt, budget)

        # a drain begun with a generation in flight completes it
        rider = {}

        def ride():
            c = ServingClient(srv.url, timeout=60, retries=0)
            rider["out"] = c.generate(list(range(1, 9)), max_new_tokens=40)
            c.close()

        t = threading.Thread(target=ride)
        t.start()
        deadline = time.time() + 30
        while not engine.kv.active_slots().size:
            assert time.time() < deadline, "the rider never started"
            time.sleep(0.001)
        assert srv.drain(timeout=60.0)
        t.join(timeout=60)
        assert rider["out"]["num_tokens"] == 40
        assert rider["out"]["tokens"] == _drive(fresh, list(range(1, 9)),
                                                40)[0]
        with pytest.raises(ServingError) as late:
            client.generate([1, 2, 3], max_new_tokens=2)
        assert late.value.status == 503 and late.value.code == "draining"
        client.close()
    finally:
        stop.set()
        srv.stop()
