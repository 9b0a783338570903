"""PyTorch port, live weight publication: ``WeightStore`` and
``WeightWatcher`` against the JAX package's on one on-disk format.

A store names its leaves ``l_{i}`` in ``jax.tree.leaves`` order, which
sorts dict keys (``block_10`` before ``block_2``), so the cross-package
checks use a 12-block model, where that order differs from both
``param_specs()`` order and insertion order. Published and loaded leaves
are compared exactly; a port ``Trainer(publish_to=)`` against the JAX
``Trainer``'s publications within 1e-5 absolute (float32 SGD, the same
initial weights, no shuffle, dropout 0), on a 2-block cut of the same
model (the JAX trainer compiles every block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import (CFG, PAGE, _drive, numpy_params,
                               torch_model)
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.serving.weightstore import WeightStore as JaxStore
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.convert import params_from_jax, sorted_leaves
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.resilience import faults
from sparkflow_tpu_torch.serving import (DecodeEngine, InferenceEngine,
                                         WeightStore, WeightStoreError,
                                         WeightWatcher)
from sparkflow_tpu_torch.trainer import Trainer

DEEP = dict(vocab_size=40, num_classes=2, hidden=16, num_layers=12,
            num_heads=2, mlp_dim=32, max_len=16, dropout=0.0)
SHALLOW = dict(DEEP, num_layers=2)
IN, OUT = ["input_ids:0", "attention_mask:0"], "probs:0"


def _model_and_weights(cfg):
    spec = build_registry_spec("transformer_classifier", **cfg)
    assert spec == jax_spec("transformer_classifier", **cfg)
    specs = jax_from_json(spec).param_specs()
    return spec, numpy_params(specs, seed=1, std=0.1), \
        numpy_params(specs, seed=2, std=0.1)


@pytest.fixture(scope="module")
def deep():
    return _model_and_weights(DEEP)


@pytest.fixture(scope="module")
def shallow():
    return _model_and_weights(SHALLOW)


def _rows(n, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, DEEP["vocab_size"], (n, DEEP["max_len"]))
    mask = np.ones((n, DEEP["max_len"]), np.float32)
    mask[:, DEEP["max_len"] - 3:] = 0.0
    return ids.astype(np.int32), mask


def _engine(spec, weights):
    return InferenceEngine(spec, weights, input_name=IN, output_name=OUT,
                           max_batch=4, device="cpu")


def _same_tree(got, want):
    assert sorted(got) == sorted(want)
    for ln in want:
        assert sorted(got[ln]) == sorted(want[ln])
        for pn, w in want[ln].items():
            g = got[ln][pn]
            g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"{ln}/{pn}")


def test_the_leaf_order_is_jaxs_sorted_order(deep):
    _spec, a, _b = deep
    flat = sorted_leaves(a)
    jflat = jax.tree_util.tree_flatten_with_path(a)[0]
    assert [p for p, _x in flat] == [tuple(k.key for k in path)
                                     for path, _x in jflat]
    assert all(x is y for (_p, x), (_q, y) in zip(flat, jflat))
    order = [f"{ln}/{pn}" for (ln, pn), _x in flat]
    assert order.index("block_10/fc1_bias") < order.index("block_2/fc1_bias")


def test_jax_publishes_and_the_port_loads(deep, tmp_path):
    spec, a, b = deep
    JaxStore(str(tmp_path)).publish(jax.tree.map(jnp.asarray, b))
    eng = _engine(spec, a)
    store = WeightStore(str(tmp_path))
    version, tree = store.load(like=eng.weights_template())
    assert version == 1
    _same_tree(tree, b)
    eng.swap_params(tree, version=version)
    x = _rows(3, seed=1)
    np.testing.assert_array_equal(eng.predict(x),
                                  _engine(spec, b).predict(x))


def test_the_port_publishes_and_jax_loads(deep, tmp_path):
    spec, _a, b = deep
    model = model_from_json(spec, device="cpu")
    store = WeightStore(str(tmp_path))
    assert store.publish(params_from_jax(model, b)) == 1
    assert store.verify_version(1)
    version, tree = JaxStore(str(tmp_path)).load(like=b)
    assert version == 1
    _same_tree(tree, b)


def test_watcher_swaps_an_inference_engine(deep, tmp_path):
    spec, a, b = deep
    store = WeightStore(str(tmp_path))
    eng = _engine(spec, a)
    x = _rows(4, seed=2)
    stale = eng.predict(x)
    watcher = WeightWatcher(store, [eng], poll_interval_s=0.05)
    assert watcher.poll_once() is False             # nothing published
    model = model_from_json(spec, device="cpu")
    store.publish(params_from_jax(model, b))
    assert watcher.poll_once() is True
    assert eng.serving_version() == 1 and watcher.serving_version() == 1
    fresh = _engine(spec, b).predict(x)
    np.testing.assert_array_equal(eng.predict(x), fresh)
    assert not np.array_equal(stale, fresh)
    st = watcher.stats()
    assert st["target_version"] == 1 and st["swaps"] == 1
    # the background thread picks up the next publication
    store.publish(params_from_jax(model, a))
    watcher.start()
    try:
        import time
        deadline = time.monotonic() + 20
        while eng.serving_version() != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        watcher.stop()
    assert eng.serving_version() == 2
    np.testing.assert_array_equal(eng.predict(x), stale)


def test_watcher_swaps_a_decode_engine(tmp_path):
    jm_specs = jax_from_json(jax_spec("transformer_lm", **CFG)).param_specs()
    a, b = numpy_params(jm_specs, seed=6), numpy_params(jm_specs, seed=7)
    tm = torch_model()
    eng = DecodeEngine(tm, params_from_jax(tm, a), num_slots=2,
                       page_size=PAGE, seed=0)
    store = WeightStore(str(tmp_path))
    store.publish(params_from_jax(tm, b))
    watcher = WeightWatcher(store, [eng])
    assert watcher.poll_once() is True
    assert eng.serving_version() == 1
    prompt = [5, 2, 8, 9]
    got = _drive(eng, prompt, 6)[0]
    fresh = DecodeEngine(torch_model(), params_from_jax(tm, b), num_slots=2,
                         page_size=PAGE, seed=0)
    assert got == _drive(fresh, prompt, 6)[0]


def test_corrupt_versions_fall_back_quarantine_and_rollback(deep, tmp_path):
    spec, a, b = deep
    model = model_from_json(spec, device="cpu")
    store = WeightStore(str(tmp_path), keep=3)
    assert store.publish(params_from_jax(model, a)) == 1
    assert store.publish(params_from_jax(model, b)) == 2
    with pytest.raises(WeightStoreError, match="monotone"):
        store.publish(params_from_jax(model, a), version=2)
    eng = _engine(spec, a)
    template = eng.weights_template()
    # a torn newest version: loads fall back past it; naming it raises
    faults.corrupt_latest_weights(str(tmp_path), mode="flip")
    assert store.verify_version(2) is False
    version, tree = store.load(like=template)
    assert version == 1
    _same_tree(tree, a)
    with pytest.raises(WeightStoreError, match="torn or corrupt"):
        store.load(version=2, like=template)
    watcher = WeightWatcher(store, [eng])
    assert watcher.poll_once() is False             # v2 fails: keep last-good
    assert watcher.stats()["pull_failures"] == 1
    assert eng.serving_version() == 0
    # a shape-drifted publication is refused against the template
    drift = params_from_jax(model, b)
    drift["head"]["bias"] = torch.zeros(3)
    store.publish(drift)
    with pytest.raises(WeightStoreError, match="shapes must be unchanged"):
        store.load(version=3, like=template)
    # rollback quarantines the newest and repoints at the last good
    assert store.rollback() == 1
    assert store.quarantined() == {3}
    assert store.latest_version() == 1
    assert watcher.poll_once() is True
    assert eng.serving_version() == 1
    s = store.stats()
    assert s["latest"] == 1 and s["quarantined"] == [3]
    assert s["versions"] == [1, 2, 3]


@pytest.mark.parametrize("every,versions", [(2, [1, 2]), (0, [1])],
                         ids=["every-2", "at-end"])
def test_trainer_publishes_like_the_jax_trainer(shallow, tmp_path, every,
                                                versions):
    spec, a, _b = shallow
    feats = _rows(8, seed=3)
    feats = (feats[0].astype(np.float32), feats[1])
    labels = np.random.default_rng(4).integers(0, 2, 8).astype(np.float32)
    kw = dict(optimizer="gradient_descent", learning_rate=0.1, iters=4,
              mini_batch_size=4, shuffle_per_iter=False, seed=0,
              publish_every=every)
    names = ["input_ids", "attention_mask"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JaxTrainer(spec, names, "y", publish_to=str(jdir), **kw).fit(
        feats, labels, init_params=a)
    tt = Trainer(spec, names, "y", publish_to=str(tdir), device="cpu", **kw)
    tt.fit(feats, labels, init_params=a)
    jstore, tstore = JaxStore(str(jdir)), WeightStore(str(tdir))
    assert jstore.all_versions() == tstore.all_versions() == versions
    for v in versions:
        _vj, want = jstore.load(version=v, like=a)
        # the port's store read by the JAX package's reader
        _vt, got = JaxStore(str(tdir)).load(version=v, like=a)
        for ln in a:
            for pn in a[ln]:
                np.testing.assert_allclose(np.asarray(got[ln][pn]),
                                           np.asarray(want[ln][pn]),
                                           atol=1e-5, rtol=0,
                                           err_msg=f"v{v} {ln}/{pn}")
    _same_tree(tstore.load(like=a)[1], {
        ln: {pn: t.numpy() for pn, t in layer.items()}
        for ln, layer in tt.params.items()})


def test_a_failed_publication_never_fails_training(shallow, tmp_path,
                                                   caplog):
    spec, a, _b = shallow
    feats = _rows(4, seed=5)
    feats = (feats[0].astype(np.float32), feats[1])
    labels = np.zeros(4, np.float32)
    store = WeightStore(str(tmp_path))
    tt = Trainer(spec, ["input_ids", "attention_mask"], "y", iters=2,
                 optimizer="gradient_descent", publish_to=store,
                 publish_every=1, device="cpu")
    with faults.inject("weights.publish_commit", fail_calls=[0]):
        with caplog.at_level("ERROR", logger="sparkflow_tpu_torch"):
            res = tt.fit(feats, labels, init_params=a)
    assert res.completed and len(res.losses) == 2
    assert "live weight publication failed" in caplog.text
    assert store.all_versions() == [1]
