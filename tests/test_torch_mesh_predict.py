"""PyTorch port, data-parallel serving in one process (the serving rule of
``sparkflow_tpu_torch/parallel/mesh.py``): ``Trainer.predict_fn(mesh=)`` /
``core.make_predict_fn``, ``InferenceEngine(mesh=)`` and
``SparkAsyncDLModel(meshShape="dp=N")``, against the JAX package's sharded
programs on two of the conftest's virtual CPU devices, on the same numpy
weights and rows.

Two models: the ``nn`` MLPs of the JAX package's own tests
(``tests/test_trainer.py``, ``tests/test_serving.py``) and a 2-layer
``transformer_classifier`` fed ids and a padding mask (its attention is
kernel 1's plain version here). Bar: float32 outputs within 1e-5 of JAX's
and of the port's unsharded predictions; int8-served outputs within 1e-4
of JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import sparkflow_tpu.localml as jlocal
import sparkflow_tpu.nn as jnn
from sparkflow_tpu.core import predict_in_chunks as jax_chunks
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.serving import InferenceEngine as JaxEngine
from sparkflow_tpu.tensorflow_async import SparkAsyncDLModel as JaxModel
from sparkflow_tpu.trainer import Trainer as JaxTrainer

import sparkflow_tpu_torch.localml as tlocal
import sparkflow_tpu_torch.parallel.mesh as tmesh
from sparkflow_tpu_torch import nn as tnn
from sparkflow_tpu_torch.core import predict_in_chunks
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.ml_util import convert_weights_to_json
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.serving import InferenceEngine
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDLModel
from sparkflow_tpu_torch.trainer import Trainer

from test_torch_shared import numpy_params

TOL, INT8_TOL = 1e-5, 1e-4
CLS = dict(vocab_size=50, num_classes=2, hidden=64, num_layers=2,
           num_heads=4, mlp_dim=128, max_len=32, dropout=0.0)


def _jmesh():
    return jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])


def clf_graph(nn):
    x = nn.placeholder([None, 10], name="x")
    y = nn.placeholder([None, 2], name="y")
    h = nn.dense(x, 16, activation="relu")
    out = nn.dense(h, 2, name="out")
    nn.softmax_cross_entropy(y, out)


def mlp_graph(nn):
    x = nn.placeholder([None, 4], name="x")
    h = nn.dense(x, 3, activation="relu")
    out = nn.dense(h, 2, name="out")
    nn.mean_squared_error(x, out)


@pytest.fixture(scope="module")
def clf():
    """A fitted classifier MLP (JAX's sharded-predict test's model): the
    port trainer and its params, and the JAX trainer on the same
    weights."""
    rs = np.random.RandomState(0)
    x = rs.randn(403, 10).astype(np.float32)   # not batch-aligned
    y = np.eye(2, dtype=np.float32)[(x @ rs.randn(10) > 0).astype(int)]
    tr = Trainer(build_graph(lambda: clf_graph(tnn)), "x:0", "y:0", iters=3,
                 mini_batch_size=64, device="cpu")
    res = tr.fit(x, y)
    jt = JaxTrainer(jax_build_graph(lambda: clf_graph(jnn)), "x:0", "y:0",
                    iters=1, mini_batch_size=64, mesh=_jmesh())
    jt.fit(x, y)
    jparams = jax.tree.map(lambda t: np.asarray(t.detach().numpy()),
                           res.params)
    return tr, res.params, jt, jparams, x


def test_sharded_predict_equals_single_and_jax(clf):
    """``predict_fn(mesh={"dp": 2})`` over 403 rows in chunks of 64: equal
    to the unsharded predictions and to JAX's ``predict_fn(mesh=)`` on the
    same weights."""
    tr, params, jt, jparams, x = clf
    single = predict_in_chunks(tr.predict_fn("out:0"), params, x)
    sharded = predict_in_chunks(tr.predict_fn("out:0", mesh={"dp": 2}),
                                params, x, chunk_size=64)
    np.testing.assert_allclose(sharded, single, atol=TOL, rtol=TOL)
    want = jax_chunks(jt.predict_fn("out:0", mesh=_jmesh()), jparams, x,
                      chunk_size=64)
    np.testing.assert_allclose(sharded, np.asarray(want), atol=TOL, rtol=TOL)


def test_sharded_predict_ragged_and_empty(clf):
    """Any batch pads up to a dp multiple and trims: 5 rows, 1 row and
    none (JAX's ``test_mesh_sharded_predict_ragged_and_empty``)."""
    tr, params, jt, jparams, x = clf
    fn = tr.predict_fn("out:0", mesh={"dp": 2})
    jfn = jt.predict_fn("out:0", mesh=_jmesh())
    for n in (5, 1):
        got = predict_in_chunks(fn, params, x[:n], chunk_size=64)
        assert got.shape == (n, 2)
        np.testing.assert_allclose(
            got, np.asarray(jax_chunks(jfn, jparams, x[:n], chunk_size=64)),
            atol=TOL, rtol=TOL)
    empty = predict_in_chunks(fn, params, np.zeros((0, 10), np.float32))
    assert empty.shape == (0, 2)
    assert fn(params, x[:0]).shape == (0, 2)


def test_the_copies_are_made_once_per_params_tree(clf, monkeypatch):
    """A steady stream of calls with one tree copies its weights once; a
    new tree, or one changed in place, is copied again. One copy per dp
    shard, each on the rank rule's device (all on the CPU here)."""
    tr, params, _jt, _jp, x = clf
    made = []
    real = tmesh.dp_copies

    def spy(tree, devices):
        made.append(list(devices))
        return real(tree, devices)

    monkeypatch.setattr(tmesh, "dp_copies", spy)
    fn = tr.predict_fn("out:0", mesh={"dp": 4})
    before = fn(params, x[:8]).numpy()
    for _ in range(3):
        fn(params, x[:8])
    assert made == [[torch.device("cpu")] * 4]
    other = {ln: {k: v.clone() for k, v in layer.items()}
             for ln, layer in params.items()}
    fn(other, x[:8])
    assert len(made) == 2
    with torch.no_grad():
        other["out/BiasAdd"]["bias"].add_(1.0)
    after = fn(other, x[:8]).numpy()
    assert len(made) == 3
    np.testing.assert_allclose(after, before + 1.0, atol=TOL, rtol=0)


def test_sharded_transformer_classifier_matches_jax():
    """Ids + mask through ``make_predict_fn(mesh=)`` at dp=2 (each block's
    forward runs the attention on its copy) against JAX's."""
    from sparkflow_tpu.core import make_predict_fn as jax_predict_fn
    from sparkflow_tpu.models.registry import model_from_json as jax_from
    from sparkflow_tpu_torch.core import make_predict_fn
    from sparkflow_tpu_torch.convert import list_to_params
    from sparkflow_tpu_torch.models import model_from_json
    spec = build_registry_spec("transformer_classifier", **CLS)
    jm = jax_from(spec)
    tree = numpy_params(jm.param_specs(), seed=3, std=0.1)
    flat = [tree[ln][pn] for ln, ps in jm.param_specs().items() for pn in ps]
    model = model_from_json(spec, device="cpu")
    params = list_to_params(model, flat)
    rs = np.random.RandomState(1)
    ids = rs.randint(1, 50, (7, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < rs.randint(16, 33, (7, 1))).astype(
        np.float32)
    names = ["input_ids:0", "attention_mask:0"]
    got = make_predict_fn(model, names, "probs:0", mesh={"dp": 2})(
        params, (ids, mask)).numpy()
    single = make_predict_fn(model, names, "probs:0")(params,
                                                      (ids, mask)).numpy()
    want = np.asarray(jax_predict_fn(jm, names, "probs:0", mesh=_jmesh())(
        tree, (ids, mask)))
    np.testing.assert_allclose(got, single, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_a_model_parallel_predict_mesh_is_refused():
    # an ep mesh serves (tests/test_torch_ep_serving.py): the graph has no
    # expert bank, so as in JAX's replicated program each copy holds the
    # whole tree and the predictions are the plain ones and JAX's
    tr = Trainer(build_graph(lambda: clf_graph(tnn)), "x:0", "y:0",
                 device="cpu")
    jtr = JaxTrainer(jax_build_graph(lambda: clf_graph(jnn)), "x:0", "y:0")
    x = np.random.RandomState(3).randn(5, 10).astype(np.float32)
    params = tr.model.init(seed=1)
    tree = jax.tree.map(np.asarray, {ln: {k: v.detach().numpy() for k, v in
                                           layer.items()}
                                      for ln, layer in params.items()})
    plain = tr.predict_fn("out:0")(params, x).numpy()
    for mesh in ({"dp": 2, "ep": 2}, {"ep": 2}):
        got = tr.predict_fn("out:0", mesh=mesh)(params, x).numpy()
        jmesh = jax_make_mesh(mesh, devices=jax.devices()[:int(np.prod(
            list(mesh.values())))])
        want = np.asarray(jtr.predict_fn("out:0", mesh=jmesh)(tree, x))
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # a pp axis is a decode axis: refused with the JAX engine's message
    with pytest.raises(ValueError, match="decode-plane axis"):
        tr.predict_fn("out:0", mesh={"pp": 2})


# -- the engine -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp():
    rs = np.random.RandomState(0)
    weights = [rs.randn(4, 3).astype(np.float32),
               rs.randn(3).astype(np.float32),
               rs.randn(3, 2).astype(np.float32),
               rs.randn(2).astype(np.float32)]
    spec = build_graph(lambda: mlp_graph(tnn))
    assert spec == jax_build_graph(lambda: mlp_graph(jnn))
    return spec, weights, dict(input_name="x:0", output_name="out/BiasAdd:0")


def test_engine_on_dp_mesh_matches_jax(mlp):
    """JAX's ``test_engine_on_dp_mesh``: buckets of 1, 3, 8, 13 and 16 rows
    (below dp one copy runs, dp-divisible buckets split) against JAX's
    engine on a 2-device dp mesh and the plain forward; every bucket ran
    at warmup on every copy; ``stats()`` reports the mesh."""
    spec, weights, kw = mlp
    eng = InferenceEngine(spec, weights, max_batch=16, mesh={"dp": 2},
                          device="cpu", **kw)
    jeng = JaxEngine(spec, weights, max_batch=16, mesh=_jmesh(), **kw)
    rs = np.random.RandomState(12345)
    for n in (1, 3, 8, 13, 16):
        x = rs.randn(n, 4).astype(np.float32)
        manual = (np.maximum(x @ weights[0] + weights[1], 0.0) @ weights[2]
                  + weights[3])
        got = eng.predict(x)
        np.testing.assert_allclose(got, jeng.predict(x), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got, manual, atol=TOL, rtol=TOL)
    assert eng.fallback_compiles == 0
    assert eng.aot_compiles == len(eng.buckets)
    st, jst = eng.stats(), jeng.stats()
    assert st["mesh"] == jst["mesh"] == {"dp": 2}
    assert st["sharding"] == jst["sharding"]
    assert eng.predict(np.zeros((0, 4), np.float32)).shape == (0, 2)


def test_engine_dp_quantize_and_hot_swap(mlp):
    """int8 serving composes with dp (within 1e-4 of JAX's dp engine); a
    hot swap places the new tree on every copy before the flip and serves
    as a cold dp engine on the new weights does."""
    spec, weights, kw = mlp
    q = dict(quantize="weight_only", quant_min_size=1, max_batch=8)
    eng = InferenceEngine(spec, weights, mesh={"dp": 2}, device="cpu", **q,
                          **kw)
    jeng = JaxEngine(spec, weights, mesh=_jmesh(), **q, **kw)
    x = np.random.RandomState(2).randn(8, 4).astype(np.float32)
    np.testing.assert_allclose(eng.predict(x), jeng.predict(x),
                               atol=INT8_TOL, rtol=0)
    new = [w * 0.5 for w in weights]
    assert eng.swap_params(new)
    cold = InferenceEngine(spec, new, mesh={"dp": 2}, device="cpu", **q,
                           **kw)
    assert all(t.data_ptr() != u.data_ptr() for t, u in zip(
        eng._copies[0]["out/BiasAdd"].values(),
        eng._copies[1]["out/BiasAdd"].values()))
    np.testing.assert_array_equal(eng.predict(x), cold.predict(x))
    assert eng.stats()["serving_version"] == 1


# -- the model stage -----------------------------------------------------------------

def _rows(localml, n=37, seed=4):
    rs = np.random.RandomState(seed)
    spark = localml.LocalSession.builder.appName("dp").getOrCreate()
    return spark.createDataFrame(
        [(localml.Vectors.dense(rs.randn(4)),) for _ in range(n)],
        ["features"])


def test_model_mesh_shape_transform_matches_jax(mlp):
    """``SparkAsyncDLModel(meshShape="dp=2")`` serves each partition over
    two weight copies: its predictions equal the unsharded model's and the
    JAX model's served over a dp mesh, within 1e-5; a non-dp axis is
    refused with JAX's message."""
    spec, weights, _kw = mlp
    kw = dict(inputCol="features", modelJson=spec,
              modelWeights=convert_weights_to_json(weights), tfInput="x:0",
              tfOutput="out/BiasAdd:0", predictionCol="p")

    def preds(df):
        return np.stack([r["p"].toArray() for r in df.collect()])

    ours = preds(SparkAsyncDLModel(meshShape="dp=2", device="cpu",
                                   **kw).transform(_rows(tlocal)))
    plain = preds(SparkAsyncDLModel(device="cpu", **kw).transform(
        _rows(tlocal)))
    # the JAX model's mesh must span every device it sees (8 here)
    theirs = preds(JaxModel(meshShape="dp=-1", **kw).transform(
        _rows(jlocal)))
    assert ours.shape == (37, 2)
    np.testing.assert_allclose(ours, plain, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError) as a:
        SparkAsyncDLModel(meshShape="dp=2,tp=2", device="cpu",
                          **kw).transform(_rows(tlocal))
    with pytest.raises(ValueError) as b:
        JaxModel(meshShape="dp=2,tp=2", **kw).transform(_rows(jlocal))
    assert str(a.value) == str(b.value)
    assert "serves data-parallel only" in str(a.value)
