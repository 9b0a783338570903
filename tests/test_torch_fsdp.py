"""PyTorch port, fsdp parameter sharding and the estimator's model-parallel
``meshShape``: ``parallel/tp.py``'s fsdp specs and just-in-time gather,
the sharded step of ``parallel/dp.py``, ``Trainer.fit_stream`` on an fsdp
mesh and ``SparkAsyncDL(meshShape=)`` with ``fsdp`` and ``tp``, against
the JAX package's GSPMD path.

The JAX side runs on the conftest's virtual CPU devices; the port's ranks
run over gloo on the CPU in one module-scoped 2-rank pool and one 4-rank
pool (dp=2 x fsdp=2), each fit in place as under torchrun; the two
estimator fits launch their own ranks, as a user's fit does. Weights are
drawn with numpy and handed to both packages; dropout is off.

Tolerances (float32): one SGD step's loss within 1e-5 relative and its
params within rtol 3e-4 / atol 3e-5 (``tests/test_models.py``'s pin);
stream and estimator fits within 1e-5 / 5e-5 (the ZeRO tests' bar,
``tests/test_torch_zero.py``); the estimator's fits against the same
estimator without a mesh. The port splits a dp shard's rows over
fsdp as well (JAX shards rows over dp only): the same masked mean, summed
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkflow_tpu.checkpoint as jax_ckpt
import sparkflow_tpu.nn as jnn
import torch_rank_tasks as tasks
from test_torch_shared import numpy_params
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.optimizers import build_optimizer as jax_opt
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.parallel.tp import (fsdp_pspecs as jax_fsdp_pspecs,
                                       make_sharded_train_step as jax_step,
                                       shard_params as jax_shard)
from sparkflow_tpu.spark_async import SparkAsyncDL as JaxSparkAsyncDL
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu.trainer import _ckpt_state as jax_ckpt_state
from sparkflow_tpu_torch import nn as tnn
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.ml_util import resolve_weights
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.optimizers import build_optimizer
from sparkflow_tpu_torch.spark_async import SparkAsyncDL
from sparkflow_tpu_torch.trainer import Trainer

S = 16
CLS = dict(vocab_size=64, num_classes=3, hidden=32, num_layers=2,
           num_heads=4, mlp_dim=64, max_len=S, dropout=0.0)
STEP_TOL = dict(rtol=3e-4, atol=3e-5)
ATOL, RTOL = 5e-5, 1e-5


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tasks.rank_pool(4, timeout_s=180) as pool:
        yield pool


@pytest.fixture
def jax_npz(monkeypatch):
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(ours, theirs, msg="", **tol):
    for layer in theirs:
        for k in theirs[layer]:
            np.testing.assert_allclose(
                np.asarray(ours[layer][k]), np.asarray(theirs[layer][k]),
                err_msg=f"{msg} {layer}/{k}", **tol)


def _graph(nn, d_in=64, hidden=48):
    x = nn.placeholder([None, d_in], name="x")
    y = nn.placeholder([None, 3], name="y")
    h = nn.dense(x, hidden, activation="relu")
    out = nn.dense(h, 3, name="out")
    nn.softmax_cross_entropy(y, out)


def _case(family):
    """``(port spec, jax model, input name, label name, x, y)``."""
    rs = np.random.RandomState(1)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    if family == "graph":
        spec = build_graph(lambda: _graph(tnn))
        jm = jax_model(jax_build_graph(lambda: _graph(jnn)))
        return spec, jm, "x:0", "y:0", rs.randn(8, 64).astype(np.float32), y
    spec = build_registry_spec("transformer_classifier", **CLS)
    ids = rs.randint(0, CLS["vocab_size"], (8, S)).astype(np.float32)
    return spec, jax_model(spec), "input_ids", "y", ids, y


@pytest.mark.parametrize("axes", [{"dp": 1, "fsdp": 2}, {"dp": 2, "fsdp": 2}],
                         ids=["dp1-fsdp2", "dp2-fsdp2"])
@pytest.mark.parametrize("family", ["graph", "classifier"])
def test_fsdp_sgd_step_matches_jax_sharded_step(pool2, pool4, family, axes):
    """One SGD step with fsdp-sharded params (``fsdp_pspecs`` at min_size
    32*64, so the big kernels and embeddings shard) against JAX's
    ``make_sharded_train_step`` on the same mesh of virtual devices
    (``tests/test_models.py``'s case)."""
    spec, jm, inp, lbl, x, y = _case(family)
    p0 = numpy_params(jm.param_specs(), seed=3, std=0.1)
    specs = jax_fsdp_pspecs(jm.param_specs(), min_size=32 * 64)
    assert any("fsdp" in str(s) for d in specs.values() for s in d.values())
    jmesh = _jmesh(axes)
    opt = jax_opt("gradient_descent", 0.1, None)
    placed = jax_shard(jax.tree.map(jnp.asarray, p0), jmesh, specs)
    step = jax_step(jm, opt, jmesh, inp, lbl)
    jp, _, jloss = step(placed, opt.init(placed), jnp.asarray(x),
                        jnp.asarray(y), jnp.ones((8,), jnp.float32),
                        jax.random.PRNGKey(1))
    pool = pool2 if axes["dp"] == 1 else pool4
    out = pool.run(tasks.sharded_step, spec, axes, p0, x, y,
                   fsdp_min_size=32 * 64, input_name=inp, label_name=lbl)
    full = sum(a.nbytes for d in p0.values() for a in d.values())
    for r in out:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
        _close(r["params"], _np_tree(jp), family, **STEP_TOL)
        assert r["local_bytes"] < full


def test_fsdp_splits_uneven_leaves(pool2):
    """Leaves whose largest dim does not divide fsdp (71 over 2: blocks of
    36 and 35, the gather pads and trims): the step equals one device's
    SGD step (``jax.value_and_grad``), and the rows split 5 / 3 over the
    fsdp ranks with zero-mask padding."""
    spec = build_graph(lambda: _graph(tnn, 37, 71))
    jm = jax_model(jax_build_graph(lambda: _graph(jnn, 37, 71)))
    p0 = numpy_params(jm.param_specs(), seed=4, std=0.1)
    rs = np.random.RandomState(2)
    x = rs.randn(5, 37).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 5)]

    def loss(p):
        return jm.loss_vector(p, {"x": jnp.asarray(x),
                                  "y": jnp.asarray(y)}).mean()

    jl, g = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, p0))
    want = jax.tree.map(lambda p, gg: p - 0.1 * gg,
                        jax.tree.map(jnp.asarray, p0), g)
    out = pool2.run(tasks.sharded_step, spec, {"dp": 1, "fsdp": 2}, p0, x,
                    y, fsdp_min_size=37 * 71, input_name="x:0",
                    label_name="y:0")
    for r in out:
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-5)
        _close(r["params"], _np_tree(want), "uneven", **STEP_TOL)


_STREAM = dict(optimizer="adam", learning_rate=1e-2, mini_batch_size=32,
               seed=3, shuffle_per_iter=True)


def test_fit_stream_on_fsdp_matches_jax(pool2):
    """A shuffled stream at {"dp": 1, "fsdp": 2} (the first kernel, 256 x
    256, shards at the default 2**16 threshold): every step's loss and the
    final params against JAX's ``fit_stream`` on the same mesh."""
    spec = build_graph(lambda: _graph(tnn, 256, 256))
    jg = jax_build_graph(lambda: _graph(jnn, 256, 256))
    p0 = numpy_params(jax_model(jg).param_specs(), seed=5, std=0.05)
    rs = np.random.RandomState(3)
    x = rs.randn(160, 256).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 160)]
    ours = pool2.run(tasks.tp_stream_fit, spec, {"dp": 1, "fsdp": 2},
                     dict(_STREAM, inputs=("x:0", "y:0")), x, y, p0)
    jt = JaxTrainer(jg, "x:0", "y:0", mesh=_jmesh({"dp": 1, "fsdp": 2}),
                    **_STREAM)
    jr = jt.fit_stream(lambda: zip(list(x), list(y)),
                       init_params=jax.tree.map(jnp.asarray, p0), chunk=64)
    assert len(jr.losses) == 5
    for o in ours:
        np.testing.assert_allclose(o["losses"], jr.losses, atol=ATOL,
                                   rtol=RTOL)
        _close(o["params"], _np_tree(jr.params), "stream", atol=ATOL,
               rtol=RTOL)
        me = o["stats"]["ranks"][0]
        assert me["param_bytes"] < sum(a.nbytes for d in p0.values()
                                       for a in d.values())
    assert ours[0]["losses"] == ours[1]["losses"]


# -- the estimator -------------------------------------------------------------


def _token_rows(localml, n=64, seed=7):
    rs = np.random.RandomState(seed)
    rows = [(float(rs.randint(0, 2)),
             localml.Vectors.dense(rs.randint(0, 30, 8).astype(float)))
            for _ in range(n)]
    spark = localml.LocalSession.builder.appName("tp").getOrCreate()
    return spark.createDataFrame(rows, ["label", "features"])


def _start_dirs(tmp_path, jgraph, tgraph_model_params):
    """Epoch-0 checkpoints holding the same initial weights and adam state
    in a JAX and a port directory: both estimators resume from them."""
    p0 = tgraph_model_params
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jp = jax.tree.map(jnp.asarray, p0)
    jax_ckpt.CheckpointManager(jdir).save(0, jax.tree.map(
        np.asarray, jax_ckpt_state(jp, jax_opt("adam", 0.01, None).init(jp),
                                   0, jax.random.PRNGKey(0),
                                   rng_impl=None)))
    tp = {ln: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
          for ln, d in p0.items()}
    gens = (torch.Generator().manual_seed(0),
            torch.Generator().manual_seed(1))
    CheckpointManager(tdir).save(0, Trainer._ckpt_state(
        tp, build_optimizer("adam", 0.01).init(tp), 0, gens))
    return jdir, tdir


@pytest.mark.parametrize("ours,theirs,mode", [
    ("fsdp=2", None, "collect"), ("fsdp=2", None, "stream"),
    ("dp=2,tp=2", None, "collect")],
    ids=["fsdp", "fsdp-stream", "dp-tp"])
def test_estimator_model_parallel_mesh_fits(jax_npz, tmp_path, ours, theirs,
                                            mode):
    """``SparkAsyncDL(meshShape=...)`` with an fsdp or a tp axis launches
    its ranks and fits a registry transformer to the weights of the same
    estimator without a mesh, on one device (the same math: sharding is
    placement; the sharded steps, the stream and the tp Trainer are held
    to JAX's in the tests above and in ``tests/test_torch_tp.py``), rows
    collected or streamed. Both fits resume from an epoch-0 checkpoint of
    the same initial weights, rows in order; the fitted models predict the
    same. Adam's epsilon is 1e-4: the key third of ``qkv_bias`` has an
    exactly-zero gradient whose round-off adam would otherwise magnify
    (``tests/test_torch_train.py``). ``theirs`` names a JAX estimator's
    ``meshShape`` to compare with instead (none here: the JAX estimator's
    GSPMD compile costs the suite more than the comparison adds)."""
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal
    spec = build_registry_spec("transformer_classifier", vocab_size=30,
                               num_classes=2, hidden=32, num_layers=2,
                               num_heads=4, mlp_dim=64, max_len=8,
                               dropout=0.0)
    p0 = numpy_params(jax_model(spec).param_specs(), seed=6, std=0.1)
    jdir, tdir = _start_dirs(tmp_path, spec, p0)
    kw = dict(inputCol="features", tensorflowGraph=spec, tfInput="input_ids",
              tfLabel="y", tfOutput="logits", labelCol="label",
              tfOptimizer="adam", tfLearningRate=0.01, iters=3,
              miniBatchSize=16, shufflePerIter=False,
              predictionCol="predicted", fitMode=mode,
              optimizerOptions='{"epsilon": 1e-4}')
    if theirs is None:
        ref_dir = str(tmp_path / "one")
        import shutil
        shutil.copytree(tdir, ref_dir)
        ref = SparkAsyncDL(checkpointDir=ref_dir, device="cpu", **kw).fit(
            _token_rows(tlocal))
        ref_rows = ref.transform(_token_rows(tlocal)).collect()
    else:
        ref = JaxSparkAsyncDL(meshShape=theirs, checkpointDir=jdir,
                              **kw).fit(_token_rows(jlocal))
        ref_rows = ref.transform(_token_rows(jlocal)).collect()
    est = SparkAsyncDL(meshShape=ours, checkpointDir=tdir, device="cpu",
                       **kw)
    tfit = est.fit(_token_rows(tlocal))
    for a, b in zip(resolve_weights(tfit.getOrDefault(tfit.modelWeights)),
                    resolve_weights(ref.getOrDefault(ref.modelWeights))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    stats = est.last_mesh_stats
    assert stats["world"] == (2 if ours == "fsdp=2" else 4)
    # the ranks reduced their gradients over the model axis too: a rank
    # that fell back to the dp step of a {"dp": 1, ...} mesh would run none
    assert all(r["collective_calls"] > 0 for r in stats["ranks"])
    got = np.array([r["predicted"] for r in
                    tfit.transform(_token_rows(tlocal)).collect()])
    want = np.array([r["predicted"] for r in ref_rows])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_estimator_mesh_refusals_match_jax():
    """``tests/test_estimator.py``'s two refusals: tp on an ``nn``-DSL graph
    (no megatron rules) and tp with fsdp (no auto-derivation), with the JAX
    package's messages, before any rank starts."""
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal

    def rows(localml):
        rs = np.random.RandomState(0)
        data = [(float(rs.randint(0, 3)),
                 localml.Vectors.dense(rs.randn(64))) for _ in range(16)]
        spark = localml.LocalSession.builder.appName("r").getOrCreate()
        return spark.createDataFrame(data, ["label", "features"])

    def est(cls, graph, mesh, **kw):
        return cls(inputCol="features", tensorflowGraph=graph, tfInput="x:0",
                   tfLabel="y:0", tfOutput="out:0", labelCol="label",
                   iters=1, miniBatchSize=8, meshShape=mesh, **kw)

    for mesh, match in (("dp=2,tp=4", "param_pspecs"),
                        ("dp=2,tp=2,fsdp=2", "cannot be auto-derived")):
        with pytest.raises(ValueError, match=match) as theirs:
            est(JaxSparkAsyncDL, jax_build_graph(lambda: _graph(jnn)),
                mesh).fit(rows(jlocal))
        with pytest.raises(ValueError, match=match) as ours:
            est(SparkAsyncDL, build_graph(lambda: _graph(tnn)), mesh,
                device="cpu").fit(rows(tlocal))
        assert str(ours.value) == str(theirs.value)


def test_an_fsdp_checkpoint_resumes_on_a_dp_mesh_and_on_one_card(pool2,
                                                                   tmp_path):
    """An fsdp=2 fit's checkpoints hold the standard layout (its 256 x 256
    kernel sharded at rest): a dp=2 fit and a one-card fit on the same
    directory resume at its last epoch, train nothing, and hold its params
    bit for bit."""
    spec = build_graph(lambda: _graph(tnn, 256, 256))
    p0 = numpy_params(jax_model(jax_build_graph(
        lambda: _graph(jnn, 256, 256))).param_specs(), seed=7, std=0.05)
    rs = np.random.RandomState(4)
    x = rs.randn(64, 256).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 64)]
    ck = str(tmp_path / "ck")
    kw = dict(optimizer="adam", learning_rate=1e-2, iters=2,
              mini_batch_size=32, seed=3, checkpoint_dir=ck,
              checkpoint_every=1, inputs=("x:0", "y:0"))
    fsdp = pool2.run(tasks.tp_trainer_fit, spec, {"dp": 1, "fsdp": 2}, kw,
                     x, y, p0)
    assert fsdp[0]["stats"]["ranks"][0]["param_bytes"] < sum(
        a.nbytes for d in p0.values() for a in d.values())
    dp = pool2.run(tasks.tp_trainer_fit, spec, {"dp": 2}, kw, x, y, p0)
    kw.pop("inputs")
    one = Trainer(spec, "x:0", "y:0", device="cpu", **kw)
    r = one.fit(x, y)
    assert one._resumed_from == 2 and r.losses == []
    for got in (dp[0]["params"], {ln: {k: t.detach().numpy()
                                       for k, t in d.items()}
                                  for ln, d in r.params.items()}):
        for ln in got:
            for k in got[ln]:
                np.testing.assert_array_equal(got[ln][k],
                                              fsdp[0]["params"][ln][k])
    assert dp[0]["resumed_from"] == 2 and dp[0]["losses"] == []
