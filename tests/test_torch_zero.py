"""PyTorch port, synchronous data parallelism with ZeRO stages 0-3:
``optimizers_sharded.py``, ``parallel/dp.py``, the trainer's mesh path and
the estimator's ``meshShape`` / ``weightUpdateSharding`` / ``zeroStage``,
against the JAX package's.

The JAX side runs on the conftest's virtual CPU devices; the port's ranks
run over gloo on the CPU, in one 2-rank and one 4-rank
:class:`~sparkflow_tpu_torch.parallel.distributed.RankPool` for the module
(a fit inside a pool rank runs in place, as under torchrun); the estimator
tests launch their own ranks, as a user's fit does. The bar is the JAX
ZeRO tests': losses and params within atol 5e-5 / rtol 1e-5 of JAX's for
every registry optimizer at every stage, on a model whose sizes are ragged
mod 2 (the flat-pad path). Layouts are JAX's bit for bit, so checkpoints
written at any stage restore at any other, and interchange with the JAX
trainer's npz checkpoints.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparkflow_tpu.checkpoint as jax_ckpt
import sparkflow_tpu.nn as jnn
import torch_rank_tasks as tasks
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.optimizers import build_optimizer as jax_opt
from sparkflow_tpu.optimizers_sharded import (
    gather_zero1_state as jax_gather_z1, gather_zero3_params as jax_gather_z3,
    has_per_param_state as jax_has_state, place_zero1_state as jax_place,
    shard_zero1_state as jax_shard_z1, shard_zero3_params as jax_shard_z3,
    sharded_update as jax_sharded_update, zero3_param_shardings,
    zero_memory_report as jax_report)
from sparkflow_tpu.parallel.dp import (
    make_dp_shardmap_train_step as jax_stage0_shim,
    make_dp_train_step as jax_dp_step,
    make_dp_zero1_train_step as jax_stage1_shim)
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.sharding import ShardingConfig as JaxConfig
from sparkflow_tpu.spark_async import SparkAsyncDL as JaxSparkAsyncDL
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu.trainer import _ckpt_state as jax_ckpt_state
from sparkflow_tpu_torch import nn as tnn
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.convert import sorted_leaves
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.ml_util import resolve_weights
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.models.presets import mlp
from sparkflow_tpu_torch.optimizers import (AVAILABLE_OPTIMIZERS,
                                            build_optimizer)
from sparkflow_tpu_torch.optimizers_sharded import (
    gather_zero1_state, gather_zero3_params, has_per_param_state,
    shard_zero1_state, shard_zero3_params, sharded_update,
    zero1_state_specs, zero_memory_report)
from sparkflow_tpu_torch.parallel import distributed as D
from sparkflow_tpu_torch.parallel.dp import (make_dp_shardmap_train_step,
                                             make_dp_zero1_train_step)
from sparkflow_tpu_torch.parallel.mesh import Mesh
from sparkflow_tpu_torch.sharding import ShardingConfig
from sparkflow_tpu_torch.spark_async import SparkAsyncDL
from sparkflow_tpu_torch.trainer import Trainer

ATOL = 5e-5
RTOL = 1e-5
SPEC = mlp(10, 3, hidden=(17,))   # every size ragged mod 2 and mod 4


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tasks.rank_pool(4, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def p0():
    p = jax_model(SPEC).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 10).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


def _close(ours, theirs, msg=""):
    """Two param trees (nested dicts) within the JAX ZeRO tests' bar."""
    for layer in theirs:
        for k in theirs[layer]:
            np.testing.assert_allclose(
                np.asarray(ours[layer][k]), np.asarray(theirs[layer][k]),
                atol=ATOL, rtol=RTOL, err_msg=f"{msg} {layer}/{k}")


def _jax_stage(opt, mesh, stage, p0, x, y, n, dcn_axis=None, steps=2):
    """The JAX package's make_dp_train_step at ``stage`` (its own tests'
    recipe), standard params back."""
    cfg = JaxConfig(zero_stage=stage, dcn_axis=dcn_axis)
    step = jax_dp_step(jax_model(SPEC), opt, mesh, "x:0", "y:0",
                       sharding=cfg)
    p = jax.tree.map(jnp.array, p0)
    if stage == 0:
        s = opt.init(p)
    else:
        s = jax_place(jax_sharded_update(opt, n, "dp", dcn_axis).init(p),
                      mesh, n)
    if stage >= 3:
        p = jax_shard_z3(p, n)
        p = jax.tree.map(jax.device_put, p, zero3_param_shardings(p, mesh, n))
    mask = jnp.ones((x.shape[0],), jnp.float32)
    losses = []
    for i in range(steps):
        p, s, loss = step(p, s, jnp.asarray(x), jnp.asarray(y), mask,
                          jax.random.fold_in(jax.random.PRNGKey(1), i))
        losses.append(float(loss))
    if stage >= 3:
        p = jax_gather_z3(p, p0)
    return losses, jax.tree.map(np.asarray, p)


# -- the per-rank step, every optimizer, every stage --------------------------

@pytest.mark.parametrize("opt_name", AVAILABLE_OPTIMIZERS)
def test_zero_steps_match_jax_all_optimizers(pool2, p0, opt_name):
    x, y = _data()
    ours = pool2.run(tasks.dp_all_stages, {"dp": 2}, SPEC, opt_name, p0, x,
                     y)
    mesh = jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    opt = jax_opt(opt_name, 1e-2, None)
    for stage in (0, 1, 2, 3):
        want_l, want_p = _jax_stage(opt, mesh, stage, p0, x, y, 2)
        for r in range(2):     # every rank ends with the same params
            got = ours[r][stage]
            np.testing.assert_allclose(got["losses"], want_l, atol=ATOL,
                                       rtol=0, err_msg=f"{opt_name} {stage}")
            _close(got["params"], want_p, f"{opt_name} stage {stage}")


def test_two_level_dcn_matches_flat_and_jax(pool4, p0):
    """Stages 0-3 on {dcn: 2, dp: 2} (the hierarchical reduction) against
    the flat {dp: 4} step and JAX's two-level step."""
    x, y = _data(32)
    two = pool4.run(tasks.dp_all_stages, {"dcn": 2, "dp": 2}, SPEC, "adam",
                    p0, x, y, dcn_axis="dcn")
    flat = pool4.run(tasks.dp_all_stages, {"dp": 4}, SPEC, "adam", p0, x, y)
    mesh = jax_make_mesh({"dcn": 2, "dp": 2}, devices=jax.devices()[:4])
    opt = jax_opt("adam", 1e-2, None)
    for stage in (0, 1, 2, 3):
        want_l, want_p = _jax_stage(opt, mesh, stage, p0, x, y, 2,
                                    dcn_axis="dcn")
        for r in range(4):
            np.testing.assert_allclose(two[r][stage]["losses"], want_l,
                                       atol=ATOL, rtol=0)
            _close(two[r][stage]["params"], want_p, f"dcn stage {stage}")
            np.testing.assert_allclose(two[r][stage]["losses"],
                                       flat[r][stage]["losses"], atol=ATOL,
                                       rtol=0)
            _close(two[r][stage]["params"], flat[r][stage]["params"],
                   f"flat stage {stage}")


def test_dcn_axis_equal_dp_raises_actionable():
    m = model_from_json(SPEC, device="cpu")
    opt = build_optimizer("adam", 1e-2, None)
    mesh = Mesh({"dp": 2})
    jm = jax_model(SPEC)
    jmesh = jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    jopt = jax_opt("adam", 1e-2, None)
    for ours, theirs, kw in (
            (make_dp_shardmap_train_step, jax_stage0_shim, {"dcn_axis": "dp"}),
            (make_dp_zero1_train_step, jax_stage1_shim, {"dcn_axis": "dp"}),
            (make_dp_shardmap_train_step, jax_stage0_shim,
             {"dcn_axis": "nope"})):
        with pytest.raises(ValueError) as a:
            ours(m, opt, mesh, "x:0", "y:0", **kw)
        with pytest.raises(ValueError) as b:
            theirs(jm, jopt, jmesh, "x:0", "y:0", **kw)
        assert str(a.value) == str(b.value)
    assert "DIFFERENT mesh axis" in str(a.value) or "not a mesh axis" in \
        str(a.value)


# -- layouts ------------------------------------------------------------------

def _as_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def test_zero3_param_roundtrip_across_shard_counts(p0):
    """Standard -> flat(8) -> standard -> flat(4) -> standard is exact, and
    each flat tree is JAX's bit for bit."""
    tp = _as_torch(p0)
    for n in (8, 4, 2):
        ours = shard_zero3_params(tp, n)
        theirs = jax_shard_z3(jax.tree.map(jnp.asarray, p0), n)
        for layer in p0:
            for k in p0[layer]:
                assert ours[layer][k].shape[0] == n
                assert np.array_equal(ours[layer][k].numpy(),
                                      np.asarray(theirs[layer][k]))
        back = gather_zero3_params(ours, tp)
        for layer in p0:
            for k in p0[layer]:
                assert np.array_equal(back[layer][k].numpy(), p0[layer][k])


def test_zero1_state_layouts_match_jax_and_round_trip(p0):
    """Standard adam state -> zero layout (n = 8, 4, 2) is JAX's bit for
    bit, and gathers back to the standard state exactly."""
    opt, jopt = build_optimizer("adam", 1e-2, None), jax_opt("adam", 1e-2,
                                                             None)
    tp = _as_torch(p0)
    # non-trivial leaves so the reshape / trim paths are exercised
    mu = jax.tree.map(lambda a: a + np.arange(a.size, dtype=np.float32)
                      .reshape(a.shape), p0)
    std = opt.init(tp)
    std = (std[0]._replace(mu=_as_torch(mu)),) + tuple(std[1:])
    jstd = jopt.init(jax.tree.map(jnp.asarray, p0))
    jstd = (jstd[0]._replace(mu=jax.tree.map(jnp.asarray, mu)),) + \
        tuple(jstd[1:])
    for n in (8, 4, 2):
        z = shard_zero1_state(opt, tp, std, n)
        jz = jax_shard_z1(jopt, jax.tree.map(jnp.asarray, p0), jstd, n)
        assert int(z[0].count) == int(jz[0].count)
        for field in ("mu", "nu"):
            for layer in p0:
                for k in p0[layer]:
                    a = getattr(z[0], field)[layer][k].numpy()
                    b = np.asarray(getattr(jz[0], field)[layer][k])
                    assert a.shape == b.shape and np.array_equal(a, b)
        back = gather_zero1_state(opt, tp, z, n)
        jback = jax_gather_z1(jopt, jax.tree.map(jnp.asarray, p0), jz, n)
        for layer in p0:
            for k in p0[layer]:
                assert np.array_equal(back[0].mu[layer][k].numpy(),
                                      mu[layer][k])
                assert np.array_equal(np.asarray(jback[0].mu[layer][k]),
                                      mu[layer][k])
        specs = zero1_state_specs(z, n)
        assert tuple(specs[0].mu["out/BiasAdd"]["bias"]) == ("dp",)
        assert tuple(specs[0].count) == ()


def test_zero_memory_report_equals_jax_and_shrinks_with_stage(p0):
    opt, jopt = build_optimizer("adam", 1e-2, None), jax_opt("adam", 1e-2,
                                                             None)
    tp = _as_torch(p0)
    reps = {}
    for s in (0, 1, 2, 3):
        reps[s] = zero_memory_report(opt, tp, 8, s)
        want = jax_report(jopt, jax.tree.map(jnp.asarray, p0), 8, s)
        assert reps[s] == pytest.approx(want), s
    assert reps[1]["grad_opt_at_update"] < reps[0]["grad_opt_at_update"] / 4
    assert reps[2]["grad_opt_at_update"] <= reps[1]["grad_opt_at_update"]
    assert reps[3]["params_at_rest"] < reps[0]["params_at_rest"] / 4
    assert (reps[2]["grad_opt_at_update"]
            <= 1.3 * reps[2]["ideal_grad_opt"])
    with pytest.raises(ValueError, match="zero_stage must be 0..3"):
        zero_memory_report(opt, tp, 8, 4)


def test_has_per_param_state(p0):
    tp = _as_torch(p0)
    for name in AVAILABLE_OPTIMIZERS:
        assert has_per_param_state(build_optimizer(name, 1e-2, None), tp) \
            == jax_has_state(jax_opt(name, 1e-2, None),
                             jax.tree.map(jnp.asarray, p0)), name
    assert has_per_param_state(sharded_update(
        build_optimizer("adam", 1e-2, None), 2), tp)


# -- the trainer --------------------------------------------------------------

_TRAIN = dict(optimizer="adam", learning_rate=1e-2, mini_batch_size=16,
              iters=3, seed=3, shuffle_per_iter=False)


def _jax_fit(stage, x, y, p0, mesh=None, **kw):
    t = JaxTrainer(SPEC, "x:0", "y:0",
                   mesh=mesh or jax_make_mesh({"dp": 2},
                                              devices=jax.devices()[:2]),
                   sharding=JaxConfig(zero_stage=stage), **dict(_TRAIN, **kw))
    r = t.fit(x, y, init_params=jax.tree.map(jnp.asarray, p0))
    return t, r


def test_trainer_all_stages_agree_and_return_standard_layout(pool2, p0):
    x, y = _data()
    for stage in (0, 1, 2, 3):
        ours = pool2.run(tasks.trainer_fit, SPEC, {"dp": 2},
                         dict(_TRAIN, sharding=stage), x, y, p0)
        jt, jr = _jax_fit(stage, x, y, p0)
        assert jt._zero_stage == stage
        for o in ours:
            assert o["zero_stage"] == stage and o["stop"] == "completed"
            for layer in p0:     # the standard layout, at every stage
                for k in p0[layer]:
                    assert o["params"][layer][k].shape == p0[layer][k].shape
            np.testing.assert_allclose(o["losses"], jr.losses, atol=ATOL,
                                       rtol=0)
            _close(o["params"], jax.tree.map(np.asarray, jr.params),
                   f"stage {stage}")
        st = ours[0]["stats"]
        assert st["backend"] == "gloo" and st["zero_stage"] == stage
        me = st["ranks"][0]
        assert me["steps"] == 12 and len(me["epoch_ms"]) == 3
        moved = me["bytes_moved"]
        if stage == 0:
            assert moved["reduce_scatter"] == 0 and moved["all_reduce"] > 0
        else:
            assert moved["reduce_scatter"] > 0 and moved["all_gather"] > 0


def test_zero_state_shrinks_per_rank(pool2, p0):
    x, y = _data()
    off = pool2.run(tasks.trainer_fit, SPEC, {"dp": 2},
                    dict(_TRAIN, iters=1, sharding=0), x, y, p0)
    on = pool2.run(tasks.trainer_fit, SPEC, {"dp": 2},
                   dict(_TRAIN, iters=1, sharding=3), x, y, p0)
    full = off[0]["stats"]["ranks"][0]
    half = on[0]["stats"]["ranks"][0]
    assert half["opt_state_bytes"] < 0.6 * full["opt_state_bytes"]
    assert half["param_bytes"] < 0.6 * full["param_bytes"]


@pytest.mark.parametrize("save_stage", [0, 1, 2, 3])
def test_checkpoint_interchange_matrix(pool2, p0, save_stage, tmp_path):
    """A checkpoint written at any stage restores at every other with
    bit-identical params: checkpoints hold the standard layout."""
    x, y = _data()
    out = pool2.run(tasks.checkpoint_matrix, SPEC, save_stage,
                    str(tmp_path / "ck"), x, y, dict(_TRAIN, iters=2))
    for o in out:
        for stage, got in o["restored"].items():
            for layer in p0:
                for k in p0[layer]:
                    assert np.array_equal(got[layer][k],
                                          o["saved"][layer][k]), \
                        (save_stage, stage)


@pytest.fixture
def jax_npz(monkeypatch):
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)


def _port_like(x, y):
    tt = Trainer(SPEC, "x:0", "y:0", iters=1, device="cpu",
                 **{k: v for k, v in _TRAIN.items() if k != "iters"})
    tt.fit(x, y)
    return tt._ckpt_state(tt.params, tt._last_opt_state, 0,
                          tt._generators())


def _jax_like(x, y, p0):
    jt = JaxTrainer(SPEC, "x:0", "y:0", **dict(_TRAIN, iters=1))
    jt.fit(x, y, init_params=jax.tree.map(jnp.asarray, p0))
    return jax.tree.map(np.asarray, jax_ckpt_state(
        jt.params, jt._last_opt_state, 0, jax.random.PRNGKey(0),
        rng_impl=None))


def _state_equal(jstate, tstate):
    assert int(tstate["epoch"]) == int(jstate["epoch"])
    for key in ("params", "opt_state"):
        want = jax.tree.leaves(jstate[key])
        got = [np.asarray(v) for _p, v in sorted_leaves(tstate[key])]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("stage", [1, 3])
def test_npz_checkpoints_interchange_with_jax(pool2, p0, jax_npz, stage,
                                              tmp_path):
    x, y = _data()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _jax_fit(stage, x, y, p0, checkpoint_dir=jdir, checkpoint_every=1)
    pool2.run(tasks.trainer_fit, SPEC, {"dp": 2},
              dict(_TRAIN, sharding=stage, checkpoint_dir=tdir,
                   checkpoint_every=1), x, y, p0)
    tlike, jlike = _port_like(x, y), _jax_like(x, y, p0)
    for step in (1, 3):
        # the JAX mesh fit's checkpoint, read by the port, and the port's,
        # read by JAX: each bit-equal to its writer's own reading
        _state_equal(jax_ckpt.CheckpointManager(jdir).restore(
            step=step, like=jlike), CheckpointManager(jdir).restore(
            step=step, like=tlike))
        _state_equal(jax_ckpt.CheckpointManager(tdir).restore(
            step=step, like=jlike), CheckpointManager(tdir).restore(
            step=step, like=tlike))


def test_zero1_auto_gating(pool2):
    """weight_update_sharding='auto' turns ZeRO-1 on for per-param state on
    a dp >= 2 mesh only, as in JAX; 'on' where ineligible falls back."""
    x, y = _data()
    got = pool2.run(tasks.gating, SPEC, x, y)[0]
    assert got == {"adam": 1, "sgd": 0, "clip": 0, "off": 0, "on": 1}
    t = Trainer(SPEC, "x:0", "y:0", optimizer="adam", iters=1,
                mini_batch_size=32, device="cpu")
    t.fit(x, y)
    assert not t._zero1_active
    t = Trainer(SPEC, "x:0", "y:0", optimizer="adam", iters=1,
                mini_batch_size=32, weight_update_sharding="on",
                device="cpu")
    t.fit(x, y)
    assert not t._zero1_active
    with pytest.raises(ValueError, match="weight_update_sharding"):
        Trainer(SPEC, "x:0", "y:0", weight_update_sharding="sideways",
                device="cpu")


def test_trainer_explicit_stage_requests_raise_when_ineligible():
    """The JAX trainer's errors, word for word, before any rank starts."""
    lm = build_registry_spec("transformer_lm", vocab_size=32, hidden=16,
                             num_layers=1, num_heads=2, mlp_dim=32,
                             max_len=8, dropout=0.0)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 32, (16, 8)).astype(np.float32)
    x, y = _data(32)
    cases = [
        # dp-less mesh: the config's own actionable message
        (lm, None, ids, None, {"dp": 1, "sp": 2}, 2, {}),
        # blocked optimizer options: shard-local update breaks their math
        (SPEC, "y:0", x, y, {"dp": 2}, 2,
         {"optimizer_options": {"clip_norm": 1.0}}),
        # no mesh at all
        (SPEC, "y:0", x, y, None, 2, {}),
    ]
    for spec, label, fx, fy, axes, stage, kw in cases:
        jmesh = (jax_make_mesh(axes, devices=jax.devices()[:int(np.prod(
            list(axes.values())))]) if axes else None)
        with pytest.raises(ValueError) as a:
            Trainer(spec, "input_ids" if label is None else "x:0", label,
                    optimizer="adam", mini_batch_size=16, iters=1,
                    mesh=axes, sharding=ShardingConfig(zero_stage=stage),
                    device="cpu", **kw).fit(fx, fy)
        with pytest.raises(ValueError) as b:
            JaxTrainer(spec, "input_ids" if label is None else "x:0", label,
                       optimizer="adam", mini_batch_size=16, iters=1,
                       mesh=jmesh, sharding=JaxConfig(zero_stage=stage),
                       **kw).fit(fx, fy)
        assert str(a.value) == str(b.value)
        assert f"zero_stage={stage}" in str(a.value)


def test_launch_needs_what_a_rank_can_rebuild():
    x, y = _data(32)
    t = Trainer(model_from_json(SPEC, device="cpu"), "x:0", "y:0",
                mesh={"dp": 2}, device="cpu")
    with pytest.raises(ValueError, match="spec JSON string"):
        t.fit(x, y)
    t = Trainer(SPEC, "x:0", "y:0", optimizer=build_optimizer("adam", 0.1),
                mesh={"dp": 2}, device="cpu")
    with pytest.raises(ValueError, match="by name"):
        t.fit(x, y)
    # offload_opt_state, fit_stream and predict_fn on a dp mesh are ported
    # (tests/test_torch_stream_mesh.py, tests/test_torch_mesh_predict.py):
    # the calls that item 7 refused now work
    t = Trainer(SPEC, "x:0", "y:0", mesh={"dp": 2},
                sharding=ShardingConfig(offload_opt_state=True),
                device="cpu")
    assert t.sharding.offload_opt_state
    # an empty stream fails as one process's does, before any rank starts
    with pytest.raises(ValueError, match="no training data"):
        Trainer(SPEC, "x:0", "y:0", mesh={"dp": 2},
                device="cpu").fit_stream(iter([]))
    t = Trainer(SPEC, "x:0", "y:0", device="cpu")
    p = t.model.init(seed=1)
    np.testing.assert_allclose(
        t.predict_fn("out:0", mesh={"dp": 2})(p, x[:5]).numpy(),
        t.predict_fn("out:0")(p, x[:5]).numpy(), atol=1e-6, rtol=0)


# -- the estimator ------------------------------------------------------------

def _gauss_model(nn):
    x = nn.placeholder([None, 2], name="x")
    y = nn.placeholder([None, 1], name="y")
    h = nn.dense(x, 12, activation="relu")
    h = nn.dense(h, 5, activation="relu")
    out = nn.dense(h, 1, activation="sigmoid", name="outer")
    nn.sigmoid_cross_entropy(y, out)


def _gauss_rows(localml):
    rs = np.random.RandomState(12345)
    rows = []
    for _ in range(200):
        rows.append((1.0, localml.Vectors.dense(rs.normal(2, 1, 2))))
        rows.append((0.0, localml.Vectors.dense(rs.normal(-2, 1, 2))))
    spark = localml.LocalSession.builder.appName("zero").getOrCreate()
    return spark.createDataFrame(rows, ["label", "features"])


def _est_kw(graph):
    return dict(inputCol="features", tensorflowGraph=graph, tfInput="x:0",
                tfLabel="y:0", tfOutput="outer/Sigmoid:0",
                tfOptimizer="adam", tfLearningRate=0.05, iters=3,
                miniBatchSize=400, shufflePerIter=False,
                predictionCol="predicted", labelCol="label")


@pytest.mark.parametrize("params", [{"zeroStage": 3},
                                    {"weightUpdateSharding": "on"}],
                         ids=lambda d: next(iter(d)))
def test_estimator_mesh_fit_and_predict_as_jax(jax_npz, params, tmp_path):
    """SparkAsyncDL(meshShape="dp=2") launches two ranks and fits and
    predicts as the JAX estimator on its 8-way mesh does on the same rows:
    both resume from an epoch-0 checkpoint holding the same initial
    weights, rows in order (full batch, no shuffle)."""
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal
    jgraph = jax_build_graph(lambda: _gauss_model(jnn))
    tgraph = build_graph(lambda: _gauss_model(tnn))
    p0 = jax.tree.map(np.asarray, jax_model(jgraph).init(
        jax.random.PRNGKey(7)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jopt = jax_opt("adam", 0.05, None)
    jax_ckpt.CheckpointManager(jdir).save(0, jax.tree.map(
        np.asarray, jax_ckpt_state(jax.tree.map(jnp.asarray, p0),
                                   jopt.init(jax.tree.map(jnp.asarray, p0)),
                                   0, jax.random.PRNGKey(0), rng_impl=None)))
    tp = _as_torch(p0)
    gens = (torch.Generator().manual_seed(0),
            torch.Generator().manual_seed(1))
    CheckpointManager(tdir).save(0, Trainer._ckpt_state(
        tp, build_optimizer("adam", 0.05).init(tp), 0, gens))

    jfit = JaxSparkAsyncDL(meshShape="dp=-1", checkpointDir=jdir,
                           **_est_kw(jgraph), **params).fit(
        _gauss_rows(jlocal))
    tfit = SparkAsyncDL(meshShape="dp=2", checkpointDir=tdir, device="cpu",
                        **_est_kw(tgraph), **params).fit(_gauss_rows(tlocal))
    for a, b in zip(resolve_weights(tfit.getOrDefault(tfit.modelWeights)),
                    resolve_weights(jfit.getOrDefault(jfit.modelWeights))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    got = [float(r["predicted"]) for r in
           tfit.transform(_gauss_rows(tlocal)).collect()]
    want = [float(r["predicted"]) for r in
            jfit.transform(_gauss_rows(jlocal)).collect()]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_estimator_mesh_params_follow_jax():
    kw = dict(inputCol="features", tensorflowGraph=SPEC, tfInput="x:0",
              tfLabel="y:0", tfOutput="out:0", labelCol="labels")
    for over in ({"meshShape": "sp=2"}, {"meshShape": "dp=2"},
                 {"meshShape": "sp=2", "fitMode": "stream"},
                 {"zeroStage": 5}, {"weightUpdateSharding": "banana"},
                 {"zeroStage": 2}):
        ours, theirs = SparkAsyncDL(**kw, **over), JaxSparkAsyncDL(**kw,
                                                                   **over)
        try:
            want = theirs._validate_params()[-1]
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                ours._validate_params()
            assert str(got.value) == str(e)
            continue
        assert ours._validate_params()[-1] == want
        assert (ours._sharding_config() is None) == \
            (theirs._sharding_config() is None)
        if ours._sharding_config() is not None:
            assert ours._sharding_config().describe() == \
                theirs._sharding_config().describe()
