"""PyTorch port, pipeline parallelism: ``parallel/pp.py``'s layout, its
1F1B tables and its gpipe / 1f1b / sequential train step, the trainer's and
the estimator's pp fits, their checkpoints and refusals, against the JAX
package's ``parallel/pp.py`` and pp fits.

The JAX side runs on the conftest's virtual CPU devices; the port's ranks
run over gloo on the CPU in one module-scoped 2-rank pool (the pp=2 steps
and fits, in place as under torchrun) and one 4-rank pool for the single
dp=2 x pp=2 step. Weights and inputs are drawn with numpy and handed to
both packages; dropout is off; the models are tiny (hidden 32, 4 layers,
4 heads, S=16, where both packages take their plain attention).

Tolerances (float32): one SGD step's loss within 1e-5 relative and its
params within rtol 3e-4 / atol 3e-5 (the JAX package's own pin,
``tests/test_models.py``); fits within the JAX estimator tests' 5e-4;
the layout, the tables and ``schedule_ticks`` equal; the refusals word
for word; checkpoints bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_rank_tasks as tasks
from test_torch_shared import numpy_params
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.optimizers import build_optimizer as jax_optimizer
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.parallel.pp import (
    _simulate_1f1b as jax_simulate, make_pp_train_step as jax_pp_step,
    merge_stage_params as jax_merge, pp_pspecs as jax_pp_pspecs,
    split_stage_params as jax_split, split_stage_pspecs as jax_stage_pspecs)
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.parallel.mesh import Mesh
from sparkflow_tpu_torch.parallel.pp import (
    _simulate_1f1b, make_pp_train_step, merge_stage_params, pp_pspecs,
    schedule_ticks, split_stage_params, split_stage_pspecs,
    split_stage_state)
from sparkflow_tpu_torch.trainer import Trainer

S = 16
CLS = dict(vocab_size=64, num_classes=3, hidden=32, num_layers=4,
           num_heads=4, mlp_dim=64, max_len=S, dropout=0.0)
LM = dict(vocab_size=61, hidden=32, num_layers=4, num_heads=4, mlp_dim=64,
          max_len=S, dropout=0.0)
STEP_TOL = dict(rtol=3e-4, atol=3e-5)
SCHEDULES = ("gpipe", "1f1b", "sequential")


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


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


def _case(task, n=8, seed=1):
    """``(spec, p0, ids, y)`` of a task: the classifier's one-hot labels,
    or the lm's attention mask (its token weights)."""
    cfg = CLS if task == "classifier" else LM
    family = ("transformer_classifier" if task == "classifier"
              else "transformer_lm")
    spec = build_registry_spec(family, **cfg)
    p0 = numpy_params(jax_model(spec).param_specs(), seed=seed, std=0.1)
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg["vocab_size"], (n, S)).astype(np.float32)
    if task == "classifier":
        y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    else:
        y = (rs.rand(n, S) > 0.2).astype(np.float32)
    return spec, p0, ids, y


def _jax_step(spec, p0, ids, y, axes, schedule, task, microbatches, lr=0.1):
    """One SGD step of JAX's ``make_pp_train_step``: (loss, standard
    params)."""
    m = jax_model(spec)
    mesh = _jmesh(axes)
    opt = jax_optimizer("gradient_descent", lr, None)
    pp = jax_split(m, jax.tree.map(jnp.asarray, p0), axes["pp"])
    step = jax_pp_step(m, opt, mesh, n_microbatches=microbatches,
                       schedule=schedule, task=task)
    p2, _, loss = step(pp, opt.init(pp), jnp.asarray(ids, jnp.int32),
                       jnp.asarray(y), jax.random.PRNGKey(0))
    return float(loss), _np_tree(jax_merge(m, p2))


# -- the layout and the tables ------------------------------------------------


@pytest.mark.parametrize("task", ["classifier", "lm"])
def test_split_and_merge_are_bit_equal_to_jax(task):
    spec, p0, _ids, _y = _case(task)
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    want = jax_split(jm, jax.tree.map(jnp.asarray, p0), 2)
    got = split_stage_params(tm, p0, 2)
    assert sorted(got["stages"]) == sorted(want["stages"])
    assert sorted(got["shared"]) == sorted(want["shared"])
    for k, v in want["stages"].items():
        assert got["stages"][k].shape == v.shape
        np.testing.assert_array_equal(got["stages"][k].numpy(),
                                      np.asarray(v))
    _close(_np_tree(got["shared"]), _np_tree(want["shared"]), rtol=0,
           atol=0)
    back = merge_stage_params(tm, got)
    _close(_np_tree(back), _np_tree(jax_merge(jm, want)), rtol=0, atol=0)
    _close(_np_tree(back), p0, rtol=0, atol=0)
    # the spec trees: the stage axis over pp, the shared leaves replicated,
    # and a block's own (tp) axes behind the stage axes
    specs, jspecs = pp_pspecs(got), jax_pp_pspecs(want)
    for k in want["stages"]:
        assert tuple(specs["stages"][k]) == tuple(jspecs["stages"][k])
    blk = tm._block_pspecs()
    jblk = jax_model(spec).param_pspecs()["block_0"]
    st = split_stage_pspecs("pp", blk, {})["stages"]
    jst = jax_stage_pspecs("pp", jblk, {})["stages"]
    for k in jblk:
        assert tuple(st[k]) == tuple(jst[k]), k


@pytest.mark.parametrize("P,M", [(2, 2), (4, 4), (4, 8), (3, 5)])
def test_1f1b_tables_and_schedule_ticks_equal_jax(P, M):
    for got, want in zip(_simulate_1f1b(P, M), jax_simulate(P, M)):
        np.testing.assert_array_equal(got, want)
    spec, _p0, _ids, _y = _case("classifier")
    jm = jax_model(spec)
    opt = jax_optimizer("gradient_descent", 0.1, None)
    for schedule in SCHEDULES:
        step = jax_pp_step(jm, opt, _jmesh({"pp": P}), n_microbatches=M,
                           schedule=schedule)
        assert schedule_ticks(schedule, P, M) == step.schedule_ticks


# -- the train step -----------------------------------------------------------


@pytest.mark.parametrize("task", ["classifier", "lm"])
def test_one_sgd_step_under_each_schedule_matches_jax(pool2, task):
    """pp=2, 4 microbatches of 2 rows: each schedule's loss and updated
    params against JAX's step under the same schedule; the ranks agree on
    the loss, and each holds its stage plus the shared leaves."""
    spec, p0, ids, y = _case(task)
    for schedule in SCHEDULES:
        jl, jp = _jax_step(spec, p0, ids, y, {"pp": 2}, schedule, task, 4)
        out = pool2.run(tasks.pp_steps, spec, {"pp": 2}, p0, ids, y,
                        schedule, 4, task)
        assert out[0]["losses"] == out[1]["losses"]
        assert out[0]["ticks"] == schedule_ticks(schedule, 2, 4)
        np.testing.assert_allclose(out[0]["losses"][0], jl, rtol=1e-5,
                                   err_msg=schedule)
        _close(out[0]["params"], jp, f"{task} {schedule}", **STEP_TOL)
        _close(out[1]["params"], out[0]["params"], schedule, rtol=0, atol=0)
        # 8 microbatch hops of 2 x 16 x 32 float32, each way
        assert out[0]["moved"]["pp_hop"] == 4 * 2 * S * 32 * 4
        whole = sum(np.asarray(v).nbytes for d in p0.values()
                    for v in d.values())
        assert all(o["local_bytes"] < whole for o in out)


def test_dp_by_pp_step_matches_jax():
    """dp=2 x pp=2 on 4 ranks: each dp replica pipelines its rows, the
    gradients average over dp — against JAX's step on the same mesh."""
    spec, p0, ids, y = _case("classifier")
    axes = {"dp": 2, "pp": 2}
    jl, jp = _jax_step(spec, p0, ids, y, axes, "1f1b", "classifier", 2)
    with tasks.rank_pool(4, timeout_s=180) as pool:
        out = pool.run(tasks.pp_steps, spec, axes, p0, ids, y, "1f1b", 2,
                       "classifier")
    assert len({o["losses"][0] for o in out}) == 1
    np.testing.assert_allclose(out[0]["losses"][0], jl, rtol=1e-5)
    for o in out:
        _close(o["params"], jp, "dp x pp", **STEP_TOL)


def test_step_misuse_raises_jax_messages():
    spec, _p0, _ids, _y = _case("classifier")
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    jopt = jax_optimizer("gradient_descent", 0.1, None)
    from sparkflow_tpu_torch.optimizers import build_optimizer
    opt = build_optimizer("gradient_descent", 0.1, None)
    for axes, kw in (({"pp": 2}, {"schedule": "zigzag"}),
                     ({"pp": 1}, {"schedule": "1f1b"}),
                     ({"pp": 2}, {"task": "seq2seq"})):
        with pytest.raises(ValueError) as want:
            jax_pp_step(jm, jopt, _jmesh(axes), **kw)
        with pytest.raises(ValueError) as got:
            make_pp_train_step(tm, opt, Mesh(axes), **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        split_stage_params(tm, tm.init(seed=0), 3)


# -- the trainer and the estimator --------------------------------------------


def _fit_kw(**over):
    # no shuffles (the packages' random streams differ) and adam's epsilon
    # at 1e-4: the key third of every qkv_bias has an exactly zero gradient
    # (tests/test_torch_train.py says why), which each side computes as
    # round-off, and adam divides that round-off by its epsilon
    return dict(dict(optimizer="adam", learning_rate=0.01, iters=3,
                     mini_batch_size=8, shuffle_per_iter=False, seed=0,
                     optimizer_options={"epsilon": 1e-4}), **over)


# the estimator's fit, as a Trainer's: 64 rows, batch 16, 4 epochs of 4
# steps, 1f1b over 2 microbatches, a checkpoint every 2 epochs
EST_SPEC = build_registry_spec("transformer_classifier", vocab_size=30,
                               num_classes=2, hidden=32, num_layers=2,
                               num_heads=4, mlp_dim=64, max_len=8,
                               dropout=0.0)
FIT_KW = _fit_kw(iters=4, mini_batch_size=16, pp_schedule="1f1b",
                 pp_microbatches=2, checkpoint_every=2)


@pytest.fixture(scope="module")
def est_data():
    """The rows, the labels (class indices, as the estimator hands them
    over) and the estimator's initial weights: the port model's
    ``init(seed=0)`` (the packages draw initial weights from different
    streams)."""
    rs = np.random.RandomState(7)
    labels = rs.randint(0, 2, 64).astype(np.float32)
    ids = rs.randint(0, 30, (64, 8)).astype(np.float32)
    p0 = _np_tree(model_from_json(EST_SPEC, device="cpu").init(seed=0))
    return ids, labels, p0


@pytest.fixture(scope="module")
def jax_fit(est_data, tmp_path_factory):
    """The JAX trainer's pp fit of the estimator's options, its checkpoints
    in the JAX package's npz format (orbax off)."""
    import sparkflow_tpu.checkpoint as jax_ckpt
    ids, labels, p0 = est_data
    d = str(tmp_path_factory.mktemp("jax_pp"))
    have = jax_ckpt._HAVE_ORBAX
    jax_ckpt._HAVE_ORBAX = False
    try:
        jt = JaxTrainer(EST_SPEC, "input_ids", "y",
                        mesh=_jmesh({"dp": 1, "pp": 2}),
                        **dict(FIT_KW, checkpoint_dir=d))
        r = jt.fit(ids, labels, init_params=jax.tree.map(jnp.asarray, p0))
    finally:
        jax_ckpt._HAVE_ORBAX = have
    return jt, r, d


@pytest.fixture(scope="module")
def port_fit(pool2, est_data, tmp_path_factory):
    """``Trainer(mesh={"dp": 1, "pp": 2})`` in place on the pool's two
    ranks with the same options and checkpoints."""
    ids, labels, p0 = est_data
    d = str(tmp_path_factory.mktemp("port_pp"))
    out = pool2.run(tasks.tp_trainer_fit, EST_SPEC, {"dp": 1, "pp": 2},
                    dict(FIT_KW, checkpoint_dir=d,
                         inputs=("input_ids", "y")), ids, labels, p0)
    return out, d


def test_trainer_pp_fit_matches_jax(port_fit, jax_fit):
    """The port's pp fit against the JAX trainer's pp fit on the same rows
    from the same weights: losses and params within 5e-4; every rank
    returns the standard layout and reports its schedule's span and hops."""
    out, _d = port_fit
    _jt, jr, _jd = jax_fit
    for o in out:
        np.testing.assert_allclose(o["losses"], jr.losses, atol=5e-4)
        _close(o["params"], _np_tree(jr.params), "trainer pp", atol=5e-4,
               rtol=0)
        rank = o["stats"]["ranks"][0]
        assert o["stats"]["strategy"] == "pp"
        assert rank["schedule_ticks"] == schedule_ticks("1f1b", 2, 2)
        assert rank["bytes_moved"]["pp_hop"] > 0


def test_a_pp_checkpoint_interchanges_with_jax_and_resumes_on_one_card(
        port_fit, jax_fit, est_data, monkeypatch):
    """A pp fit's checkpoint holds the stacked stage layout, as JAX's pp fit
    writes it: each package's CheckpointManager reads the other's pp
    checkpoint to bit-equal params and optimizer state, and the port's pp
    checkpoint resumes on one card bit for bit (the resumed fit trains
    nothing)."""
    import sparkflow_tpu.checkpoint as jax_ckpt
    from sparkflow_tpu.trainer import _ckpt_state as jax_ckpt_state
    from sparkflow_tpu_torch.convert import sorted_leaves
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)
    ids, labels, _p0 = est_data
    (out, d_port), (jt, _jr, d_jax) = port_fit, jax_fit
    jm = jax_model(EST_SPEC)
    jlike = jax.tree.map(np.asarray, jax_ckpt_state(
        jax_split(jm, jt.params, 2), jt._last_opt_state, 0,
        jax.random.PRNGKey(0), rng_impl=None))
    kw = {k: v for k, v in FIT_KW.items() if not k.startswith("pp_")}
    one = Trainer(EST_SPEC, "input_ids", "y", device="cpu",
                  **dict(kw, checkpoint_dir=d_port))
    r = one.fit(ids, labels)
    assert one._resumed_from == 4 and r.losses == []
    _close(_np_tree({k: {kk: t.detach() for kk, t in d.items()}
                     for k, d in r.params.items()}), out[0]["params"],
           "resumed", rtol=0, atol=0)
    tm = one.model
    tlike = one._ckpt_state(
        split_stage_params(tm, one.params, 2),
        split_stage_state(one.optimizer, tm, one.params,
                          one._last_opt_state, 2), 0, one._generators())
    for d in (d_port, d_jax):
        jstate = jax_ckpt.CheckpointManager(d).restore(step=2, like=jlike)
        tstate = CheckpointManager(d).restore(step=2, like=tlike)
        assert int(tstate["epoch"]) == int(jstate["epoch"]) == 2
        for key in ("params", "opt_state"):
            want = jax.tree.leaves(jstate[key])
            got = [np.asarray(v) for _p, v in sorted_leaves(tstate[key])]
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g, np.asarray(w))
        assert np.shape(tstate["params"]["stages"]["qkv_kernel"]) == (
            2, 1, 32, 96)


def test_estimator_pp_fit_matches_jax_and_serves_without_a_mesh(
        spark, est_data, jax_fit):
    """``SparkAsyncDL(meshShape="pp=2", ppSchedule="1f1b",
    ppMicrobatches=2)`` (launched ranks) against the JAX trainer's pp fit
    with the same options from the same initial weights (the estimator's)
    within 5e-4; the fitted model transforms without a mesh."""
    from sparkflow_tpu_torch import localml
    from sparkflow_tpu_torch.ml_util import convert_json_to_weights
    from sparkflow_tpu_torch.spark_async import SparkAsyncDL
    ids, labels, _p0 = est_data
    jt = jax_fit[0]
    df = spark.createDataFrame([(float(lab), localml.Vectors.dense(v))
                                for lab, v in zip(labels, ids)],
                               ["label", "features"])
    m_pp = SparkAsyncDL(
        inputCol="features", tensorflowGraph=EST_SPEC, tfInput="input_ids",
        tfLabel="y", tfOutput="logits", labelCol="label", tfOptimizer="adam",
        tfLearningRate=.01, iters=4, miniBatchSize=16,
        predictionCol="predicted", shufflePerIter=False,
        optimizerOptions='{"epsilon": 1e-4}', meshShape="pp=2",
        ppSchedule="1f1b", ppMicrobatches=2, device="cpu").fit(df)
    got = convert_json_to_weights(m_pp.getOrDefault(m_pp.modelWeights))
    want = [np.asarray(w) for w in jt.weights_list()]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=5e-4)
    assert m_pp.transform(df).count() == 64


@pytest.fixture(scope="module")
def spark():
    from sparkflow_tpu_torch.localml import LocalSession
    return LocalSession.builder.appName("torch-pp").getOrCreate()


def _refusal_cases():
    """``(name, mesh, trainer kwargs, spec kind, fit inputs)`` of the JAX
    trainer's pp refusals, each raised before any rank starts."""
    return [
        ("pp with sp", {"pp": 2, "sp": 2}, {}, "lm", "ids"),
        ("pp with tp", {"pp": 2, "tp": 2}, {}, "lm", "ids"),
        ("no block structure", {"dp": 1, "pp": 2}, {}, "dsl", "x"),
        ("num_layers % pp", {"dp": 1, "pp": 3}, {}, "lm", "ids"),
        ("multi-input classifier", {"dp": 1, "pp": 2}, {}, "cls2", "ids2"),
        ("microbatches", {"dp": 1, "pp": 2}, {"pp_microbatches": 3}, "lm",
         "ids"),
    ]


@pytest.mark.parametrize("case", _refusal_cases(), ids=lambda c: c[0])
def test_trainer_pp_refusals_match_jax(case):
    from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
    import sparkflow_tpu.nn as jnn
    _name, axes, over, kind, feed = case
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 61, (16, S)).astype(np.float32)
    mask = np.ones((16, S), np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    if kind == "dsl":
        def g():
            x = jnn.placeholder([None, 4], name="x")
            jnn.dense(x, 2, name="out")
        spec, inputs, label = jax_build_graph(g), "x:0", None
        args = (rs.rand(16, 4).astype(np.float32),)
    elif kind == "cls2":
        spec = build_registry_spec("transformer_classifier", **CLS)
        inputs, label = ["input_ids", "attention_mask"], "y"
        args = ((ids, mask), y)
    else:
        spec, inputs, label = build_registry_spec("transformer_lm", **LM), \
            "input_ids", None
        args = (ids,)
    kw = _fit_kw(**over)
    with pytest.raises(ValueError) as want:
        JaxTrainer(spec, inputs, label, mesh=_jmesh(axes), **kw).fit(*args)
    with pytest.raises(ValueError) as got:
        Trainer(spec, inputs, label, mesh=axes, device="cpu",
                **kw).fit(*args)
    assert str(got.value) == str(want.value)


def test_fit_stream_and_the_estimator_refuse_a_pp_mesh():
    """JAX's refusals of a pp mesh in a streaming fit, at the trainer and at
    the estimator (``fitMode="stream"``), and of an unknown ``ppSchedule``,
    message for message."""
    from sparkflow_tpu.spark_async import SparkAsyncDL as JaxSparkAsyncDL
    from sparkflow_tpu_torch.spark_async import SparkAsyncDL
    spec = build_registry_spec("transformer_lm", **LM)
    rows = [np.arange(S, dtype=np.float32)] * 8
    with pytest.raises(ValueError) as want:
        JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"dp": 1, "pp": 2}),
                   **_fit_kw()).fit_stream(lambda: iter(rows))
    with pytest.raises(ValueError) as got:
        Trainer(spec, "input_ids", None, mesh={"dp": 1, "pp": 2},
                device="cpu", **_fit_kw()).fit_stream(lambda: iter(rows))
    assert str(got.value) == str(want.value)
    kw = dict(inputCol="features", tensorflowGraph=spec, tfInput="input_ids",
              tfLabel=None, labelCol=None, tfOutput="logits")
    for over in ({"meshShape": "pp=2", "fitMode": "stream"},
                 {"meshShape": "pp=2", "ppSchedule": "zigzag"}):
        with pytest.raises(ValueError) as want:
            JaxSparkAsyncDL(**kw, **over)._validate_params()
        with pytest.raises(ValueError) as got:
            SparkAsyncDL(device="cpu", **kw, **over)._validate_params()
        assert str(got.value) == str(want.value)
