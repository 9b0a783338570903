"""PyTorch port, Megatron tensor parallelism: ``parallel/tp.py``'s spec
rules and layouts, the Megatron forward of ``models/transformer.py`` and
the MoE mixin, the sharded step of ``parallel/dp.py`` and the trainer's
``tp`` fits, against the JAX package's GSPMD path.

The JAX side runs on the conftest's virtual CPU devices; the port's ranks
run over gloo on the CPU in one module-scoped 2-rank pool and one 4-rank
pool (the dp=2 x tp=2 step), each fit in place as under torchrun. Weights
are drawn with numpy and handed to both packages; dropout is off except
where a test says otherwise; the models are tiny (hidden 32, 2 layers, 4
heads, S=16, where both packages take their plain attention).

Tolerances (float32; the shards sum their partials in another order than
one matmul): one SGD step's loss within 1e-5 relative and its params
within rtol 3e-4 / atol 3e-5 (the JAX package's own pin,
``tests/test_models.py``); gradients within 1e-5 absolute plus 1e-4
relative; 4 adam steps' losses within 2e-4 and params within 1e-5, with
adam's epsilon at 1e-4: the key third of every ``qkv_bias`` has an exactly
zero gradient (``tests/test_torch_train.py`` says why), which each side
computes as round-off, and adam divides that round-off by its epsilon (at
1e-6 the two packages' qkv_bias key entries drift 3.3e-5 apart in 4 steps,
every other leaf stays within 1e-5);
``tp_pack_params`` and the specs bit- or string-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_tasks as tasks
from test_torch_shared import numpy_params
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.parallel.tp import (
    derive_param_pspecs as jax_derive, filter_pspec as jax_filter,
    fsdp_pspecs as jax_fsdp_pspecs, make_sharded_train_step as jax_step,
    rename_pspec_axes as jax_rename, shard_params as jax_shard,
    tp_pack_params as jax_pack)
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.parallel.mesh import Mesh
from sparkflow_tpu_torch.parallel.tp import (
    derive_param_pspecs, filter_pspec, fsdp_pspecs, rename_pspec_axes,
    tp_pack_params, tp_unpack_params)
from sparkflow_tpu_torch.sharding import P
from sparkflow_tpu_torch.trainer import Trainer

S = 16
CLS = dict(vocab_size=64, num_classes=3, hidden=32, num_layers=2,
           num_heads=4, mlp_dim=64, max_len=S, dropout=0.0)
LM = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4, mlp_dim=64,
          max_len=S, dropout=0.0)
MOE = dict(LM, num_experts=4, moe_every=2, capacity_factor=2.0)
STEP_TOL = dict(rtol=3e-4, atol=3e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tasks.rank_pool(4, timeout_s=180) as pool:
        yield pool


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _spec(family, cfg):
    return build_registry_spec(family, **cfg)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(ours, theirs, msg="", **tol):
    for layer in theirs:
        for k in theirs[layer]:
            np.testing.assert_allclose(
                np.asarray(ours[layer][k]), np.asarray(theirs[layer][k]),
                err_msg=f"{msg} {layer}/{k}", **tol)


def _cls_data(n=8, seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, CLS["vocab_size"], (n, S)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return ids, y


# -- specs and layouts ----------------------------------------------------------


@pytest.mark.parametrize("family,cfg", [
    ("transformer_classifier", CLS), ("transformer_lm", LM),
    ("transformer_moe_lm", MOE)], ids=["classifier", "lm", "moe"])
def test_param_pspecs_and_derivation_match_jax(family, cfg):
    spec = _spec(family, cfg)
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    # entry by entry: the same axes on the same dimensions
    ours, theirs = tm.param_pspecs(), jm.param_pspecs()
    assert list(ours) == list(theirs)
    for ln in theirs:
        assert list(ours[ln]) == list(theirs[ln])
        for k in theirs[ln]:
            assert tuple(ours[ln][k]) == tuple(theirs[ln][k]), (ln, k)
    for axes in ({"dp": 2, "tp": 2}, {"dp": 1, "fsdp": 2}, {"tp": 2},
                 {"dp": 2}):
        got = derive_param_pspecs(tm, Mesh(axes))
        want = jax_derive(jm, _jmesh(axes))
        if want is None:
            assert got is None
            continue
        for ln in want:
            for k in want[ln]:
                assert tuple(got[ln][k]) == tuple(want[ln][k]), (axes, ln, k)


def test_fsdp_pspecs_filter_and_rename_match_jax():
    spec = _spec("transformer_classifier", CLS)
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    for min_size in (2 ** 16, 32 * 64, 1):
        got = fsdp_pspecs(tm.param_specs(), min_size=min_size)
        want = jax_fsdp_pspecs(jm.param_specs(), min_size=min_size)
        for ln in want:
            for k in want[ln]:
                assert tuple(got[ln][k]) == tuple(want[ln][k]), (min_size, k)
    jmesh = _jmesh({"ep": 2})
    for s in (P(None, "tp"), P("tp", None), P(("dp", "ep"), None), P()):
        from jax.sharding import PartitionSpec as JP
        assert tuple(filter_pspec(s, Mesh({"ep": 2}))) == tuple(
            jax_filter(JP(*s), jmesh))
    got = rename_pspec_axes(tm.param_pspecs(), {"tp": "model"})
    want = jax_rename(jm.param_pspecs(), {"tp": "model"})
    assert tuple(got["block_0"]["qkv_kernel"]) == tuple(
        want["block_0"]["qkv_kernel"]) == (None, "model")


def test_derivation_refusals_match_jax():
    spec = _spec("transformer_classifier", CLS)
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    with pytest.raises(ValueError) as a:
        derive_param_pspecs(tm, Mesh({"dp": 1, "tp": 2, "fsdp": 2}))
    with pytest.raises(ValueError) as b:
        jax_derive(jm, _jmesh({"dp": 1, "tp": 2, "fsdp": 2}))
    assert str(a.value) == str(b.value)
    assert "cannot be auto-derived" in str(a.value)
    # the trainer's refusal of a tp mesh for a model without rules
    from sparkflow_tpu.graph_utils import build_graph as jax_graph
    import sparkflow_tpu.nn as jnn
    from sparkflow_tpu_torch import nn as tnn
    from sparkflow_tpu_torch.graph_utils import build_graph

    def graph(nn):
        x = nn.placeholder([None, 10], name="x")
        y = nn.placeholder([None, 3], name="y")
        out = nn.dense(nn.dense(x, 8, activation="relu"), 3, name="out")
        nn.softmax_cross_entropy(y, out)

    rs = np.random.RandomState(0)
    x = rs.randn(8, 10).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    with pytest.raises(ValueError) as a:
        Trainer(build_graph(lambda: graph(tnn)), "x:0", "y:0",
                mesh={"dp": 1, "tp": 2}, device="cpu").fit(x, y)
    with pytest.raises(ValueError) as b:
        JaxTrainer(jax_graph(lambda: graph(jnn)), "x:0", "y:0",
                   mesh=_jmesh({"dp": 1, "tp": 2})).fit(x, y)
    assert str(a.value) == str(b.value)
    assert "param_pspecs" in str(a.value)


@pytest.mark.parametrize("family,cfg", [
    ("transformer_lm", LM), ("transformer_moe_lm", MOE)],
    ids=["lm", "moe"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_pack_params_bit_equal_to_jax(family, cfg, tp):
    spec = _spec(family, cfg)
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    npp = numpy_params(jm.param_specs(), seed=3)
    want = jax_pack(jm, jax.tree.map(jnp.asarray, npp), tp)
    theirs = {ln: {k: torch.from_numpy(v) for k, v in d.items()}
              for ln, d in npp.items()}
    got = tp_pack_params(tm, theirs, tp)
    for ln in want:
        for k in want[ln]:
            np.testing.assert_array_equal(got[ln][k].numpy(),
                                          np.asarray(want[ln][k]),
                                          err_msg=f"{ln}/{k}")
    # training packs the columns only, and unpacks exactly
    cols = tp_pack_params(tm, theirs, tp, divide_biases=False)
    back = tp_unpack_params(tm, cols, tp)
    for ln in theirs:
        for k in theirs[ln]:
            assert torch.equal(back[ln][k], theirs[ln][k]), (ln, k)
    q8 = {"block_0": {"qkv_kernel": theirs["block_0"]["qkv_kernel"],
                      "o_kernel_q8": theirs["block_0"]["o_kernel"]}}
    if tp > 1:
        with pytest.raises(ValueError, match="int8"):
            tp_pack_params(tm, q8, tp)


def test_zero_stage_declines_on_sharded_params_as_jax():
    """A ZeRO stage asked for on a tp mesh is refused before any rank
    starts, with the JAX trainer's message (sharded params)."""
    from sparkflow_tpu.sharding import ShardingConfig as JaxConfig
    from sparkflow_tpu_torch.sharding import ShardingConfig
    spec = _spec("transformer_lm", LM)
    toks = np.random.default_rng(2).integers(0, 61, (8, S)).astype(
        np.float32)
    with pytest.raises(ValueError) as a:
        Trainer(spec, "input_ids", None, mesh={"dp": 2, "tp": 2},
                sharding=ShardingConfig(zero_stage=1), device="cpu").fit(toks)
    with pytest.raises(ValueError) as b:
        JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"dp": 2, "tp": 2}),
                   sharding=JaxConfig(zero_stage=1)).fit(toks)
    assert str(a.value) == str(b.value)
    assert "sharded-params=True" in str(a.value)


# -- the sharded step -------------------------------------------------------------


def test_dp2_tp2_sgd_step_matches_jax_sharded_step(pool4):
    """One SGD step on a {"dp": 2, "tp": 2} mesh against JAX's
    ``make_sharded_train_step`` with megatron-placed params on the same
    mesh of virtual devices (``tests/test_models.py``'s case)."""
    spec = _spec("transformer_classifier", CLS)
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=7, std=0.1)
    ids, y = _cls_data(8, seed=1)
    jmesh = _jmesh({"dp": 2, "tp": 2})
    from sparkflow_tpu.optimizers import build_optimizer as jax_opt
    opt = jax_opt("gradient_descent", 0.1, None)
    placed = jax_shard(jax.tree.map(jnp.asarray, p0), jmesh,
                       jm.param_pspecs())
    step = jax_step(jm, opt, jmesh, "input_ids", "y")
    jp, _, jloss = step(placed, opt.init(placed), jnp.asarray(ids),
                        jnp.asarray(y), jnp.ones((8,), jnp.float32),
                        jax.random.PRNGKey(1))
    out = pool4.run(tasks.sharded_step, spec, {"dp": 2, "tp": 2}, p0, ids, y)
    for r in out:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
        _close(r["params"], _np_tree(jp), "dp2 tp2", **STEP_TOL)
    full = sum(a.nbytes for d in p0.values() for a in d.values())
    assert out[0]["local_bytes"] < full


def test_megatron_gradients_of_replicated_leaves_match_jax(pool2):
    """The gradients of ln1 / ln2 and the embeddings are whole on every tp
    rank only with *f*'s all-reduce in the backward; one rank's part would
    still give the right loss."""
    spec = _spec("transformer_classifier", CLS)
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=8, std=0.1)
    ids, y = _cls_data(4, seed=2)
    mask = np.ones((4, S), np.float32)
    mask[1, 10:] = 0.0
    feeds = {"input_ids": ids, "attention_mask": mask, "y": y}

    def loss(p):
        return jm.loss_vector(p, {k: jnp.asarray(v) for k, v in
                                  feeds.items()}, train=False).mean()

    jl, jg = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, p0))
    out = pool2.run(tasks.tp_grads, spec, {"tp": 2}, p0, feeds)
    for r in out:
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-5)
        _close(r["grads"], _np_tree(jg), "grad", **GRAD_TOL)
        for name in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"):
            np.testing.assert_allclose(r["grads"]["block_0"][name],
                                       np.asarray(jg["block_0"][name]),
                                       **GRAD_TOL)
        np.testing.assert_allclose(r["grads"]["embed"]["tok"],
                                   np.asarray(jg["embed"]["tok"]), **GRAD_TOL)


# -- the trainer ---------------------------------------------------------------------


def _fit_kw(**over):
    kw = dict(optimizer="adam", learning_rate=0.01, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0,
              optimizer_options={"epsilon": 1e-4})
    kw.update(over)
    return kw


@pytest.mark.parametrize("options", [
    {"epsilon": 1e-4}, {"epsilon": 1e-4, "clip_norm": 0.05}],
    ids=["adam", "clip_norm"])
def test_trainer_tp_matches_jax_trainer_on_a_tp_mesh(pool2, options):
    """4 adam steps (2 epochs x 2 sweep batches) through ``Trainer(mesh=
    {"dp": 1, "tp": 2})`` against JAX's ``Trainer(mesh=...)``; with
    ``clip_norm`` the global norm counts the sharded leaves over tp and the
    replicated ones once (0.05 clips every step here)."""
    spec = _spec("transformer_lm", LM)
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=4, std=0.1)
    toks = np.random.default_rng(9).integers(0, 61, (8, S)).astype(
        np.float32)
    kw = _fit_kw(optimizer_options=options)
    jt = JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"dp": 1, "tp": 2}),
                    **kw)
    jr = jt.fit(toks, init_params=p0)
    out = pool2.run(tasks.tp_trainer_fit, spec, {"dp": 1, "tp": 2},
                    dict(kw, inputs=("input_ids", None)), toks, None, p0)
    for r in out:
        np.testing.assert_allclose(r["losses"], jr.losses, rtol=2e-4)
        _close(r["params"], _np_tree(jt.params), "adam", atol=1e-5, rtol=0)
        assert r["stats"]["zero_stage"] == 0
    if "clip_norm" not in options:
        # and the one-card fit of the port, for the record of what tp moves
        one = Trainer(spec, "input_ids", None, device="cpu", **kw).fit(
            toks, init_params=p0)
        np.testing.assert_allclose(out[0]["losses"], one.losses, rtol=2e-4)


def test_moe_lm_trains_on_a_tp_mesh(pool2):
    """The Switch-style MoE LM at tp=2: the attention sums over tp, the
    expert MLP is replicated (JAX's ``P("ep", ...)`` filters to replicated
    on a tp mesh) — 2 SGD steps against JAX's ``Trainer(mesh=...)``."""
    spec = _spec("transformer_moe_lm", MOE)
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=5, std=0.1)
    toks = np.random.default_rng(3).integers(0, 61, (8, S)).astype(
        np.float32)
    kw = _fit_kw(optimizer="gradient_descent", learning_rate=0.1,
                 optimizer_options=None, iters=1)
    jt = JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"dp": 1, "tp": 2}),
                    **kw)
    jr = jt.fit(toks, init_params=p0)
    out = pool2.run(tasks.tp_trainer_fit, spec, {"dp": 1, "tp": 2},
                    dict(kw, inputs=("input_ids", None)), toks, None, p0)
    for r in out:
        np.testing.assert_allclose(r["losses"], jr.losses, rtol=1e-5)
        _close(r["params"], _np_tree(jt.params), "moe", atol=1e-5, rtol=0)


def test_replicated_leaves_stay_bit_equal_across_tp_ranks_with_dropout(
        pool2):
    """Dropout follows the o and fc2 sums, on activations every tp rank
    holds whole: the ranks of one dp group draw the same masks, so after a
    fit every replicated leaf is bit-equal across them (and the fit
    differs from one without dropout)."""
    spec = _spec("transformer_lm", dict(LM, dropout=0.1))
    p0 = numpy_params(jax_model(spec).param_specs(), seed=6, std=0.1)
    toks = np.random.default_rng(4).integers(0, 61, (8, S)).astype(
        np.float32)
    kw = _fit_kw(shuffle_per_iter=True)
    out = pool2.run(tasks.tp_trainer_fit, spec, {"dp": 1, "tp": 2},
                    dict(kw, inputs=("input_ids", None)), toks, None, p0)
    a, b = out[0]["params"], out[1]["params"]
    for ln in a:
        for k in a[ln]:
            np.testing.assert_array_equal(a[ln][k], b[ln][k],
                                          err_msg=f"{ln}/{k}")
    assert out[0]["losses"] == out[1]["losses"]
    still = pool2.run(tasks.tp_trainer_fit, _spec("transformer_lm", LM),
                      {"dp": 1, "tp": 2},
                      dict(kw, inputs=("input_ids", None)), toks, None, p0)
    assert still[0]["losses"] != out[0]["losses"]


def test_a_tp_checkpoint_resumes_on_one_card_and_a_jax_one_on_tp(
        pool2, tmp_path, monkeypatch):
    """Checkpoints carry the standard layout: a tp=2 fit's directory
    resumes on one card bit for bit (the resumed fit trains nothing), and
    a JAX fit's params and optimizer state, written into a port checkpoint,
    carry on at tp=2 to JAX's own continued fit."""
    spec = _spec("transformer_lm", LM)
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=2, std=0.1)
    toks = np.random.default_rng(5).integers(0, 61, (8, S)).astype(
        np.float32)
    kw = _fit_kw(checkpoint_every=1)
    d1 = str(tmp_path / "tp")
    out = pool2.run(tasks.tp_trainer_fit, spec, {"dp": 1, "tp": 2},
                    dict(kw, checkpoint_dir=d1,
                         inputs=("input_ids", None)), toks, None, p0)
    one = Trainer(spec, "input_ids", None, device="cpu",
                  **dict(kw, checkpoint_dir=d1))
    r = one.fit(toks)
    assert one._resumed_from == 2 and r.losses == []
    for ln in r.params:
        for k in r.params[ln]:
            np.testing.assert_array_equal(r.params[ln][k].detach().numpy(),
                                          out[0]["params"][ln][k])
    # the tp fit's optimizer state went to disk in the standard layout too
    like = one._ckpt_state(one.params, one._last_opt_state, 0,
                           one._generators())
    saved = CheckpointManager(d1).restore(like=like)
    assert any(np.shape(a) == (32, 96) for a in
               jax.tree.leaves(saved["opt_state"]))

    # JAX: 2 epochs into its own directory (its npz format: orbax off),
    # then 2 more from there
    import sparkflow_tpu.checkpoint as jax_ckpt
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)
    d2 = str(tmp_path / "jax")
    JaxTrainer(spec, "input_ids", None, **dict(kw, checkpoint_dir=d2)).fit(
        toks, init_params=p0)
    jt = JaxTrainer(spec, "input_ids", None,
                    **dict(kw, iters=4, checkpoint_dir=d2))
    jr = jt.fit(toks)
    # the port at tp=2 from JAX's epoch-2 state: its params and optimizer
    # state in a port checkpoint (the random stream does not interchange)
    jstate = CheckpointManager(d2).restore(step=2, like=like)
    d3 = str(tmp_path / "port")
    CheckpointManager(d3).save(2, one._ckpt_state(
        jstate["params"], jstate["opt_state"], 2, one._generators()))
    cont = pool2.run(tasks.tp_trainer_fit, spec, {"dp": 1, "tp": 2},
                     dict(kw, iters=4, checkpoint_dir=d3,
                          inputs=("input_ids", None)), toks, None, p0)
    for r2 in cont:
        assert r2["resumed_from"] == 2
        np.testing.assert_allclose(r2["losses"][-2:], jr.losses[-2:],
                                   rtol=2e-4)
        _close(r2["params"], _np_tree(jt.params), "jax->tp", atol=1e-5,
               rtol=0)
