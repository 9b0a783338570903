"""PyTorch port, the last public names of the JAX package: the models'
``quantize_for_serving``, ``optimizers.OPTIMIZER_BUILDERS`` and
``ProximalAdagradState``, ``core.make_multi_epoch_fn`` and
``parallel.tp.make_sharded_train_step``, each against its JAX counterpart.

Weights and inputs are drawn with numpy and handed to both packages.
Tolerances: int8 trees bit-equal, refusal messages word for word;
``make_multi_epoch_fn`` bit-equal to ``n_epochs`` calls of the port's epoch
function, and within 2e-4 (losses) / 1e-5 (params) of JAX's
``make_multi_epoch_fn``, the bars of a 4-step ``Trainer`` comparison
(``tests/test_torch_train.py``); checkpoint leaves bit-equal; one sharded
SGD step's loss within 1e-5 relative and params within rtol 3e-4 / atol
3e-5 of JAX's GSPMD step (``tests/test_torch_tp.py``'s bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_tasks as tasks
from test_torch_shared import numpy_params
import sparkflow_tpu.nn as jnn
from sparkflow_tpu import checkpoint as jax_ckpt
from sparkflow_tpu import core as jcore
from sparkflow_tpu import optimizers as jopt
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.graphdef import GraphModel as JaxGraphModel
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.parallel.tp import (
    make_sharded_train_step as jax_sharded_step, shard_params as jax_shard)
import sparkflow_tpu_torch.nn as tnn
from sparkflow_tpu_torch import core as tcore
from sparkflow_tpu_torch import optimizers as topt
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.convert import sorted_leaves
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.graphdef import GraphModel
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.parallel import hyper


def _mlp(nn):
    x = nn.placeholder([None, 32], name="x")
    y = nn.placeholder([None, 4], name="y")
    h = nn.dense(x, 64, activation="relu")
    out = nn.dense(h, 4, name="out")
    nn.softmax_cross_entropy(y, out)


def _cnn(nn):
    x = nn.placeholder([None, 64], name="x")
    y = nn.placeholder([None, 3], name="y")
    xr = nn.reshape(x, [-1, 8, 8, 1])
    c = nn.conv2d(xr, 16, 3, activation="relu")
    out = nn.dense(nn.flatten(c), 3, name="out")
    nn.softmax_cross_entropy(y, out)


CLS = dict(vocab_size=64, num_classes=4, hidden=32, num_layers=2,
           num_heads=4, mlp_dim=64, max_len=16, dropout=0.0)


def _t(tree):
    return {ln: {pn: torch.from_numpy(np.array(a)) for pn, a in layer.items()}
            for ln, layer in tree.items()}


def _j(tree):
    return {ln: {pn: jnp.asarray(a) for pn, a in layer.items()}
            for ln, layer in tree.items()}


def _assert_trees_bit_equal(ours, theirs):
    want = jax.tree.leaves(theirs)
    got = [np.asarray(v) for _p, v in sorted_leaves(ours)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


# -- quantize_for_serving -----------------------------------------------------


@pytest.mark.parametrize("graph,mode,min_size", [
    (_mlp, "weight_only", 256), (_mlp, "dynamic", 256),
    (_cnn, "dynamic", 64)], ids=["mlp-weight_only", "mlp-dynamic", "cnn"])
def test_graph_model_quantize_for_serving_matches_jax(graph, mode, min_size):
    """``GraphModel.quantize_for_serving`` as ``tests/test_quant.py`` calls
    it: the int8 tree bit-equal to JAX's, the model set to serve it."""
    jm = JaxGraphModel.from_json(jax_build_graph(lambda: graph(jnn)))
    tm = GraphModel.from_json(build_graph(lambda: graph(tnn)), device="cpu")
    p0 = numpy_params(jm.param_specs(), seed=3)
    jq = jm.quantize_for_serving(_j(p0), mode=mode, min_size=min_size)
    tq = tm.quantize_for_serving(_t(p0), mode=mode, min_size=min_size)
    assert tm.quant_mode == jm.quant_mode == mode
    assert any(k.endswith("_q8") for layer in tq.values() for k in layer)
    _assert_trees_bit_equal(tq, jq)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_registry_model_quantize_for_serving_matches_jax(mode):
    spec = build_registry_spec("transformer_classifier", **CLS)
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    p0 = numpy_params(jm.param_specs(), seed=4, std=0.1)
    jq = jm.quantize_for_serving(_j(p0), mode=mode, min_size=1024)
    tq = tm.quantize_for_serving(_t(p0), mode=mode, min_size=1024)
    assert "qkv_kernel_q8" in tq["block_0"] and tm.quant_mode == mode
    _assert_trees_bit_equal(tq, jq)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_quantize_for_serving_refusals_match_jax():
    """A bad mode (``tests/test_quant.py:128``) and a family without int8
    serving (``:152``) are refused with JAX's words."""
    jg = JaxGraphModel.from_json(jax_build_graph(lambda: _mlp(jnn)))
    tg = GraphModel.from_json(build_graph(lambda: _mlp(tnn)), device="cpu")
    p0 = numpy_params(jg.param_specs())
    assert (_message(lambda: tg.quantize_for_serving(_t(p0), mode="int4"))
            == _message(lambda: jg.quantize_for_serving(_j(p0),
                                                        mode="int4")))
    spec = build_registry_spec("rnn_classifier", vocab_size=50,
                               num_classes=2, hidden=16, num_layers=1,
                               max_len=8)
    want = _message(lambda: jax_model(spec).quantize_for_serving(
        {}, mode="weight_only"))
    assert "int8 serving" in want
    assert _message(lambda: model_from_json(spec, device="cpu")
                    .quantize_for_serving({}, mode="weight_only")) == want


# -- optimizers -----------------------------------------------------------------


def test_optimizer_builders_keys_match_jax_and_hyper_uses_them():
    assert list(topt.OPTIMIZER_BUILDERS) == list(jopt.OPTIMIZER_BUILDERS)
    assert hyper.OPTIMIZER_BUILDERS is topt.OPTIMIZER_BUILDERS
    p = {"a": {"w": torch.ones(3)}}
    for name, ctor in topt.OPTIMIZER_BUILDERS.items():
        t = ctor(0.1)
        u, _ = t.update({"a": {"w": torch.full((3,), 0.5)}}, t.init(p), p)
        assert torch.isfinite(u["a"]["w"]).all(), name


def test_proximal_adagrad_state_and_checkpoint_interchange(monkeypatch,
                                                           tmp_path):
    """The state is ``ProximalAdagradState(accum)`` in both packages, and
    an npz checkpoint of it written by either package restores in the other
    bit for bit."""
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)
    rs = np.random.RandomState(0)
    w = {"dense": {"kernel": rs.randn(3, 4).astype(np.float32),
                   "bias": rs.randn(4).astype(np.float32)}}
    g = {"dense": {"kernel": rs.randn(3, 4).astype(np.float32),
                   "bias": rs.randn(4).astype(np.float32)}}
    opts = {"learning_rate": 0.1, "l1_regularization_strength": 0.01}
    jo = jopt.build_optimizer("proximal_adagrad", None, opts)
    to = topt.build_optimizer("proximal_adagrad", None, opts)
    _, js = jo.update(_j(g), jo.init(_j(w)), _j(w))
    _, ts = to.update(_t(g), to.init(_t(w)), _t(w))
    assert type(ts) is topt.ProximalAdagradState
    assert ts._fields == js._fields == ("accum",)
    _assert_trees_bit_equal(ts, js)

    CheckpointManager(str(tmp_path / "t")).save(1, {"opt_state": ts})
    back = jax_ckpt.CheckpointManager(str(tmp_path / "t")).restore(
        like={"opt_state": jax.tree.map(np.asarray, js)})
    _assert_trees_bit_equal(ts, back["opt_state"])
    jax_ckpt.CheckpointManager(str(tmp_path / "j")).save(
        1, {"opt_state": js})
    back = CheckpointManager(str(tmp_path / "j")).restore(
        like={"opt_state": ts})
    assert type(back["opt_state"]) is topt.ProximalAdagradState
    _assert_trees_bit_equal(back["opt_state"], js)


# -- make_multi_epoch_fn --------------------------------------------------------


def _epoch_setup(seed=5, n=40, batch=8):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 32).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]
    x_pad, mask = tcore.pad_to_batches(x, batch)
    y_pad, _ = tcore.pad_to_batches(y, batch)
    return x_pad, y_pad, mask


def _port_epochs(p0, multi, mode, shuffle, n_epochs=3, batch=8):
    model = GraphModel.from_json(build_graph(lambda: _mlp(tnn)),
                                 device="cpu")
    x, y, mask = (torch.from_numpy(a) for a in _epoch_setup(batch=batch))
    nb = x.shape[0] // batch
    loss_fn = tcore.make_loss_fn(model, "x:0", "y:0")
    opt = topt.build_optimizer("adam", 0.01, None)
    params = {ln: {pn: t.requires_grad_(True) for pn, t in layer.items()}
              for ln, layer in _t(p0).items()}
    state = opt.init(params)
    gens = (torch.Generator().manual_seed(11), torch.Generator())
    if multi:
        run = tcore.make_multi_epoch_fn(loss_fn, opt, batch, nb, mode,
                                        shuffle, n_epochs, n_real=40)
        params, state, losses = run(params, state, x, y, mask, gens)
    else:
        epoch = tcore.make_epoch_fn(loss_fn, opt, batch, nb, mode, shuffle,
                                    n_real=40)
        out = []
        for _ in range(n_epochs):
            params, state, loss = epoch(params, state, x, y, mask, *gens)
            out.append(loss)
        losses = torch.stack(out)
    return losses.detach().numpy(), {
        ln: {pn: t.detach().numpy() for pn, t in layer.items()}
        for ln, layer in params.items()}


@pytest.mark.parametrize("mode,shuffle", [
    ("sweep", True), ("stochastic", False), ("full", False)])
def test_multi_epoch_fn_equals_the_per_epoch_loop_bit_for_bit(mode, shuffle):
    p0 = numpy_params(JaxGraphModel.from_json(jax_build_graph(
        lambda: _mlp(jnn))).param_specs(), seed=6, std=0.2)
    batch = 48 if mode == "full" else 8
    la, pa = _port_epochs(p0, True, mode, shuffle, batch=batch)
    lb, pb = _port_epochs(p0, False, mode, shuffle, batch=batch)
    assert la.shape == (3, 1 if mode == "full" else 5)
    assert np.array_equal(la, lb)
    for ln in pa:
        for pn in pa[ln]:
            assert np.array_equal(pa[ln][pn], pb[ln][pn]), (ln, pn)


def test_multi_epoch_fn_matches_jax():
    """An unshuffled sweep draws nothing, so both packages take the same
    steps: losses within 2e-4, params within 1e-5."""
    jm = JaxGraphModel.from_json(jax_build_graph(lambda: _mlp(jnn)))
    p0 = numpy_params(jm.param_specs(), seed=6, std=0.2)
    x, y, mask = _epoch_setup()
    jopt_ = jopt.build_optimizer("adam", 0.01, None)
    run = jcore.make_multi_epoch_fn(jcore.make_loss_fn(jm, "x:0", "y:0"),
                                    jopt_, 8, 5, "sweep", False, 3,
                                    n_real=40)
    jp = _j(p0)
    jp, _, jl = run(jp, jopt_.init(jp), jnp.asarray(x), jnp.asarray(y),
                    jnp.asarray(mask), jax.random.split(jax.random.PRNGKey(0),
                                                        3))
    tl, tp = _port_epochs(p0, True, "sweep", False)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=2e-4, rtol=0)
    for ln in tp:
        for pn in tp[ln]:
            np.testing.assert_allclose(tp[ln][pn], np.asarray(jp[ln][pn]),
                                       atol=1e-5, rtol=0,
                                       err_msg=f"{ln}/{pn}")


# -- make_sharded_train_step ----------------------------------------------------


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.mark.parametrize("axes", [{"dp": 1, "tp": 2}, {"dp": 2}],
                         ids=["tp2", "dp2"])
def test_make_sharded_train_step_matches_jax(pool2, axes):
    """One SGD step of ``parallel.tp.make_sharded_train_step`` on two
    ranks against JAX's GSPMD step on the same mesh of virtual devices,
    with the model's own placement."""
    spec = build_registry_spec("transformer_classifier", **dict(
        CLS, num_classes=3))
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=7, std=0.1)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 64, (8, 16)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    jmesh = jax_make_mesh(axes, devices=jax.devices()[:2])
    opt = jopt.build_optimizer("gradient_descent", 0.1, None)
    placed = _j(p0)
    if "tp" in axes:
        placed = jax_shard(placed, jmesh, jm.param_pspecs())
    step = jax_sharded_step(jm, opt, jmesh, "input_ids", "y")
    jp, _, jloss = step(placed, opt.init(placed), jnp.asarray(ids),
                        jnp.asarray(y), jnp.ones((8,), jnp.float32),
                        jax.random.PRNGKey(1))
    out = pool2.run(tasks.public_sharded_step, spec, axes, p0, ids, y)
    for r in out:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
        for ln in p0:
            for pn in p0[ln]:
                np.testing.assert_allclose(
                    r["params"][ln][pn], np.asarray(jp[ln][pn]), rtol=3e-4,
                    atol=3e-5, err_msg=f"{axes} {ln}/{pn}")
