"""PyTorch port, training: the models' loss and gradients, the ``Trainer``
and its batching plan against the JAX package's, on the same numpy-drawn
weights and tokens, at a small width (2 layers, hidden 32, 4 heads) and
S=128, where the JAX models take their Pallas flash kernels (interpret
mode on the CPU, backward included).

Tolerances, float32 (the frameworks sum matmuls in different orders, a few
1e-7 relative per operation): one step's loss within 1e-5 relative and its
gradients within 1e-5 absolute plus 1e-4 relative; 4 Trainer steps' losses
within 1e-5 relative, parameters within 2e-4 with adam and 1e-5 with plain
SGD. The adam comparison sets epsilon 1e-6: the key third of every
``qkv_bias`` has an exactly-zero gradient (a constant added to all keys'
scores cancels in the softmax), so what each framework computes there is
round-off near 1e-10, and adam with epsilon 1e-8 normalises that noise into
steps of up to the learning rate with arbitrary signs. Dropout is 0 and
shuffling off in every comparison across the packages: ``jax.random`` and
``torch.Generator`` streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import numpy_params
from sparkflow_tpu.models.registry import (build_registry_spec as jax_spec,
                                           model_from_json as jax_model_from)
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.convert import params_from_jax, params_to_list
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.trainer import Trainer

S = 128
LM = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4, mlp_dim=64,
          max_len=S, dropout=0.0)
CLS = dict(LM, num_classes=3)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _tokens(seed, b, s=S):
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], (b, s)).astype(np.int32)


def _pad_mask(b, seed):
    rs = np.random.RandomState(seed)
    m = np.ones((b, S), np.float32)
    for i in range(b):
        m[i, rs.randint(S // 2, S):] = 0.0
    return m


def _pair(family, cfg, seed=1):
    spec = build_registry_spec(family, **cfg)
    assert spec == jax_spec(family, **cfg)
    jm = jax_model_from(spec)
    tm = model_from_json(spec, device="cpu")
    npp = numpy_params(jm.param_specs(), seed=seed, std=0.1)
    return jm, tm, npp


def _one_step(jm, tm, npp, feeds):
    jp = jax.tree.map(jnp.asarray, npp)
    jfeeds = {k: jnp.asarray(v) for k, v in feeds.items()}
    jl, jg = jax.value_and_grad(lambda p: jnp.mean(
        jm.loss_vector(p, jfeeds, train=True,
                       rng=jax.random.PRNGKey(0))))(jp)
    tp = tm.load_params(params_from_jax(tm, npp), trainable=True)
    tl = tm.loss_vector(tp, {k: torch.from_numpy(v) for k, v in
                             feeds.items()}, train=True).mean()
    leaves = [tp[ln][pn] for ln, ps in tm.param_specs().items() for pn in ps]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    want = [np.asarray(jg[ln][pn]) for ln, ps in tm.param_specs().items()
            for pn in ps]
    for w, g in zip(want, tg):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_gradients_match_jax(masked):
    jm, tm, npp = _pair("transformer_lm", LM)
    feeds = {"input_ids": _tokens(2, 3)}
    if masked:
        feeds["attention_mask"] = _pad_mask(3, 4)
    _one_step(jm, tm, npp, feeds)


@pytest.mark.parametrize("labels", ["index", "onehot"])
def test_classifier_loss_and_gradients_match_jax(labels):
    jm, tm, npp = _pair("transformer_classifier", CLS, seed=2)
    y = np.asarray([0, 2, 1], np.int32)
    feeds = {"input_ids": _tokens(5, 3), "attention_mask": _pad_mask(3, 6),
             "y": (y[:, None].astype(np.float32) if labels == "index"
                   else np.eye(3, dtype=np.float32)[y])}
    _one_step(jm, tm, npp, feeds)


def test_classifier_forward_matches_jax():
    jm, tm, npp = _pair("transformer_classifier", CLS, seed=3)
    feeds = {"input_ids": _tokens(7, 2), "attention_mask": _pad_mask(2, 8)}
    want = jm.apply(jax.tree.map(jnp.asarray, npp),
                    {k: jnp.asarray(v) for k, v in feeds.items()},
                    ["probs", "pred"])
    with torch.inference_mode():
        got = tm.apply(params_from_jax(tm, npp),
                       {k: torch.from_numpy(v) for k, v in feeds.items()},
                       ["probs", "pred"])
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(want["probs"]), atol=1e-5)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))


@pytest.mark.parametrize("optimizer,options,tol", [
    ("adam", {"learning_rate": 0.01, "epsilon": 1e-6}, 2e-4),
    ("gradient_descent", None, 1e-5)], ids=["adam", "sgd"])
def test_trainer_matches_jax_trainer(optimizer, options, tol):
    """4 steps (2 epochs x 2 sweep batches, no shuffle, dropout 0) from the
    same initial weights: the per-epoch losses and the final weights."""
    spec = build_registry_spec("transformer_lm", **LM)
    toks = _tokens(9, 8).astype(np.float32)       # ids as the estimator sends
    npp = numpy_params(jax_model_from(spec).param_specs(), seed=4, std=0.1)
    kw = dict(optimizer=optimizer, learning_rate=0.01, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0,
              optimizer_options=options)
    jt = JaxTrainer(spec, "input_ids", None, **kw)
    jr = jt.fit(toks, init_params=npp)
    tt = Trainer(spec, "input_ids", None, device="cpu", **kw)
    tr = tt.fit(toks, init_params=npp)
    assert tt._plan(8) == jt._plan(8) == ("sweep", 4, 2)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    from sparkflow_tpu.graphdef import params_to_list as jax_to_list
    for got, want in zip(tt.weights_list(), jax_to_list(jt.model, jt.params)):
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert tr.losses[-1] < tr.losses[0]


def test_classifier_trainer_matches_jax_trainer():
    """Multi-input features (ids + padding mask) and index labels: 4 SGD
    steps (2 epochs x 2 sweep batches) from the same initial weights."""
    spec = build_registry_spec("transformer_classifier", **CLS)
    feats = (_tokens(11, 8).astype(np.float32), _pad_mask(8, 12))
    labels = np.random.default_rng(13).integers(0, 3, 8).astype(np.float32)
    npp = numpy_params(jax_model_from(spec).param_specs(), seed=5, std=0.1)
    kw = dict(optimizer="gradient_descent", learning_rate=0.1, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0)
    names = ["input_ids", "attention_mask"]
    jt = JaxTrainer(spec, names, "y", **kw)
    jr = jt.fit(feats, labels, init_params=npp)
    tt = Trainer(spec, names, "y", device="cpu", **kw)
    tr = tt.fit(feats, labels, init_params=npp)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    from sparkflow_tpu.graphdef import params_to_list as jax_to_list
    for got, want in zip(tt.weights_list(), jax_to_list(jt.model, jt.params)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bs,stoch", [(4, -1), (3, -1), (10, -1), (0, -1),
                                      (None, -1), (4, 5), (12, 2), (8, 1)])
def test_plan_matches_jax(bs, stoch):
    spec = build_registry_spec("transformer_lm", **LM)
    kw = dict(mini_batch_size=bs, mini_stochastic_iters=stoch)
    jt = JaxTrainer(spec, "input_ids", None, **kw)
    tt = Trainer(spec, "input_ids", None, device="cpu", **kw)
    for n in (1, 7, 8, 10):
        assert tt._plan(n) == jt._plan(n)


def _small_fit(seed, **kw):
    spec = build_registry_spec("transformer_lm", **dict(LM, dropout=0.1,
                                                        max_len=32))
    toks = _tokens(3, 12, 32).astype(np.float32)
    args = dict(optimizer="adam", learning_rate=0.01, iters=2,
                mini_batch_size=4, seed=seed, device="cpu")
    args.update(kw)
    tr = Trainer(spec, "input_ids", None, **args)
    return tr.fit(toks), tr


@pytest.mark.parametrize("mode", [{}, {"mini_stochastic_iters": 3}])
def test_seeded_dropout_and_shuffles_repeat_within_the_port(mode):
    r1, t1 = _small_fit(5, **mode)
    r2, t2 = _small_fit(5, **mode)
    r3, _ = _small_fit(6, **mode)
    assert r1.losses == r2.losses and r1.losses != r3.losses
    for a, b in zip(t1.weights_list(), t2.weights_list()):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(r1.losses))


def test_remat_recomputes_the_same_dropout():
    """remat=True recomputes each block in the backward from the same
    dropout draws: the fit equals the one without remat."""
    r1, t1 = _small_fit(7)
    spec = build_registry_spec("transformer_lm", **dict(
        LM, dropout=0.1, max_len=32, remat=True))
    tr = Trainer(spec, "input_ids", None, optimizer="adam",
                 learning_rate=0.01, iters=2, mini_batch_size=4, seed=7,
                 device="cpu")
    r2 = tr.fit(_tokens(3, 12, 32).astype(np.float32))
    assert r1.losses == r2.losses
    for a, b in zip(t1.weights_list(), tr.weights_list()):
        np.testing.assert_array_equal(a, b)


def _remat_grads(remat, dropout, seed=5):
    """One training forward and backward of a 2-layer LM (hidden 32, S=32)
    with the given ``remat``, dropout drawn from a generator seeded
    ``seed``: the loss, the gradients and the generator's state after."""
    spec = build_registry_spec("transformer_lm", **dict(
        LM, max_len=32, dropout=dropout, remat=remat))
    tm = model_from_json(spec, device="cpu")
    tp = tm.load_params(params_from_jax(tm, numpy_params(
        tm.param_specs(), seed=6, std=0.1)), trainable=True)
    gen = torch.Generator().manual_seed(seed)
    loss = tm.loss_vector(tp, {"input_ids": torch.from_numpy(
        _tokens(4, 3, 32))}, train=True, generator=gen).mean()
    leaves = [tp[ln][pn] for ln, ps in tm.param_specs().items() for pn in ps]
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads], gen.get_state()


def test_remat_dots_matches_no_remat_with_dropout():
    """remat="dots" recomputes each block's dropout from the same
    generator state: loss and gradients equal remat=False's within 1e-5
    (they come out bit-equal on this CPU), and the generator ends where it
    would without remat."""
    loss, grads, state = _remat_grads(False, 0.1)
    dloss, dgrads, dstate = _remat_grads("dots", 0.1)
    np.testing.assert_allclose(dloss, loss, **LOSS_TOL)
    for g, w in zip(dgrads, grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert torch.equal(state, dstate)


@pytest.mark.parametrize("masked", [False, True])
def test_remat_dots_loss_and_gradients_match_jax(masked):
    """The same step through JAX's ``remat="dots"`` (its
    ``dots_with_no_batch_dims_saveable`` policy), dropout 0."""
    jm, tm, npp = _pair("transformer_lm", dict(LM, remat="dots"))
    assert tm.remat == jm.remat == "dots"
    feeds = {"input_ids": _tokens(2, 3)}
    if masked:
        feeds["attention_mask"] = _pad_mask(3, 4)
    _one_step(jm, tm, npp, feeds)


def test_remat_dots_keeps_the_products_and_recomputes_attention(monkeypatch):
    """Counted over one forward and backward: ``"dots"`` runs the
    attention forward twice a block, as ``"full"`` does, and every weight
    product once, as ``False`` does (FlopCounterMode: the products' and the
    plain attention's matmul FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode
    import sparkflow_tpu_torch.models.transformer as tmod
    calls = []
    inner = tmod.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(tmod, "flash_attention", counted)
    out = {}
    for remat in (False, "dots", "full"):
        calls.clear()
        counter = FlopCounterMode(display=False)
        with counter:
            _remat_grads(remat, 0.1)
        out[remat] = (len(calls), counter.get_total_flops())
    layers = LM["num_layers"]
    assert [out[r][0] for r in (False, "dots", "full")] == [
        layers, 2 * layers, 2 * layers]
    b, s, h, m = 3, 32, LM["hidden"], LM["mlp_dim"]
    attention_fwd = layers * 4 * b * s * s * h      # QK^T and PV, unmasked
    products_fwd = layers * 2 * b * s * (4 * h * h + 2 * h * m)
    assert out["dots"][1] - out[False][1] == attention_fwd
    assert out["full"][1] - out["dots"][1] == products_fwd


def test_trainer_predict_ema_and_weights():
    r, tr = _small_fit(1, optimizer_options={"learning_rate": 0.01,
                                             "ema_decay": 0.9})
    from sparkflow_tpu_torch.core import predict_in_chunks
    toks = _tokens(8, 5, 32).astype(np.float32)
    pred = predict_in_chunks(tr.predict_fn("pred"), tr.params, toks,
                             chunk_size=4)
    assert pred.shape == (5, 32) and np.isfinite(pred).all()
    ema = tr.ema_weights()
    assert set(ema) == set(tr.params)
    assert len(tr.weights_list()) == len(params_to_list(tr.model, tr.params))


def test_trainer_misuse_raises():
    spec = build_registry_spec("transformer_lm", **LM)
    # dp / sp / tp / fsdp / pp / ep meshes and explicit param_sharding
    # pytrees are ported (tests/test_torch_{zero,tp,fsdp,pp,ep,
    # param_sharding}.py); a pytree of another structure than the params is
    # refused at fit time naming the first leaf at fault, a pp mesh refuses
    # an sp axis with JAX's message before any rank starts, and a mesh must
    # be a Mesh or a dict of sizes
    Trainer(spec, "input_ids", None, mesh={"ep": 2}, device="cpu")
    with pytest.raises(ValueError, match="differs from the params at "
                                         "embed/tok"):
        Trainer(spec, "input_ids", None, mesh={"ep": 2}, device="cpu",
                param_sharding={"embed": {}}).fit(
                    _tokens(8, 4).astype(np.float32))
    with pytest.raises(ValueError, match="cannot combine 'pp' and 'sp'"):
        Trainer(spec, "input_ids", None, mesh={"pp": 2, "sp": 2},
                device="cpu").fit(_tokens(8, 4).astype(np.float32))
    with pytest.raises(TypeError, match="mesh must be"):
        Trainer(spec, "input_ids", None, mesh=object(), device="cpu")
    # debug_recompiles is no longer refused: a fit fills the report the
    # JAX trainer's fit gives on the same tokens (both on the per-epoch
    # loop, which a loss_callback selects)
    kw = dict(debug_recompiles=True, iters=1, mini_batch_size=4,
              loss_callback=lambda *a: None)
    toks = _tokens(8, 4).astype(np.float32)
    tr = Trainer(spec, "input_ids", None, device="cpu", **kw)
    tr.fit(toks)
    jax_tr = JaxTrainer(jax_spec("transformer_lm", **LM), "input_ids", None,
                        **kw)
    jax_tr.fit(toks)
    assert tr.recompile_report == jax_tr.recompile_report
    assert tr.recompile_report == "epoch: 1 trace(s)\n  #1: first trace"
    assert tr.recompile_findings == jax_tr.recompile_findings == []
    # strategy='elastic_dp' is ported; its options without it are refused
    with pytest.raises(ValueError, match="elastic_dp"):
        Trainer(spec, "input_ids", None, elastic={"replicas": 2},
                device="cpu")
    with pytest.raises(KeyError, match="known tensors"):
        Trainer(spec, "tokens", None, device="cpu")
    import sparkflow_tpu.nn as jnn
    from sparkflow_tpu.graph_utils import build_graph
    from sparkflow_tpu.graphdef import GraphDef

    def dnn():
        x = jnn.placeholder([None, 4], name="x")
        jnn.dense(x, 2, name="out")

    graph_json = build_graph(dnn)
    # a graph-DSL spec trains; an object of the JAX package is refused
    with pytest.raises(TypeError, match="sparkflow_tpu.graphdef.GraphDef"):
        Trainer(GraphDef.from_json(graph_json), "x:0", device="cpu")
    from sparkflow_tpu_torch.graphdef import GraphModel
    assert isinstance(Trainer(graph_json, "x:0", device="cpu").model,
                      GraphModel)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(spec, "input_ids", None)
