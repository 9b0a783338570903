"""PyTorch port, recurrent models: ``rnn_classifier`` (LSTM and GRU, one-
and two-way) and ``rnn_lm`` against the JAX package's on the same
numpy-drawn weights, with a ragged padding mask, in float32 and bfloat16;
the ``Trainer`` on ``rnn_lm``; the refusals.

Tolerances: float32 logits 1e-5, loss 1e-5 relative, gradients 1e-5
absolute plus 1e-4 relative (the same fused gate products, summed in a
different order). bfloat16 (operands rounded to bf16, float32 gate
results and state on both sides): logits within 2e-2 of max |logit|,
loss within 1e-2 relative, gradients within 2e-2 of each leaf's largest
entry — a layer's output is rounded to bf16 before the next layer reads
it, and one bf16 ulp of a last-bit float32 difference moves it by 2^-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import numpy_params
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.convert import params_from_jax, params_to_list
from sparkflow_tpu_torch.models import (RNNLM, RNNClassifier,
                                        build_registry_spec, model_from_json)
from sparkflow_tpu_torch.trainer import Trainer

S, B, VOCAB = 12, 3, 40
CLS = dict(vocab_size=VOCAB, num_classes=3, hidden=16, num_layers=2,
           max_len=S)
LM = dict(vocab_size=VOCAB, hidden=16, num_layers=2, max_len=S)
F32 = dict(logits=1e-5, loss=1e-5, grad=(1e-5, 1e-4))
BF16 = dict(logits=2e-2, loss=1e-2, grad=2e-2)


def _models(family, cfg, dtype):
    spec = build_registry_spec(family, **cfg)
    assert spec == jax_spec(family, **cfg)
    jm = jax_from_json(spec, compute_dtype=(jnp.bfloat16 if dtype == "bf16"
                                            else None))
    tm = model_from_json(spec, compute_dtype=("bfloat16" if dtype == "bf16"
                                              else None), device="cpu")
    assert list(tm.param_specs().items()) == list(jm.param_specs().items())
    return jm, tm, numpy_params(jm.param_specs(), seed=len(cfg), std=0.3)


def _feeds(seed, labels=True):
    rs = np.random.default_rng(seed)
    mask = np.ones((B, S), np.float32)
    mask[1, 7:] = 0.0                       # ragged: 12, 7 and 3 live steps
    mask[2, 3:] = 0.0
    feeds = {"input_ids": rs.integers(0, VOCAB, (B, S)).astype(np.int32),
             "attention_mask": mask}
    if labels:
        feeds["y"] = np.asarray([[0], [2], [1]], np.float32)
    return feeds


def _check(jm, tm, npp, feeds, out, tol):
    """Forward ``out``, the mean loss and its gradients, both packages."""
    jp = jax.tree.map(jnp.asarray, npp)
    jf = {k: jnp.asarray(v) for k, v in feeds.items()}
    want = np.asarray(jm.apply(jp, jf, [out])[out], np.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(jm.loss_vector(p, jf))))(jp)
    tf = {k: torch.from_numpy(v) for k, v in feeds.items()}
    tp = tm.load_params(params_from_jax(tm, npp), trainable=True)
    with torch.no_grad():
        got = tm.apply(tp, tf, [out])[out].float().numpy()
    tl = tm.loss_vector(tp, tf).mean()
    names = [(ln, pn) for ln, ps in tm.param_specs().items() for pn in ps]
    tg = torch.autograd.grad(tl, [tp[ln][pn] for ln, pn in names])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol["logits"] * max(scale, 1.0)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=tol["loss"])
    for (ln, pn), g in zip(names, tg):
        w = np.asarray(jg[ln][pn], np.float32)
        if isinstance(tol["grad"], tuple):
            atol, rtol = tol["grad"]
            np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol,
                                       err_msg=f"{ln}/{pn}")
        else:
            assert np.abs(g.numpy() - w).max() <= tol["grad"] * max(
                np.abs(w).max(), 1e-3), (ln, pn)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["one-way", "two-way"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_classifier_matches_jax(cell, bidirectional, dtype):
    jm, tm, npp = _models("rnn_classifier", dict(
        CLS, cell=cell, bidirectional=bidirectional), dtype)
    assert isinstance(tm, RNNClassifier)
    _check(jm, tm, npp, _feeds(1), "logits", F32 if dtype == "f32" else BF16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_lm_matches_jax(cell, dtype):
    jm, tm, npp = _models("rnn_lm", dict(LM, cell=cell), dtype)
    assert isinstance(tm, RNNLM)
    _check(jm, tm, npp, _feeds(2, labels=False), "logits",
           F32 if dtype == "f32" else BF16)


def test_masked_steps_carry_the_state():
    """A padded step leaves the state as it was: the final state of a
    sequence equals that of its live prefix alone."""
    _, tm, npp = _models("rnn_classifier", dict(CLS, cell="gru"), "f32")
    tp = params_from_jax(tm, npp)
    feeds = {k: torch.from_numpy(v) for k, v in _feeds(3).items()}
    with torch.inference_mode():
        full = tm.apply(tp, feeds, ["logits"])["logits"]
        short = tm.apply(tp, {"input_ids": feeds["input_ids"][2:, :3]},
                         ["logits"])["logits"]
    np.testing.assert_allclose(full[2].numpy(), short[0].numpy(), atol=1e-6)


def test_trainer_matches_jax_trainer():
    """4 adam steps of the LSTM LM (2 epochs x 2 sweep batches, no
    shuffle, dropout 0) from the same weights."""
    spec = build_registry_spec("rnn_lm", **dict(LM, cell="lstm"))
    toks = np.random.default_rng(9).integers(0, VOCAB, (8, S)).astype(
        np.float32)
    npp = numpy_params(jax_from_json(spec).param_specs(), seed=4, std=0.3)
    kw = dict(optimizer="adam", learning_rate=0.01, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0)
    jt = JaxTrainer(spec, "input_ids", None, **kw)
    jr = jt.fit(toks, init_params=npp)
    tt = Trainer(spec, "input_ids", None, device="cpu", **kw)
    tr = tt.fit(toks, init_params=npp)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    from sparkflow_tpu.graphdef import params_to_list as jax_to_list
    for got, want in zip(tt.weights_list(), jax_to_list(jt.model, jt.params)):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    assert tr.losses[-1] < tr.losses[0]
    assert len(params_to_list(tt.model, tt.params)) == 5


def test_seeded_dropout_repeats_within_the_port():
    spec = build_registry_spec("rnn_classifier", **dict(
        CLS, cell="lstm", bidirectional=True, dropout=0.3))
    tm = model_from_json(spec, device="cpu")
    tp = tm.init(seed=1)
    feeds = {k: torch.from_numpy(v) for k, v in _feeds(5).items()}

    def loss(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tm.loss_vector(tp, feeds, train=True, generator=g)

    assert torch.equal(loss(3), loss(3)) and not torch.equal(loss(3), loss(4))
    with torch.no_grad():
        assert torch.equal(tm.loss_vector(tp, feeds, train=False),
                           tm.loss_vector(tp, feeds, train=False))


def test_refusals_match_jax():
    with pytest.raises(ValueError, match="embed_dim must equal hidden"):
        model_from_json(build_registry_spec("rnn_lm", **dict(
            LM, embed_dim=8)), device="cpu")
    with pytest.raises(ValueError, match="cell must be 'lstm' or 'gru'"):
        model_from_json(build_registry_spec("rnn_classifier", **dict(
            CLS, cell="rnn")), device="cpu")
    # a classifier may embed narrower than its hidden state
    m = model_from_json(build_registry_spec("rnn_classifier", **dict(
        CLS, embed_dim=8)), device="cpu")
    assert m.param_specs()["layer_0"]["kernel"][0] == (8 + 16, 64)
