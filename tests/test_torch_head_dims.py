"""PyTorch port at every head_dim (below 8, not a multiple of 8, above 256)
and at verify row counts above 16: the plain versions of the seven kernels
against the JAX package where the JAX package runs them (its Pallas
kernels in interpret mode at head_dim 264 and 512, its plain attention at
12 and 25, where it sends those widths), the wrapper's zero-padding of the
flash operands, a transformer_lm with heads of 25 and of 512 (prefill and
decode logits, the ``DecodeEngine``'s greedy tokens over a plain and an
int8 pool and with ``spec_k`` 16 and 20, one step's loss and gradients),
and a transformer_classifier at TinyBERT-4L-312D's widths (12 heads of 26;
logits, one training step, the estimator).

Inputs and weights are drawn with numpy from fixed seeds and handed to both
packages; dropout is off. On the CPU the port's wrappers run their plain
versions (the kernels, ``csrc/flash_sliced.cu``, ``csrc/paged_sliced.cu``
and the padded launches, run on the card: tests/test_torch_cuda.py).

Tolerances, float32 (both sides compute in float32 from the same values;
only the order of the sums differs): the plain versions against JAX 2e-5
absolute and relative (as tests/test_torch_wide_heads.py); the padded
plain versions against the unpadded ones 1e-6 (a zero column adds exact
zeros; only the einsum's blocking may differ); logits 1e-4 (as
tests/test_torch_models.py); one step's loss 1e-5 relative and gradients
1e-5 absolute (as tests/test_torch_wide_heads_train.py); greedy tokens
identical; estimator predictions across packages 1e-5 (as
tests/test_torch_estimator.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import numpy_params, to_torch
from test_torch_wide_heads import _greedy, _pool_case, _scales
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.ops import (attention_reference,
                                     flash_attention_backward_reference,
                                     flash_bwd_dkv, flash_bwd_dq,
                                     paged_attention_reference,
                                     paged_attention_verify_reference)
from sparkflow_tpu_torch.ops.attention import (_flash_head, _pad_head,
                                               _trim_head, _vector_head)
from sparkflow_tpu_torch.serving import DecodeEngine
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

TOL = dict(atol=2e-5, rtol=2e-5)
PAD_TOL = dict(atol=1e-6, rtol=1e-6)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=1e-5, rtol=0)
PAGE = 16
S = 128


def _qkv(seed, d, b=2, h=2, s=S, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype(np.float32) for _ in range(n)]


def _mask(s=S):
    m = np.ones((2, s), np.float32)
    m[0, s - 45:] = 0.0
    m[1] = 0.0
    return m


# -- the flash kernels' plain versions ----------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["causal", "masked"])
@pytest.mark.parametrize("d", [264, 512])
def test_flash_plain_matches_jax_pallas_above_256(d, masked):
    """O, the logsumexp, dQ, dK and dV against the Pallas forward and
    backward (interpret mode): causal, or over padded keys with one batch
    row all padding (its output the uniform average, zero gradient)."""
    q, k, v, g = _qkv(d + masked, d, n=4)
    mask = _mask() if masked else None
    causal = not masked
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = jattn._flash_pallas_forward(jq, jk, jv, jm, causal, scale, S,
                                           S, True, with_lse=True)
    want = jattn._flash_pallas_backward(jq, jk, jv, jm, out, lse, jg, causal,
                                        scale, S, S, True)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tm = None if mask is None else torch.from_numpy(mask)
    got_o, got_lse = attention_reference(tq, tk, tv, causal, kv_mask=tm,
                                         return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), **TOL)
    tout, tlse = (torch.from_numpy(np.array(a)) for a in (out, lse))
    delta = (tg * tout).sum(-1).contiguous()
    dq = flash_bwd_dq(tq, tk, tv, tg, tlse, delta, causal, kv_mask=tm)
    dk, dv = flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, causal, kv_mask=tm)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "masked"])
@pytest.mark.parametrize("d", [12, 25])
def test_flash_plain_matches_jax_reference_at_narrow_heads(d, masked):
    """JAX sends a head_dim that is not a multiple of 8 to its plain
    attention: O and jax.grad of it against the port's forward and
    backward plain versions (the backward from the forward's logsumexp)."""
    q, k, v, g = _qkv(d + masked, d, n=4)
    mask = _mask() if masked else None
    causal = not masked
    jm = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jnp.sum(jattn.attention_reference(q_, k_, v_, causal,
                                                 kv_mask=jm) * jnp.asarray(g))

    want_o = jattn.attention_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                       causal, kv_mask=jm)
    want_g = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = attention_reference(tq, tk, tv, causal, kv_mask=tm,
                                   return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), **TOL)
    got = flash_attention_backward_reference(tq, tk, tv, out, lse, tg, causal,
                                             kv_mask=tm)
    rows = slice(None) if mask is None else slice(0, 1)
    # JAX's plain attention averages an all-padding row uniformly and
    # differentiates that average; the kernels' recurrence gives such a row
    # zero gradient (as JAX's own Pallas backward does): compare the rows
    # with a live key
    for name, a, w in zip(("dq", "dk", "dv"), got, want_g):
        np.testing.assert_allclose(a.numpy()[rows], np.asarray(w)[rows],
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("d", [1, 5, 12, 25, 26, 63, 250])
def test_padded_operands_give_the_unpadded_plain_version(d):
    """The wrapper's staging, run on CPU tensors: q/k/v (and dO) zero-padded
    to ``_flash_head(d)``, the plain forward and backward at the padded
    width with the true width's scale, trimmed, equal the plain versions at
    width d."""
    dp = _flash_head(d)
    assert dp % 8 == 0 and d <= dp < d + 8 and _vector_head(dp)
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(d, d, s=70, n=4))
    mask = torch.ones(2, 70)
    mask[1, 40:] = 0
    scale = 1.0 / math.sqrt(d)
    pq, pk, pv, pg = (_pad_head(t, dp) for t in (q, k, v, g))
    assert pq.shape[-1] == dp and pq.is_contiguous()
    assert torch.equal(pq[..., :d], q) and not pq[..., d:].any()
    for causal, m in ((True, None), (False, mask)):
        out, lse = attention_reference(q, k, v, causal, scale, kv_mask=m,
                                       return_lse=True)
        pout, plse = attention_reference(pq, pk, pv, causal, scale,
                                         kv_mask=m, return_lse=True)
        np.testing.assert_allclose(_trim_head(pout, d).numpy(), out.numpy(),
                                   **PAD_TOL)
        assert not pout[..., d:].any()
        np.testing.assert_allclose(plse.numpy(), lse.numpy(), **PAD_TOL)
        want = flash_attention_backward_reference(q, k, v, out, lse, g,
                                                  causal, scale, kv_mask=m)
        got = flash_attention_backward_reference(pq, pk, pv, pout, plse, pg,
                                                 causal, scale, kv_mask=m)
        for a, w in zip(got, want):
            np.testing.assert_allclose(_trim_head(a, d).numpy(), w.numpy(),
                                       **PAD_TOL)


def test_flash_head_routing():
    """Which head_dims run where: the tensor cores take a multiple of 8 up
    to 256 as it is, below 256 the rest is padded up to a multiple of 8,
    above 256 every head_dim runs the column-sliced kernels as it is."""
    assert [_flash_head(d) for d in (1, 7, 8, 9, 26, 64, 250, 256)] == [
        8, 8, 8, 16, 32, 64, 256, 256]
    assert [_flash_head(d) for d in (257, 264, 265, 512, 4096)] == [
        257, 264, 265, 512, 4096]
    assert [_vector_head(d) for d in (4, 25, 64, 256, 264)] == [
        False, False, True, True, False]


# -- the decode and verify kernels' plain versions ----------------------------

@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["plain", "int8", "fp8"])
@pytest.mark.parametrize("d", [12, 25, 264, 512])
def test_paged_decode_plain_matches_jax(d, kind):
    rs, jk, jv, jks, jvs, table = _pool_case(d, d, kind)
    table[0] = 0
    lengths = np.array([0, 1, 37, 6 * PAGE], np.int32)
    q = rs.randn(4, 2, d).astype(np.float32)
    jsc, tsc = _scales(jks, jvs)
    want = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths),
        interpret=True, **jsc))
    got = paged_attention_reference(
        torch.from_numpy(q), to_torch(jk), to_torch(jv),
        torch.from_numpy(table), torch.from_numpy(lengths), **tsc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert bool((got[0] == 0).all()) and np.all(want[0] == 0.0)


@pytest.mark.parametrize("kind", [None, "int8"], ids=["plain", "int8"])
@pytest.mark.parametrize("s", [5, 17, 33])
@pytest.mark.parametrize("d", [25, 264])
def test_paged_verify_plain_matches_jax(d, s, kind):
    rs, jk, jv, jks, jvs, table = _pool_case(d + s, d, kind)
    start = np.array([0, PAGE - 2, 2 * PAGE + 3, 6 * PAGE - s], np.int32)
    q = rs.randn(4, 2, s, d).astype(np.float32)
    jsc, tsc = _scales(jks, jvs)
    want = np.asarray(jattn.paged_attention_verify(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(start),
        interpret=True, **jsc))
    got = paged_attention_verify_reference(
        torch.from_numpy(q), to_torch(jk), to_torch(jv),
        torch.from_numpy(table), torch.from_numpy(start), **tsc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- the slice: transformer_lm with heads of 25 and of 512 --------------------

LMS = {25: dict(vocab_size=97, hidden=100, num_layers=1, num_heads=4,
                mlp_dim=128, max_len=64, dropout=0.0),
       512: dict(vocab_size=97, hidden=1024, num_layers=1, num_heads=2,
                 mlp_dim=256, max_len=64, dropout=0.0)}
PROMPTS = [[5, 2, 8], list(range(1, 40)), [33], [30, 7, 91, 9, 12] * 4]
NEW = 6


@pytest.fixture(scope="module", params=sorted(LMS), ids=lambda d: f"d{d}")
def lm(request):
    cfg = LMS[request.param]
    spec = build_registry_spec("transformer_lm", **cfg)
    assert spec == jax_spec("transformer_lm", **cfg)
    jm = jax_from_json(spec)
    npp = numpy_params(jm.param_specs(), seed=request.param, std=0.08)
    tm = model_from_json(spec, device="cpu")
    assert tm.head_dim == request.param
    return (request.param, jm, jax.tree.map(jnp.asarray, npp), tm,
            params_from_jax(tm, npp), npp, {})


def test_lm_prefill_and_decode_logits_match_jax(lm):
    _, jm, jp, tm, tp, _, _ = lm
    ids = np.random.default_rng(3).integers(0, 97, (2, 40)).astype(np.int32)
    lengths = np.asarray([40, 23], np.int32)
    jl, _ = jm.prefill(jp, jnp.asarray(ids), lengths=jnp.asarray(lengths))
    with torch.inference_mode():
        tl, _ = tm.prefill(tp, torch.from_numpy(ids),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jc = jm.init_decode_cache(2, max_len=16)
    tc = tm.init_decode_cache(2, max_len=16)
    with torch.inference_mode():
        for pos, t in enumerate([3, 9, 4, 1, 7]):
            tok = np.asarray([t, (t * 7) % 97], np.int32)
            p = np.asarray([pos, pos], np.int32)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(p))
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                    torch.from_numpy(p))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)


# each arm's engine options, and the pool of the JAX engine whose greedy
# tokens it must give: greedy speculation gives the tokens of greedy
# decoding without it (JAX's engine holds that: tests/test_decode.py
# test_spec_greedy_parity_self_draft),
# so the spec arms are held to JAX's plain engine, built once a pool
ARMS = {"plain": ({}, "plain"), "int8": ({"kv_quant": "int8"}, "int8"),
        "spec16": ({"spec_k": 16}, "plain"),
        "spec20": ({"spec_k": 20}, "plain")}
JAX_POOLS = {"plain": {}, "int8": {"kv_quant": "int8"}}


@pytest.mark.parametrize("arm", list(ARMS))
def test_lm_engine_greedy_tokens_identical_to_jax(lm, arm):
    """spec_k 16 and 20 verify 17 and 21 rows a slot (two row groups of the
    card's kernel); the one-layer model drafts through itself."""
    _, jm, jp, tm, tp, _, jax_tokens = lm
    extra, pool = ARMS[arm]
    kw = dict(num_slots=2, page_size=PAGE, seed=0)
    if pool not in jax_tokens:
        jax_tokens[pool] = _greedy(JaxDecodeEngine(
            jm, jp, **kw, **JAX_POOLS[pool]), PROMPTS, NEW)
    want = jax_tokens[pool]
    eng = DecodeEngine(tm, tp, **kw, **extra)
    got = _greedy(eng, PROMPTS, NEW)
    assert got == want
    assert len({tuple(t) for t in got}) > 2, "weights decode to one token"
    if arm.startswith("spec"):
        assert eng.stats()["spec"]["steps"] > 0


def test_lm_loss_and_gradients_match_jax(lm):
    """The JAX side takes its plain attention at both widths (a sequence of
    64 does not tile its Pallas kernels; those are held at 512 above); the
    port's attention runs the plain versions of kernels 1-3 through its
    autograd Function."""
    d, jm, _, tm, _, npp, _ = lm
    ids = np.random.default_rng(d).integers(0, 97, (2, 64)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jnp.mean(jm.loss_vector(
        p, {"input_ids": jnp.asarray(ids)}, train=True,
        rng=jax.random.PRNGKey(0))))(jax.tree.map(jnp.asarray, npp))
    tp = tm.load_params(params_from_jax(tm, npp), trainable=True)
    tl = tm.loss_vector(tp, {"input_ids": torch.from_numpy(ids)},
                        train=True).mean()
    names = [(ln, pn) for ln, ps in tm.param_specs().items() for pn in ps]
    tg = torch.autograd.grad(tl, [tp[ln][pn] for ln, pn in names])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    for (ln, pn), got in zip(names, tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg[ln][pn]),
                                   err_msg=f"{ln}/{pn}", **GRAD_TOL)


# -- TinyBERT-4L-312D's widths: 12 heads of 26 --------------------------------

TINYBERT_1L = dict(vocab_size=1000, num_classes=2, hidden=312, num_layers=1,
                   num_heads=12, mlp_dim=1200, max_len=64, dropout=0.0)


def _cls_feeds(seed, b=4, s=64):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 1000, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    for i, n in enumerate((64, 40, 17, 64)[:b]):
        mask[i, n:] = 0.0
        ids[i, n:] = 0
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, b)]
    return {"input_ids": ids, "attention_mask": mask, "y": y}


def test_tinybert_width_classifier_logits_and_step_match_jax():
    """A one-layer transformer_classifier at TinyBERT-4L-312D's widths:
    the logits of ragged padded rows, and one step's loss and gradients."""
    spec = build_registry_spec("transformer_classifier", **TINYBERT_1L)
    assert spec == jax_spec("transformer_classifier", **TINYBERT_1L)
    jm = jax_from_json(spec)
    tm = model_from_json(spec, device="cpu")
    assert tm.head_dim == 26
    npp = numpy_params(jm.param_specs(), seed=26, std=0.08)
    feeds = _cls_feeds(4)
    jp = jax.tree.map(jnp.asarray, npp)
    jf = {n: jnp.asarray(a) for n, a in feeds.items()}
    tf = {n: torch.from_numpy(a) for n, a in feeds.items()}
    want = np.asarray(jm.apply(jp, jf, ["logits"])["logits"])
    with torch.inference_mode():
        got = tm.apply(params_from_jax(tm, npp), tf, ["logits"])["logits"]
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    jl, jg = jax.value_and_grad(lambda p: jnp.mean(jm.loss_vector(
        p, jf, train=True, rng=jax.random.PRNGKey(0))))(jp)
    tp = tm.load_params(params_from_jax(tm, npp), trainable=True)
    tl = tm.loss_vector(tp, tf, train=True).mean()
    names = [(ln, pn) for ln, ps in tm.param_specs().items() for pn in ps]
    tg = torch.autograd.grad(tl, [tp[ln][pn] for ln, pn in names])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    for (ln, pn), g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[ln][pn]),
                                   err_msg=f"{ln}/{pn}", **GRAD_TOL)


def test_tinybert_width_estimator_fit_transforms_in_jax(tmp_path):
    """``SparkAsyncDL`` fits the one-layer TinyBERT-width classifier (one
    step) in the port; the JAX package's ``SparkAsyncDLModel`` transforms
    with the port-fitted weights to the port's predictions."""
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal
    from sparkflow_tpu.tensorflow_async import SparkAsyncDLModel as JaxModel
    from test_torch_estimator import _model_kw, _predictions, _text_df
    cfg = dict(TINYBERT_1L, max_len=32)
    spec = build_registry_spec("transformer_classifier", **cfg)
    df = _text_df(tlocal)
    est = SparkAsyncDL(inputCol="tokens", tensorflowGraph=spec,
                       tfInput="input_ids:0", tfLabel="y:0",
                       tfOutput="probs:0", tfLearningRate=3e-3, iters=1,
                       miniBatchSize=16, labelCol="labels",
                       predictionCol="probs", extraInputCols="mask",
                       extraTfInputs="attention_mask:0", device="cpu",
                       weightsPath=str(tmp_path / "cls"))
    fitted = tlocal.Pipeline(stages=[
        tlocal.OneHotEncoder(inputCol="label", outputCol="labels",
                             dropLast=False), est]).fit(df)
    ours = fitted.stages[-1]
    got = _predictions(ours.transform(df), "probs")
    assert got.shape == (16, 2) and np.isfinite(got).all()
    theirs = JaxModel(**_model_kw(ours))
    np.testing.assert_allclose(got, _predictions(
        theirs.transform(_text_df(jlocal)), "probs"), atol=1e-5, rtol=0)
