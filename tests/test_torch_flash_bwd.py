"""PyTorch port, flash attention backward: the port's plain backward and
autograd through its CPU ``flash_attention`` (the same
``torch.autograd.Function`` the card runs, with the plain versions of the
dq and dk/dv kernels) against the JAX package's Pallas backward kernels in
interpret mode and ``jax.grad`` of its public ``flash_attention``.

Inputs and a non-uniform cotangent are drawn with numpy from fixed seeds
and handed to both packages. Tolerance 2e-5 in float32: both sides
recompute P from the same logsumexp in float32; only the summation order
differs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                     flash_attention_backward,
                                     flash_attention_backward_reference,
                                     flash_bwd_dkv, flash_bwd_dq)

TOL = dict(atol=2e-5, rtol=2e-5)
B, H, D = 2, 3, 16


def _inputs(seed, s, b=B):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, H, s, D).astype(np.float32) for _ in range(3))
    # a non-uniform cotangent, so every row and column carries weight
    g = (rs.randn(b, H, s, D) * np.linspace(0.5, 2.0, s)[:, None]
         ).astype(np.float32)
    return q, k, v, g


def _ragged_mask(b, s, seed):
    rs = np.random.RandomState(seed)
    m = np.ones((b, s), np.float32)
    for i in range(b):
        m[i, rs.randint(s // 2, s):] = 0.0   # a padded tail per row
    return m


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad)
                 for a in arrays)


def _jax_pallas_grads(q, k, v, g, mask, causal):
    s = q.shape[2]
    blk = min(s, 128)
    scale = 1.0 / math.sqrt(D)
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = jattn._flash_pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal, scale,
        blk, blk, True, with_lse=True)
    grads = jattn._flash_pallas_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, out, lse,
        jnp.asarray(g), causal, scale, blk, blk, True)
    return np.asarray(out), np.asarray(lse), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("s", [16, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_pallas(s, causal, masked):
    q, k, v, g = _inputs(s + 7 * causal + 3 * masked, s)
    mask = _ragged_mask(B, s, s) if masked else None
    out, lse, want = _jax_pallas_grads(q, k, v, g, mask, causal)
    tm = None if mask is None else torch.from_numpy(mask)
    # the plain backward on the JAX forward's own O and logsumexp
    got = flash_attention_backward_reference(
        *_t(q, k, v, out, lse, g), causal=causal, kv_mask=tm)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, **TOL)
    # autograd through the port's flash_attention (the same Function as on
    # the card) against jax.grad of the JAX package's public entry point
    tq, tk, tv = _t(q, k, v, grad=True)
    (flash_attention(tq, tk, tv, causal=causal, kv_mask=tm)
     * torch.from_numpy(g)).sum().backward()

    def jloss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, causal=causal, interpret=True,
                                  kv_mask=None if mask is None
                                  else jnp.asarray(mask))
        return jnp.sum(o * jnp.asarray(g))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    for a, w in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_all_padded_row_gets_zero_gradient_as_in_jax():
    """A batch row whose keys are all padding: the forward averages its
    values uniformly, the backward (JAX's and the port's) gives it zero
    gradient — unlike autodiff of the plain attention."""
    s = 128
    q, k, v, g = _inputs(11, s)
    mask = np.ones((B, s), np.float32)
    mask[1] = 0.0
    mask[0, 90:] = 0.0
    _, _, want = _jax_pallas_grads(q, k, v, g, mask, causal=False)
    tq, tk, tv = _t(q, k, v, grad=True)
    (flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask))
     * torch.from_numpy(g)).sum().backward()
    for a, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), w, **TOL)
        assert np.all(a.numpy()[1] == 0.0) and np.all(w[1] == 0.0)
    # keys past the padding boundary of row 0 get no gradient either
    assert np.all(tk.grad.numpy()[0, :, 90:] == 0.0)


@pytest.mark.parametrize("masked", [False, True])
def test_ragged_s100_matches_jax_grad_of_reference(masked):
    s = 100
    q, k, v, g = _inputs(5 + masked, s)
    mask = _ragged_mask(B, s, 3) if masked else None
    tq, tk, tv = _t(q, k, v, grad=True)
    (flash_attention(tq, tk, tv, causal=True,
                     kv_mask=None if mask is None else torch.from_numpy(mask))
     * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(jattn.attention_reference(
        q_, k_, v_, causal=True,
        kv_mask=None if mask is None else jnp.asarray(mask))
        * jnp.asarray(g)), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, w in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_kernel_wrappers_compose_the_plain_backward():
    """On CPU tensors the dq and dk/dv wrappers are their plain versions,
    and ``flash_attention_backward`` is the plain backward; no launch is
    counted."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 48))
    out, lse = attention_reference(q, k, v, causal=True, return_lse=True)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_backward(q, k, v, out, lse, g, causal=True)
    want = flash_attention_backward_reference(q, k, v, out, lse, g,
                                              causal=True)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
    delta = (g * out).sum(-1)
    assert torch.equal(flash_bwd_dq(q, k, v, g, lse, delta, causal=True),
                       want[0])


def test_mask_gets_no_gradient_and_lse_is_not_differentiable():
    q, k, v, g = _inputs(4, 32)
    tq, tk, tv = _t(q, k, v, grad=True)
    mask = torch.ones(B, 32, requires_grad=True)
    out, lse = flash_attention(tq, tk, tv, kv_mask=mask, return_lse=True)
    assert not lse.requires_grad
    out.sum().backward()
    assert mask.grad is None and tq.grad is not None


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_arithmetic(q, k, v, dout, lse, delta, causal, scale, mask):
    """The bf16 backward kernels' arithmetic (``csrc/flash_bwd.cu``), written
    out on the CPU: bf16 operands, float32 products and accumulation, P and
    dS rounded to bf16 once as the A operand of the second product (dV =
    P^T dO, dQ = dS K, dK = dS^T Q), the gradients rounded to bf16."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s, sk = sc.shape[-2:]
    keep = torch.ones(sc.shape, dtype=torch.bool)
    if causal:
        keep &= torch.arange(sk)[None, :] <= torch.arange(s)[:, None]
    if mask is not None:
        keep &= mask[:, None, None, :] > 0
    p = torch.where(keep, torch.exp(sc - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dout, v) - delta[..., None])
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds16, k)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds16, q)
    dv = torch.einsum("bhqk,bhqd->bhkd", p16, dout)
    return tuple(_bf16(x) for x in (dq, dk, dv))


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "masked"])
def test_tensor_core_rounding_within_the_bf16_tolerance(causal, masked):
    """Justifies the card tests' bf16 tolerance (2e-2 of the largest
    |gradient|) before any card run: the bf16 kernels' arithmetic against
    the float32 plain backward on the same bf16-valued inputs, B=2 H=2
    S=256 D=64. The forward's O is rounded to bf16 (as the forward kernel
    writes it) before D = rowsum(dO * O). Observed: 2.6e-3 to 3.9e-3 of
    the largest |gradient|."""
    b, h, s, d = 2, 2, 256, 64
    rs = np.random.RandomState(1)
    q, k, v = (_bf16(torch.from_numpy(rs.randn(b, h, s, d).astype(
        np.float32))) for _ in range(3))
    g = _bf16(torch.from_numpy((rs.randn(b, h, s, d) * np.linspace(
        0.5, 2.0, s)[:, None]).astype(np.float32)))
    mask = None
    if masked:
        mask = torch.ones(b, s)
        mask[0, 200:] = 0.0
        mask[1, 77:] = 0.0
    scale = 1.0 / math.sqrt(d)
    out, lse = attention_reference(q, k, v, causal, scale, kv_mask=mask,
                                   return_lse=True)
    delta = (g * _bf16(out)).sum(-1)
    got = _tensor_core_arithmetic(q, k, v, g, lse, delta, causal, scale, mask)
    want = flash_attention_backward_reference(q, k, v, out, lse, g, causal,
                                              scale, kv_mask=mask)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        ratio = float((a - w).abs().max() / w.abs().max())
        assert ratio <= 2e-2, (name, ratio)
        assert ratio > 0.0, name      # the rounding is really emulated
