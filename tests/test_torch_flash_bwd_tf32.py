"""PyTorch port, the float32 flash-attention backward kernels' arithmetic
on the CPU: ``csrc/flash_bwd.cu``'s ``flash_bwd_dq_tf32_kernel`` and
``flash_bwd_dkv_tf32_kernel`` run every product on the tensor cores in
3xTF32 (``csrc/mma_tf32.cuh``). Emulated here in PyTorch
(tests/tf32_emulation.py):

- TF32 rounding as ``cvt.rna.tf32.f32`` does it;
- each product split into big and small of both operands, summed k-step by
  k-step of 8 in the kernels' order, small terms first — with the
  kernels' operands in the A and B places (dq:
  Q K^T, dO V^T, dS K; dkv: K Q^T, V dO^T, P^T dO, dS^T Q) and the
  contraction over keys or queries walked in order, as the kernels walk
  their tiles;
- P = exp2(scale*log2(e) S - log2(e) L), exactly 0 where causal-excluded,
  padded or past the ragged edge.

Against the JAX package's Pallas backward in interpret mode
(``_flash_pallas_backward``, as tests/test_torch_flash_bwd.py runs it) on
numpy-seeded float32 inputs and the JAX forward's own O and logsumexp:
causal, non-causal with padded keys (one batch row all padding) and a
ragged S, at head_dim 8, 64 and 72.

Tolerance: every gradient within 2e-5 x its largest magnitude (observed
4.2e-7 to 1.3e-6; the same recurrence unrounded lands 2.5e-7 to 9.4e-7
off: both sides are float32-accurate and sum in other orders). One TF32
product alone (big_a * big_b, every product) lands at least 10x further
off (observed 4.1e-4 to 1.2e-3 of the largest gradient, past the card
tests' 1e-4): why the kernels take three.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu_torch.ops import flash_attention_backward_reference
from tf32_emulation import LOG2E, product as _product, split as _split, tf32

REL_TOL = 2e-5
ONE_TF32_FACTOR = 10.0
B, H = 2, 2


def _keep(s, sk, causal, mask):
    """[B or 1, 1, S, S_k] bool: the (query, key) pairs that attend."""
    keep = torch.ones(1, 1, s, sk, dtype=torch.bool)
    if causal:
        keep &= torch.arange(sk)[None, :] <= torch.arange(s)[:, None]
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    return keep


def tf32_backward(q, k, v, out, lse, dout, causal, scale, mask, mode="3x"):
    """The float32 kernels' arithmetic: ``(dq, dk, dv)`` from the forward's
    O and logsumexp, every product in 3xTF32 (or as ``mode`` says, see
    :func:`tf32_emulation.product`)."""
    delta = (dout * out).sum(-1)                         # the wrapper's D
    s, sk = q.shape[2], k.shape[2]
    keep = _keep(s, sk, causal, mask)
    sl2 = scale * LOG2E

    def p_of(scores):
        p = torch.exp2(scores * sl2 - (lse * LOG2E)[..., None])
        return torch.where(keep, p, 0.0)

    # the dq kernel: S = Q K^T, dP = dO V^T (over head_dim), dQ = dS K
    # (over keys)
    p = p_of(_product(q, k.transpose(-1, -2), mode))
    ds = p * (_product(dout, v.transpose(-1, -2), mode) - delta[..., None])
    dq = scale * _product(ds, k, mode)
    # the dkv kernel, its own keys the M side: S^T = K Q^T, dP^T = V dO^T,
    # dV = P^T dO and dK = dS^T Q (over queries)
    pt = p_of(_product(k, q.transpose(-1, -2), mode).transpose(-1, -2))
    dst = pt * (_product(v, dout.transpose(-1, -2), mode).transpose(-1, -2)
                - delta[..., None])
    dv = _product(pt.transpose(-1, -2), dout, mode)
    dk = scale * _product(dst.transpose(-1, -2), q, mode)
    return dq, dk, dv


def _inputs(seed, s, d):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, s, d).astype(np.float32) for _ in range(3))
    g = (rs.randn(B, H, s, d) * np.linspace(0.5, 2.0, s)[:, None]
         ).astype(np.float32)
    return q, k, v, g


def _jax_pallas(q, k, v, g, mask, causal, scale):
    """The JAX forward's O and logsumexp, and its Pallas backward's
    gradients, in interpret mode (one block over the whole sequence)."""
    s = q.shape[2]
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = jattn._flash_pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal, scale,
        s, s, True, with_lse=True)
    grads = jattn._flash_pallas_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, out, lse,
        jnp.asarray(g), causal, scale, s, s, True)
    return np.asarray(out), np.asarray(lse), [np.asarray(x) for x in grads]


CASES = {
    # causal over a sequence of two 64-row tiles
    "causal": dict(s=128, causal=True, first_pad=None),
    # padded keys, non-causal; batch row 1's keys are all padding
    "padded": dict(s=128, causal=False, first_pad=(77, 0)),
    # a ragged S (not a multiple of the 64-row tiles or of 8), causal, with
    # a padded tail
    "ragged": dict(s=100, causal=True, first_pad=(100, 61)),
}


@pytest.mark.parametrize("d", [8, 64, 72])
@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_backward_matches_jax_pallas(case, d):
    c = CASES[case]
    s, causal = c["s"], c["causal"]
    q, k, v, g = _inputs(d + s + causal, s, d)
    mask = None
    if c["first_pad"] is not None:
        mask = np.ones((B, s), np.float32)
        for i, first in enumerate(c["first_pad"]):
            mask[i, first:] = 0.0
    scale = 1.0 / math.sqrt(d)
    out, lse, want = _jax_pallas(q, k, v, g, mask, causal, scale)
    args = [torch.from_numpy(np.array(x))
            for x in (q, k, v, out, lse, g)]
    tm = None if mask is None else torch.from_numpy(mask)
    errs = {}
    for mode in ("3x", "1x"):
        got = tf32_backward(*args, causal, scale, tm, mode)
        errs[mode] = [float(np.abs(a.numpy() - w).max() / np.abs(w).max())
                      for a, w in zip(got, want)]
    for name, e3, e1 in zip(("dq", "dk", "dv"), errs["3x"], errs["1x"]):
        assert e3 <= REL_TOL, (name, e3)
        assert e1 >= ONE_TF32_FACTOR * e3, (name, e1, e3)
    if mask is not None and case == "padded":
        got = tf32_backward(*args, causal, scale, tm)
        # all keys of batch row 1 are padding: zero gradient, as in JAX
        assert all(torch.all(x[1] == 0) for x in got)


def test_tf32_rounding_is_cvt_rna():
    """Hand-made patterns: nearest, ties away from zero, both signs; 10
    mantissa bits kept; a carry into the exponent."""
    def f(bits):
        return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
            torch.float32)

    one = 0x3F800000
    cases = [
        (one, one),                          # exact
        (one + 0x0FFF, one),                 # below half: down
        (one + 0x1000, one + 0x2000),        # a tie: away from zero
        (one + 0x1001, one + 0x2000),        # above half: up
        (one + 0x2000 + 0x1000, one + 0x4000),   # a tie, odd kept: away
        (0x3FFFF000, 0x40000000),            # 1.99999...: carries to 2.0
    ]
    for src, want in cases:
        for sign in (0, 1 << 31):
            got = tf32(f(src | sign))
            assert torch.equal(got, f(want | sign)), (hex(src), sign)
    # kept bits: the low 13 are zero, and the split recovers ~21 bits
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32))
    big, small = _split(x)
    assert torch.all((big.view(torch.int32) & 0x1FFF) == 0)
    assert float(((big + small - x).abs() / x.abs()).max()) < 2.0 ** -21
    assert float(((big - x).abs() / x.abs()).max()) > 2.0 ** -13


def test_emulation_without_rounding_is_the_plain_backward():
    """With the TF32 rounding taken out (``mode="float32"``), the
    emulation's recurrence is the port's plain float32 backward: the test
    checks the kernels' recurrence, not only their rounding."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(3, 96, 64))
    mask = torch.ones(B, 96)
    mask[1, 40:] = 0
    scale = 0.125
    from sparkflow_tpu_torch.ops import attention_reference
    out, lse = attention_reference(q, k, v, True, scale, kv_mask=mask,
                                   return_lse=True)
    want = flash_attention_backward_reference(q, k, v, out, lse, g, True,
                                              scale, kv_mask=mask)
    got = tf32_backward(q, k, v, out, lse, g, True, scale, mask, "float32")
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 2e-6 * float(w.abs().max())
