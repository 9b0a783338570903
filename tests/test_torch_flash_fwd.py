"""PyTorch port, the card kernels' arithmetic on the CPU:

- the bfloat16 flash-attention forward (``csrc/flash_fwd.cu``,
  ``flash_fwd_mma_kernel``) emulated in PyTorch — bf16 Q/K/V, float32
  scores, the online max per 64-key tile, P rounded to bf16 before P V, l
  summed from the unrounded P — against the JAX package's Pallas forward
  (``_flash_pallas_forward``) in interpret mode on the same bf16 inputs;
- the split verify (``csrc/paged_verify.cu``): partial softmax states of
  chunks of each slot's walk, combined in chunk order, against the port's
  ``paged_attention_verify_reference`` and the JAX ``paged_attention_verify``
  in interpret mode, over plain, int8 and fp8 pools.

Inputs are drawn with numpy from fixed seeds and handed to both packages.

Tolerances. Forward: outputs within 2e-2 absolute (the card tests'
bfloat16 tolerance): both sides round P to bfloat16 before P V, but
against different running maxima (64-key tiles here, one 128-key or
whole-row block in JAX), so a P entry may round to the neighbouring
bfloat16 value, and the output is rounded to bfloat16 at the end; a few
bfloat16 ulps at |O| ~ 1. Observed 2.0e-3 to 3.9e-3 against JAX and up to
7.5e-3 against the port's plain version (which rounds the normalised P).
The logsumexp within 1e-4: both sides sum the unrounded float32 P
(observed 4.8e-7). Split verify: 2e-5 in
float32, as the verify parity tests in test_torch_spec.py (float32
throughout, only the order of the sums differs).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu.utils import quant as jquant
from sparkflow_tpu_torch.ops import (attention_reference,
                                     paged_attention_verify_reference)
from sparkflow_tpu_torch.ops.attention import NEG_INF, _gather_dequant

FWD_TOL = 2e-2
LSE_TOL = 1e-4
SPLIT_TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK_N = 64          # keys per tile of the bf16 forward kernel


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_forward(q, k, v, causal, scale, mask, round_p=True,
                         block_n=BLOCK_N):
    """The bf16 forward kernel's arithmetic on bf16-valued float32 tensors
    [B,H,S,D]: scores in float32, masked to NEG_INF (causal, padded keys),
    the running max and sum folded per ``block_n``-key tile (64; 32 above
    head_dim 128), P rounded to bf16 (with ``round_p``) before P V while l
    sums the unrounded P; O rounded to bf16. Returns ``(O, lse)``."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    m = torch.full((b, h, s), NEG_INF)
    l = torch.zeros(b, h, s)
    acc = torch.zeros(b, h, s, d)
    for k0 in range(0, sk, block_n):
        kt, vt = k[:, :, k0:k0 + block_n], v[:, :, k0:k0 + block_n]
        sc = torch.einsum("bhqd,bhkd->bhqk", q, kt) * scale
        keys = torch.arange(k0, k0 + kt.shape[2])
        if causal:
            sc = torch.where(keys[None, :] <= torch.arange(s)[:, None], sc,
                             NEG_INF)
        if mask is not None:
            sc = torch.where(mask[:, None, None, k0:k0 + kt.shape[2]] > 0, sc,
                             NEG_INF)
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(sc - mx[..., None])
        l = l * alpha + p.sum(-1)
        pv = _bf16(p) if round_p else p
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", pv, vt)
        m = mx
    den = l.clamp(min=1e-30)
    return _bf16(acc / den[..., None]), m + torch.log(den)


def _fwd_case(seed, b, s, causal, pad_rows=None, h=2, d=64):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    q, k, v = (_bf16(torch.from_numpy(a)) for a in (q, k, v))
    mask = None
    if pad_rows is not None:
        mask = torch.ones(b, s)
        for i, first in enumerate(pad_rows):
            mask[i, first:] = 0.0
    return q, k, v, mask


def _jax_forward_bf16(q, k, v, mask, causal, scale):
    s = q.shape[2]
    blk = min(s, 128)
    as_j = lambda t: jnp.asarray(t.numpy()).astype(jnp.bfloat16)  # noqa: E731
    out, lse = jattn._flash_pallas_forward(
        as_j(q), as_j(k), as_j(v),
        None if mask is None else jnp.asarray(mask.numpy()), causal, scale,
        blk, blk, True, with_lse=True)
    return (torch.from_numpy(np.array(out.astype(jnp.float32))),
            torch.from_numpy(np.array(lse)))


@pytest.mark.parametrize("case", [
    dict(b=2, s=128, causal=True),
    dict(b=2, s=100, causal=True),                     # ragged S, one tile
    dict(b=3, s=256, causal=False, pad_rows=(200, 77, 0)),  # row 2 all pad
], ids=["causal128", "ragged100", "masked256"])
def test_tensor_core_forward_matches_jax_pallas(case):
    q, k, v, mask = _fwd_case(len(case) + case["s"], **case)
    scale = 1.0 / math.sqrt(q.shape[-1])
    got, got_lse = _tensor_core_forward(q, k, v, case["causal"], scale, mask)
    want, want_lse = _jax_forward_bf16(q, k, v, mask, case["causal"], scale)
    err = float((got - want).abs().max())
    assert err <= FWD_TOL, err
    live = want_lse > 0.5 * NEG_INF
    np.testing.assert_allclose(got_lse[live].numpy(), want_lse[live].numpy(),
                               atol=LSE_TOL, rtol=0)
    # a row whose keys are all padding: lse at NEG_INF on both sides, and
    # its output the uniform average of the values, as in JAX
    assert bool((got_lse[~live] <= 0.5 * NEG_INF).all())
    if mask is not None:
        uniform = _bf16(v[2].mean(1, keepdim=True).expand_as(got[2]))
        assert float((got[2] - uniform).abs().max()) <= FWD_TOL
    # the port's plain version agrees too, and the P rounding is really
    # emulated: without it the result moves
    ref = attention_reference(q, k, v, case["causal"], scale, kv_mask=mask)
    assert float((got - ref).abs().max()) <= FWD_TOL
    unrounded, _ = _tensor_core_forward(q, k, v, case["causal"], scale, mask,
                                        round_p=False)
    assert not torch.equal(unrounded, got)


def _wide_head_forward(q, k, v, causal, scale, mask):
    """The layout of the bf16 forward's instantiations above head_dim 128:
    head_dim zero-padded to a multiple of 32 (cp.async's zero fill; 136 ->
    160), 32-key tiles, Q read from shared memory at each tile (the same
    values as Q held in registers), the padded output columns not
    stored."""
    d = q.shape[-1]
    pad = -d % 32
    qp, kp, vp = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out, lse = _tensor_core_forward(qp, kp, vp, causal, scale, mask,
                                    block_n=32)
    return out[..., :d], lse


@pytest.mark.parametrize("case", [
    dict(b=2, s=128, causal=True),
    dict(b=3, s=256, causal=False, pad_rows=(200, 77, 0)),  # row 2 all pad
], ids=["causal128", "masked256"])
@pytest.mark.parametrize("d", [136, 256])
def test_wide_head_forward_matches_jax_pallas(case, d):
    """Head_dim 136 (padded to 160) and 256 (GPT-J-6B's heads) in the wide
    instantiations' layout against the JAX Pallas forward, within the
    bfloat16 tolerance; the lse within 1e-4."""
    q, k, v, mask = _fwd_case(d + case["s"], **case, d=d)
    scale = 1.0 / math.sqrt(d)
    got, got_lse = _wide_head_forward(q, k, v, case["causal"], scale, mask)
    want, want_lse = _jax_forward_bf16(q, k, v, mask, case["causal"], scale)
    assert got.shape == q.shape
    err = float((got - want).abs().max())
    assert err <= FWD_TOL, err
    live = want_lse > 0.5 * NEG_INF
    np.testing.assert_allclose(got_lse[live].numpy(), want_lse[live].numpy(),
                               atol=LSE_TOL, rtol=0)
    assert bool((got_lse[~live] <= 0.5 * NEG_INF).all())
    ref = attention_reference(q, k, v, case["causal"], scale, kv_mask=mask)
    assert float((got - ref).abs().max()) <= FWD_TOL


# -- the split verify ---------------------------------------------------------

PAGE = 8


def _verify_case(seed, s, kind):
    """q [B,H,S,D], pools (JAX-quantized when ``kind``), a page table with
    an aliased page and starts 0, mid-page, and at the table's end."""
    rs = np.random.RandomState(seed)
    b, h, d, maxp = 4, 2, 16, 6
    num_pages = 1 + b * maxp
    q = rs.randn(b, h, s, d).astype(np.float32)
    k = rs.randn(num_pages, PAGE, h, d).astype(np.float32)
    v = rs.randn(num_pages, PAGE, h, d).astype(np.float32)
    ids = list(range(1, num_pages))
    rs.shuffle(ids)
    table = np.array(ids[:b * maxp], np.int32).reshape(b, maxp)
    table[2, 0] = table[1, 0]                 # aliased page
    start = np.array([0, PAGE - 3, 3 * PAGE + 1, maxp * PAGE - s], np.int32)
    ks = vs = None
    if kind is not None:
        k[table[3, 2], :, 1] = 0.0            # a page-head of scale 0
        k, ks = (np.asarray(a) for a in jquant.quantize_kv_pages(
            jnp.asarray(k), kind))
        v, vs = (np.asarray(a) for a in jquant.quantize_kv_pages(
            jnp.asarray(v), kind))
    return q, k, v, ks, vs, table, start


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.asarray(a).copy())


def _chunk_states(q, k, v, start, chunk):
    """Per chunk of ``chunk`` tokens of each slot's walk, the partial
    softmax state the split kernel writes: ``(m, l, acc)`` over the rows of
    that chunk each query sees, with (NEG_INF, 0, 0) for a chunk where a
    query sees no row; and each slot's count of live chunks (those that
    start before ``start + S``). k, v: [B, T, H, D] float32 gathered rows."""
    b, h, s, d = q.shape
    t = k.shape[1]
    att = torch.einsum("bhsd,bkhd->bhsk", q, k) / math.sqrt(d)
    qpos = start.long()[:, None] + torch.arange(s)[None, :]        # [B, S]
    valid = (torch.arange(t)[None, None, :] <= qpos[:, :, None])[:, None]
    states = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        vis = valid[..., sl].expand(b, h, s, -1)
        a = torch.where(vis, att[..., sl], NEG_INF)
        seen = vis.any(-1)
        m = torch.where(seen, a.amax(-1), NEG_INF)
        p = torch.where(vis, torch.exp(a - m[..., None]), 0.0)
        states.append((m, p.sum(-1),
                       torch.einsum("bhsk,bkhd->bhsd", p, v[:, sl])))
    end = (start.long() + s).clamp(max=t)
    live = (end + chunk - 1) // chunk
    return states, live


def _combine(states, live):
    """The combine kernel's fold: the live chunks' states in chunk order,
    rescaled to their common max."""
    out = []
    for bi, n in enumerate(live.tolist()):
        ms = torch.stack([st[0][bi] for st in states[:n]])        # [n, H, S]
        mmax = ms.amax(0)
        lsum = torch.zeros_like(mmax)
        acc = torch.zeros_like(states[0][2][bi])
        for m, l, a in states[:n]:
            w = torch.exp(m[bi] - mmax)
            lsum = lsum + l[bi] * w
            acc = acc + a[bi] * w[..., None]
        out.append(acc / lsum.clamp(min=1e-30)[..., None])
    return torch.stack(out)


@pytest.mark.parametrize("chunk", [1, 5, 16, 128])
@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["plain", "int8", "fp8"])
def test_split_and_combine_equals_the_whole_walk(kind, chunk):
    """Chunks of 1, 5, 16 and 128 tokens (ragged against the 8-token page,
    and a whole walk in one chunk), including live chunks in which early
    queries see no row, folded in order, equal the plain verify attention
    and the JAX Pallas verify kernel."""
    s = 4
    q, k, v, ks, vs, table, start = _verify_case(chunk + 7, s, kind)
    tq, tk, tv, tks, tvs = (_to_torch(a) for a in (q, k, v, ks, vs))
    tt, tst = torch.from_numpy(table), torch.from_numpy(start)
    rows_k = _gather_dequant(tk, tt, tks)
    rows_v = _gather_dequant(tv, tt, tvs)
    states, live = _chunk_states(tq, rows_k, rows_v, tst, chunk)
    if chunk == 1:
        # slot 0's last chunk holds only its last query's row: the others
        # see nothing there, and still the fold is exact
        assert bool((states[s - 1][0][0, :, :s - 1] == NEG_INF).all())
        assert bool((states[s - 1][1][0, :, :s - 1] == 0).all())
    got = _combine(states, live)
    scales = {} if kind is None else dict(k_scales=tks, v_scales=tvs)
    want = paged_attention_verify_reference(tq, tk, tv, tt, tst, **scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SPLIT_TOL)
    jsc = {} if kind is None else dict(k_scales=jnp.asarray(ks),
                                       v_scales=jnp.asarray(vs))
    jo = np.asarray(jattn.paged_attention_verify(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(start), interpret=True, **jsc))
    np.testing.assert_allclose(got.numpy(), jo, **SPLIT_TOL)
