"""PyTorch port, attention ops: the port's wrappers (plain versions on the
CPU) against the JAX package's Pallas kernels run in interpret mode.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
Tolerance 2e-5 in float32: both sides accumulate scores and softmax in
float32, and only the summation order differs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                     last_attention_path, paged_attention,
                                     paged_attention_reference)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b, h, s, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, s, d).astype(np.float32) for _ in range(3))


def _ragged_mask(b, s, seed):
    rs = np.random.RandomState(seed)
    m = np.ones((b, s), np.float32)
    for i in range(b):
        m[i, rs.randint(s // 2, s):] = 0.0   # a padded tail per row
    return m


@pytest.mark.parametrize("s", [16, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_matches_jax_pallas(s, causal, masked):
    b, h, d = 2, 3, 16
    q, k, v = _qkv(s + 7 * causal + 3 * masked, b, h, s, d)
    mask = _ragged_mask(b, s, s) if masked else None
    scale = 1.0 / math.sqrt(d)
    blk = min(s, 128)
    jo, jlse = jattn._flash_pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal, scale, blk, blk,
        True, with_lse=True)
    to, tlse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_mask=None if mask is None else torch.from_numpy(mask),
        return_lse=True)
    assert last_attention_path() == "reference"   # CPU tensors
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    # the JAX public entry point agrees too (it may route to its reference)
    jpub = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, kv_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(to.numpy(), np.asarray(jpub), **TOL)


def test_flash_attention_without_lse_returns_tensor():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 2, 16, 8))
    out = flash_attention(q, k, v, causal=True)
    assert isinstance(out, torch.Tensor) and out.shape == (1, 2, 16, 8)
    ref = attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref)


def test_flash_attention_strided_views_match_contiguous():
    """The model hands the wrapper slices of one qkv permutation."""
    rs = np.random.RandomState(5)
    qkv = torch.from_numpy(rs.randn(2, 24, 3, 4, 8).astype(np.float32))
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def _rand_paged(rs, b, h, d, page, maxp, lengths, alias=False):
    """Random q + pools + page tables for ragged lengths; page 0 is
    scratch. With ``alias`` slot 1's first page aliases slot 0's."""
    num_pages = 1 + b * maxp
    q = rs.randn(b, h, d).astype(np.float32)
    k = rs.randn(num_pages, page, h, d).astype(np.float32)
    v = rs.randn(num_pages, page, h, d).astype(np.float32)
    table = np.zeros((b, maxp), np.int32)
    ids = list(range(1, num_pages))
    rs.shuffle(ids)
    nxt = 0
    for i, ln in enumerate(lengths):
        for p in range((ln + page - 1) // page):
            table[i, p] = ids[nxt]
            nxt += 1
    if alias and lengths[0] >= page and lengths[1] >= page:
        table[1, 0] = table[0, 0]
    return q, k, v, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_attention_matches_jax_pallas(page):
    rs = np.random.RandomState(page)
    b, h, d, maxp = 5, 4, 16, 4
    lengths = [page + 3, 2 * page, 0, 1, maxp * page]
    q, k, v, table, lens = _rand_paged(rs, b, h, d, page, maxp, lengths,
                                       alias=True)
    jo = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), interpret=True))
    to = paged_attention(*(torch.from_numpy(a) for a in (q, k, v, table,
                                                          lens)))
    assert last_attention_path() == "reference"
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    assert np.all(to.numpy()[2] == 0.0)   # the empty slot is exact zeros
    assert np.isfinite(to.numpy()).all()


def test_paged_attention_ignores_garbage_past_length():
    rs = np.random.RandomState(3)
    q, k, v, table, lens = _rand_paged(rs, 2, 2, 8, 8, 3, [9, 17])
    args = lambda kk, vv: (torch.from_numpy(q), torch.from_numpy(kk),
                           torch.from_numpy(vv), torch.from_numpy(table),
                           torch.from_numpy(lens))
    out1 = paged_attention(*args(k, v)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[table[0, 1], 1:] = 99.0     # past token 9 inside slot 0's 2nd page
    v2[table[0, 1], 1:] = -99.0
    k2[table[1, 2], 1:] = 50.0     # past token 17 inside slot 1's 3rd page
    out2 = paged_attention(*args(k2, v2)).numpy()
    np.testing.assert_allclose(out1, out2, atol=1e-6)


def test_paged_attention_reference_matches_dense_softmax():
    """The plain version checked against attention written from scratch
    over the gathered pages."""
    rs = np.random.RandomState(7)
    b, h, d, page, maxp = 2, 2, 8, 8, 2
    lengths = [5, 11]
    q, k, v, table, lens = _rand_paged(rs, b, h, d, page, maxp, lengths)
    out = paged_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, table, lens))).numpy()
    for i, ln in enumerate(lengths):
        kk = k[table[i]].reshape(-1, h, d)[:ln]
        vv = v[table[i]].reshape(-1, h, d)[:ln]
        s = np.einsum("hd,lhd->hl", q[i], kk) / np.sqrt(d)
        p = np.exp(s - s.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        np.testing.assert_allclose(out[i], np.einsum("hl,lhd->hd", p, vv),
                                   atol=1e-5, rtol=1e-5)


def test_paged_attention_masked_lane_reads_scratch():
    """What the engine feeds a lane that is not decoding: a table row of
    scratch page 0 and length 1 — a valid read of one pool row."""
    rs = np.random.RandomState(9)
    q, k, v, table, lens = _rand_paged(rs, 2, 2, 8, 8, 2, [12, 3])
    table[1] = 0
    lens[1] = 1
    out = paged_attention(*(torch.from_numpy(a)
                            for a in (q, k, v, table, lens))).numpy()
    np.testing.assert_allclose(out[1], v[0, 0], **TOL)


def test_kernel_wrappers_reject_other_devices():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
