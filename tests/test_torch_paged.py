"""PyTorch port, the decode kernel's arithmetic on the CPU
(``csrc/paged_attention.cu``): the walk of each (slot, head) split into
chunks, one thread block each; each block's partial softmax state
(m, l, acc) over its chunk's tokens below the slot's length — a chunk at or
past the length publishes (NEG_INF, 0, 0); all blocks of the cluster folded
in rank order, rescaled to their common max, and divided by
max(l, 1e-30). The chunk and the block count come from the wrapper's own
sizing (``_paged_split``), from the table's width and the pool's row
alone.

The emulation takes the quantized pool's stored values and folds the
scales as the kernel does — the K scale into the score,
s = (q . Kq) * (ks * scale), the V scale into the PV weight — and is held
against the port's ``paged_attention_reference`` (which dequantizes the
gathered pages first) and the JAX ``paged_attention`` in interpret mode,
over plain, int8 and fp8 pools, on the same numpy inputs.

Tolerance 2e-5 absolute and relative, in float32: every side computes in
float32 from the same stored values and scales; only the order of the
sums, and where the scales are applied, differ. A slot of length 0 must
come out as exact zeros (0 / 1e-30 in the fold).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu.utils import quant as jquant
from sparkflow_tpu_torch.ops import paged_attention, paged_attention_reference
from sparkflow_tpu_torch.ops.attention import (DECODE_CHUNK, NEG_INF,
                                               _decode_trip, _paged_split)

TOL = dict(atol=2e-5, rtol=2e-5)

# (page, max pages, head_dim) -> the split the kernel gets over a float32
# and over an int8/fp8 pool, and the lengths a call holds: 0, 1, page - 1,
# page, chunk - 1, chunk, chunk + 1 and the table's whole width (those
# that fit in it). At D = 80 a block loads at most 128 rows a trip of any
# pool; at D = 64, 256 int8/fp8 rows, so their chunk is 256.
TABLES = {
    "chunk128": (8, 40, 80, (128, 3), (128, 3)),
    "page64": (64, 6, 80, (128, 3), (128, 3)),
    "grown": (16, 80, 80, (160, 8), (160, 8)),   # 1280 tokens: it grows
    "one-block": (8, 4, 80, (128, 1), (128, 1)),  # a cluster of one block
    "trip256": (16, 40, 64, (128, 5), (256, 3)),  # an int8/fp8 trip
}


def _lengths(page, maxp, chunk):
    total = maxp * page
    want = (0, 1, page - 1, page, chunk - 1, chunk, chunk + 1, total)
    return sorted({n for n in want if n <= total})


def _case(seed, page, maxp, kind, d, h=2):
    """q, pools (JAX-quantized when ``kind``: rows and scales), a table with
    every entry a valid pool page and one page aliased by two slots, the
    lengths; with ``kind`` one page-head is all zeros (scale 0)."""
    chunk = _paged_split(maxp, page, d, 4 if kind is None else 1)[0]
    lengths = np.array(_lengths(page, maxp, chunk), np.int32)
    b = len(lengths)
    rs = np.random.RandomState(seed)
    num_pages = 1 + b * maxp
    q = rs.randn(b, h, d).astype(np.float32)
    k = rs.randn(num_pages, page, h, d).astype(np.float32)
    v = rs.randn(num_pages, page, h, d).astype(np.float32)
    ids = list(range(1, num_pages))
    rs.shuffle(ids)
    table = np.array(ids[:b * maxp], np.int32).reshape(b, maxp)
    table[-1, 0] = table[-2, 0]              # a shared prefix page
    table[0] = 0                             # the empty slot: scratch page
    ks = vs = None
    if kind is not None:
        k[table[-1, 1], :, 1] = 0.0          # a page-head of scale 0
        v[table[-1, 1], :, 1] = 0.0
        k, ks = (np.asarray(a) for a in jquant.quantize_kv_pages(
            jnp.asarray(k), kind))
        v, vs = (np.asarray(a) for a in jquant.quantize_kv_pages(
            jnp.asarray(v), kind))
        assert ks[table[-1, 1], 1] == 0.0
    return q, k, v, ks, vs, table, lengths


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.asarray(a).copy())


def _cluster_decode(q, k, v, table, lengths, ks=None, vs=None):
    """The decode kernel's arithmetic: returns ``(out, states)``, the
    per-block ``(m, l, acc)`` states in rank order ([B, H], [B, H],
    [B, H, D])."""
    b, h, d = q.shape
    maxp, page = table.shape[1], k.shape[1]
    chunk, blocks = _paged_split(maxp, page, d, k.element_size())
    total = maxp * page
    idx = table.long()
    kq = k[idx].float().reshape(b, total, h, d)        # stored values
    vq = v[idx].float().reshape(b, total, h, d)
    scale = 1.0 / math.sqrt(d)
    dot = torch.einsum("bhd,bthd->bht", q.float(), kq)
    if ks is None:
        s = dot * scale
        vw = torch.ones(b, h, total)
    else:
        per_tok = lambda sc: sc[idx].repeat_interleave(  # noqa: E731
            page, dim=1).permute(0, 2, 1)              # [B, H, T]
        s = dot * (per_tok(ks) * scale)
        vw = per_tok(vs)
    n = lengths.long().clamp(max=total)[:, None, None]
    tok = torch.arange(total)[None, None, :]
    states = []
    for r in range(blocks):
        live = (tok >= r * chunk) & (tok < (r + 1) * chunk) & (tok < n)
        live = live.expand(b, h, total)
        seen = live.any(-1)
        m = torch.where(seen, torch.where(live, s, NEG_INF).amax(-1),
                        torch.tensor(NEG_INF))
        p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
        states.append((m, p.sum(-1),
                       torch.einsum("bht,bthd->bhd", p * vw, vq)))
    mx = torch.stack([st[0] for st in states]).amax(0)
    lsum = torch.zeros(b, h)
    acc = torch.zeros(b, h, d)
    for m, l, a in states:                             # rank order
        w = torch.exp(m - mx)
        lsum = lsum + l * w
        acc = acc + a * w[..., None]
    return acc / lsum.clamp(min=1e-30)[..., None], states


@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["plain", "int8", "fp8"])
@pytest.mark.parametrize("name", list(TABLES))
def test_cluster_split_equals_the_whole_walk(name, kind):
    """Lengths 0, 1, page-1, page, chunk-1, chunk, chunk+1 and the table's
    width in one call, dead chunks included, folded in rank order: equal to
    the plain version and to the JAX Pallas kernel; the empty slot exact
    zeros."""
    page, maxp, d, *splits = TABLES[name]
    split = splits[kind is not None]
    assert _paged_split(maxp, page, d, 4 if kind is None else 1) == split
    q, k, v, ks, vs, table, lengths = _case(page + maxp, page, maxp, kind, d)
    tq, tk, tv, tks, tvs = (_to_torch(a) for a in (q, k, v, ks, vs))
    tt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    got, states = _cluster_decode(tq, tk, tv, tt, tl, tks, tvs)
    chunk, blocks = split
    # a chunk past a slot's length publishes the empty state
    for r, (m, l, a) in enumerate(states):
        dead = (tl <= r * chunk)[:, None].expand_as(m)
        assert bool((m[dead] == NEG_INF).all() and (l[dead] == 0).all())
        assert bool((a[dead] == 0).all())
    if blocks > 1:
        assert bool((tl[1] <= chunk) and (tl[-1] > (blocks - 1) * chunk))
    assert bool((got[0] == 0).all())            # length 0: exact zeros
    scales = {} if kind is None else dict(k_scales=tks, v_scales=tvs)
    want = paged_attention_reference(tq, tk, tv, tt, tl, **scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # the wrapper's CPU route is that plain version
    assert torch.equal(paged_attention(tq, tk, tv, tt, tl, **scales), want)
    jsc = {} if kind is None else dict(k_scales=jnp.asarray(ks),
                                       v_scales=jnp.asarray(vs))
    jo = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), interpret=True, **jsc))
    np.testing.assert_allclose(got.numpy(), jo, **TOL)
    assert np.all(jo[0] == 0.0)


@pytest.mark.parametrize("maxp,page,d,itemsize,split", [
    (64, 16, 64, 2, (128, 8)),    # the decode step, bf16: 8 blocks of 128
    (64, 16, 64, 1, (256, 4)),    # int8/fp8: one trip is 256 tokens
    (64, 16, 64, 4, (128, 8)),    # float32: a trip is 64, the chunk 128
    (64, 16, 72, 1, (128, 8)),    # 8-byte int8 runs: a trip is 64
    (64, 16, 8, 2, (1024, 1)),    # one lane a row: a trip is 1024
    (128, 16, 64, 2, (256, 8)),   # 2048 tokens: the chunk grows past 128
    (4, 8, 64, 2, (128, 1)),      # fewer tokens than one chunk: one block
    (10, 24, 64, 2, (144, 2)),    # 128 rounded up to a whole page of 24
    (4, 256, 64, 2, (256, 4)),    # a page longer than the chunk
    (1000, 1, 64, 2, (128, 8)),
    (2000, 1, 64, 2, (250, 8)),
    (0, 16, 64, 2, (128, 1)),     # an empty table still launches one block
])
def test_split_is_sized_from_the_table_width(maxp, page, d, itemsize, split):
    """The chunk is at least DECODE_CHUNK tokens and one block's trip, and
    a whole number of pages; the cluster at most 8 blocks, and the blocks
    cover the table's tokens with no block wholly past them."""
    chunk, blocks = _paged_split(maxp, page, d, itemsize)
    assert (chunk, blocks) == split
    total = maxp * page
    assert chunk % page == 0 and chunk >= DECODE_CHUNK
    assert chunk >= _decode_trip(d, itemsize)
    assert 1 <= blocks <= 8 and blocks * chunk >= total
    assert (blocks - 1) * chunk < max(total, 1)
