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
    # GPT-J-6B's head: a float32 row is 32 lanes x 2 runs (a trip of 16
    # rows), an int8/fp8 row 16 lanes (64 rows): chunks of 128 either way
    "wide256": (16, 40, 256, (128, 5), (128, 5)),
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


def decode_layout(d, itemsize):
    """What ``csrc/paged_attention.cu`` launches for a pool row of ``d``
    elements of ``itemsize`` bytes: ``(VEC, NR, G, kU, trip)`` — VEC
    elements a run (16 bytes; 8 for an int8/fp8 row whose d is not a
    multiple of 16), NR runs a lane (2 for a float32 row above 128 elements,
    ``sf_paged_attention``), G lanes a row (``launch``), kU rows a lane in
    flight, and the block's trip of kWarps * (32 / G) * kU rows."""
    vec = (16 if itemsize > 1 or d % 16 == 0 else 8) // itemsize
    nr = 2 if itemsize == 4 and d > 128 else 1
    g = 1
    while g * vec * nr < d:
        g *= 2
    return vec, nr, g, 4 // nr, 8 * (32 // g) * (4 // nr)


def _butterfly(xs):
    """A shuffle-xor tree over a power-of-two list of per-lane values, as
    lane 0 sees it: at offset o (high to low) lane i adds lane i ^ o."""
    while len(xs) > 1:
        half = len(xs) // 2
        xs = [xs[i] + xs[i + half] for i in range(half)]
    return xs[0]


def _merge(a, b):
    """Two online-softmax states (m, l, acc) folded as the kernel folds a
    row group's or a warp's: rescaled to their common max."""
    (m1, l1, a1), (m2, l2, a2) = a, b
    mn = torch.maximum(m1, m2)
    f1, f2 = torch.exp(m1 - mn), torch.exp(m2 - mn)
    return mn, l1 * f1 + l2 * f2, a1 * f1[..., None] + a2 * f2[..., None]


def _lane_decode(q, k, v, table, lengths, ks=None, vs=None):
    """The decode kernel's walk inside each block, in float32, in its own
    layout and order: row slot j = warp * (32 / G) + group of a block takes
    tokens c0 + j, c0 + j + 32 / G * kWarps, ... of its chunk (trips of
    kU rows a lane); a row's score is each lane's dot over its NR runs of
    VEC elements, summed over the row's G lanes by a shuffle-xor tree; each
    row slot keeps its own (m, l, acc) over its rows in order; the row
    groups of a warp fold by shuffles, the 8 warps in order, and the
    blocks of the cluster in rank order."""
    b, h, d = q.shape
    maxp, page = table.shape[1], k.shape[1]
    vec, nr, g, _, _ = decode_layout(d, k.element_size())
    chunk, blocks = _paged_split(maxp, page, d, k.element_size())
    total, groups = maxp * page, 32 // g
    step = 8 * groups
    idx = table.long()
    kq = k[idx].float().reshape(b, total, h, d)
    vq = v[idx].float().reshape(b, total, h, d)
    per_tok = None
    if ks is not None:
        per_tok = lambda sc: sc[idx].repeat_interleave(  # noqa: E731
            page, dim=1)                                # [B, T, H]
        kscale, vscale = per_tok(ks), per_tok(vs)
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    # each lane's runs: lane `sub` holds elements (sub + r * G) * VEC + e
    runs = [[(sub + r * g) * vec for r in range(nr)] for sub in range(g)]
    n = lengths.long().clamp(max=total)
    empty = (torch.full((b, h), NEG_INF), torch.zeros(b, h),
             torch.zeros(b, h, d))
    ranks = []
    for r in range(blocks):
        c0, c1 = r * chunk, min((r + 1) * chunk, total)
        slots = []
        for j in range(step):
            st = empty
            for t in range(c0 + j, c1, step):
                live = (t < n)[:, None]                 # [B, 1]
                lane = [sum((qf[:, :, d0:d0 + vec] * kq[:, t, :, d0:d0 + vec]
                             ).sum(-1) for d0 in rs if d0 < d)
                        if any(d0 < d for d0 in rs) else torch.zeros(b, h)
                        for rs in runs]
                sc = _butterfly(lane)
                sc = sc * (kscale[:, t] * scale if ks is not None else scale)
                m, l, acc = st
                mn = torch.maximum(m, sc)
                alpha, p = torch.exp(m - mn), torch.exp(sc - mn)
                pv = p * vscale[:, t] if ks is not None else p
                new = (mn, l * alpha + p,
                       acc * alpha[..., None] + pv[..., None] * vq[:, t])
                st = tuple(torch.where(live[..., None] if x.dim() == 3
                                       else live, y, x)
                           for x, y in zip(st, new))
            slots.append(st)
        # row groups of a warp by shuffles (groups 2i, 2i+1 first), then
        # the warps in order
        warps = []
        for w in range(8):
            gs = slots[w * groups:(w + 1) * groups]
            while len(gs) > 1:
                gs = [_merge(gs[i], gs[i + 1]) for i in range(0, len(gs), 2)]
            warps.append(gs[0])
        mx = torch.stack([w_[0] for w_ in warps]).amax(0)
        lsum, acc = torch.zeros(b, h), torch.zeros(b, h, d)
        for m, l, a in warps:
            f = torch.exp(m - mx)
            lsum, acc = lsum + l * f, acc + a * f[..., None]
        ranks.append((mx, lsum, acc))
    mx = torch.stack([r_[0] for r_ in ranks]).amax(0)
    lsum, acc = torch.zeros(b, h), torch.zeros(b, h, d)
    for m, l, a in ranks:                               # rank order
        f = torch.exp(m - mx)
        lsum, acc = lsum + l * f, acc + a * f[..., None]
    return acc / lsum.clamp(min=1e-30)[..., None]


@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["plain", "int8", "fp8"])
@pytest.mark.parametrize("d", [136, 256])
def test_lane_layout_walk_at_wide_heads_matches_jax_pallas(d, kind):
    """Head_dim 136 and 256 in the kernel's own lane layout: over a float32
    pool a row is wider than a warp's 32 lanes of one 16-byte run, so each
    lane holds two runs (at 256: elements sub * 4 and 128 + sub * 4) with
    half as many rows in flight; an int8/fp8 row takes 16 lanes (256) or
    32 lanes of 8-byte runs (136). Equal to the chunk-level emulation, the
    plain version and the JAX Pallas kernel in interpret mode; the empty
    slot exact zeros."""
    page, maxp = 16, 10
    q, k, v, ks, vs, table, lengths = _case(d, page, maxp, kind, d)
    tq, tk, tv, tks, tvs = (_to_torch(a) for a in (q, k, v, ks, vs))
    tt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    vec, nr, g, _, _ = decode_layout(d, tk.element_size())
    assert g <= 32 and (nr == 2) == (kind is None)
    got = _lane_decode(tq, tk, tv, tt, tl, tks, tvs)
    assert bool((got[0] == 0).all())
    whole, _ = _cluster_decode(tq, tk, tv, tt, tl, tks, tvs)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    jsc = {} if kind is None else dict(k_scales=jnp.asarray(ks),
                                       v_scales=jnp.asarray(vs))
    jo = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), interpret=True, **jsc))
    np.testing.assert_allclose(got.numpy(), jo, **TOL)


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
    (64, 16, 256, 4, (128, 8)),   # GPT-J's head, float32: a trip is 16
    (64, 16, 256, 2, (128, 8)),   # bf16: a trip is 32
    (64, 16, 256, 1, (128, 8)),   # int8/fp8: a trip is 64, not 256
    (64, 16, 136, 1, (128, 8)),   # 8-byte int8 runs, 32 lanes: a trip is 32
    (128, 16, 256, 4, (256, 8)),  # 2048 tokens at 256: the chunk grows
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
