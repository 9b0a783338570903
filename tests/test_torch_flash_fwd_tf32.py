"""PyTorch port, the float32 flash-attention forward kernel's arithmetic on
the CPU: ``csrc/flash_fwd.cu``'s ``flash_fwd_tf32_kernel`` runs both
products on the tensor cores in 3xTF32 (``csrc/mma_tf32.cuh``). Emulated
here in PyTorch (tests/tf32_emulation.py for the rounding and the
products), block by block as the kernel walks:

- 64-row query blocks, each walking its key tiles in order (64 keys, 32
  above head_dim 64), up to the causal diagonal of the block;
- S = Q K^T in 3xTF32 k-steps of 8 over head_dim, scores pre-scaled by
  scale*log2(e) into the exp2 domain, masked to NEG_INF*log2(e)
  (causal-excluded, padded) or -inf (past the ragged edge);
- the running max m and sum l in float32, alpha = exp2(m_old - m_new)
  rescaling l and the O accumulator before the tile's P V;
- P = exp2(x - m) kept float32 (not rounded), split for P V, which adds
  into the rescaled accumulator k-step by k-step of 8 over the tile's keys;
- the padded-tile skip: with a key mask, a block whose rows all attend a
  live key (one at or before its first row if causal, anywhere if not)
  skips key tiles all of padding and ends its walk with the tile of the
  row's last live key; otherwise it visits every tile;
- O = acc / max(l, 1e-30) and lse = m*ln(2) + log(max(l, 1e-30)), NEG_INF
  itself for a row with no live key.

Against the JAX package's Pallas forward in interpret mode
(``_flash_pallas_forward(..., interpret=True, with_lse=True)``, one block
over the whole sequence) on numpy-seeded float32 inputs: causal, a ragged
S, and non-causal with padded keys where one batch row is all padding, at
head_dim 8, 64 and 72.

Tolerances. O and lse within 2e-6 absolute of JAX's (|O| <= ~4.3, |lse|
<= ~6.3; observed 3.3e-7 to 1.3e-6 for O, 4.8e-7 to 9.5e-7 for lse, the
all-padding row's NEG_INF exact; the same recurrence unrounded lands
2.4e-7 to 8.3e-7 off, and 1.1e-6 off the port's plain attention: both
sides are float32-accurate and sum in other orders). One TF32 product
alone (big_a * big_b, both products) lands at least 10x further off
(observed 4.7e-4 to 1.0e-3 for O, past the card tests' 1e-4): why the
kernel takes three. The skip changes no bit against the same emulation
without it, and the all-padding row equals the plain mean of its values
within 1e-6 (observed 3.7e-8).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu_torch.ops import attention_reference
from sparkflow_tpu_torch.ops.attention import NEG_INF
from tf32_emulation import LOG2E, product

TOL = 2e-6
ONE_TF32_FACTOR = 10.0
B, H = 2, 2
BLOCK_M = 64
LN2 = 0.6931471805599453
# NEG_INF in the exp2 domain, as the kernel's constexpr float product
MASKED = float(torch.tensor(NEG_INF, dtype=torch.float32)
               * torch.tensor(LOG2E, dtype=torch.float32))


def _tile_keys(d):
    return 64 if d <= 64 else 32


def _ntiles(q0, s, sk, bn, causal):
    """Key tiles a block of query rows from ``q0`` walks at most: every
    one, or up to the causal diagonal of its last row."""
    n = -(-sk // bn)
    return min(n, (min(q0 + BLOCK_M, s) - 1) // bn + 1) if causal else n


def _walk(mask_row, q0, ntiles, bn, sk, causal, skip):
    """The key tiles one block visits for one batch row (``mask_row`` [Sk]
    or None), in order."""
    tiles = list(range(ntiles))
    if mask_row is None or not skip:
        return tiles
    live = (mask_row[:min(sk, ntiles * bn)] > 0).nonzero().flatten()
    lim = min(q0 + 1, sk) if causal else sk
    if not bool((live < lim).any()):
        return tiles          # a row attends no live key: every tile
    last = int(live.max())
    return [t for t in tiles[:last // bn + 1]
            if bool((mask_row[t * bn:min((t + 1) * bn, sk)] > 0).any())]


def tf32_forward(q, k, v, causal, scale, mask, mode="3x", skip=True):
    """The float32 forward kernel's arithmetic: ``(O, lse)`` from [B,H,S,D]
    float32 q/k/v and an optional [B,S_k] key mask, both products in
    3xTF32 (or as ``mode`` says, see :func:`tf32_emulation.product`)."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    bn = _tile_keys(d)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    nt_all = -(-sk // bn)
    # zero-filled past S_k, as the kernel's tiles are
    kp = torch.nn.functional.pad(k, (0, 0, 0, nt_all * bn - sk))
    vp = torch.nn.functional.pad(v, (0, 0, 0, nt_all * bn - sk))
    out = torch.empty(b, h, s, d)
    lse = torch.empty(b, h, s)
    for q0 in range(0, s, BLOCK_M):
        qb = q[:, :, q0:q0 + BLOCK_M]
        rows = q0 + torch.arange(qb.shape[2])
        ntiles = _ntiles(q0, s, sk, bn, causal)
        walks = [_walk(None if mask is None else mask[i], q0, ntiles, bn, sk,
                       causal, skip) for i in range(b)]
        m = torch.full((b, h, qb.shape[2]), MASKED)
        l = torch.zeros(b, h, qb.shape[2])
        acc = torch.zeros(b, h, qb.shape[2], d)
        for t in range(ntiles):
            visit = torch.tensor([t in w for w in walks])[:, None, None]
            if not bool(visit.any()):
                continue
            k0 = t * bn
            cols = k0 + torch.arange(bn)
            x = product(qb, kp[:, :, k0:k0 + bn].transpose(-1, -2), mode) * sl2
            drop = torch.zeros(b, 1, qb.shape[2], bn, dtype=torch.bool)
            if causal:
                drop = drop | (cols[None, :] > rows[:, None])
            if mask is not None:
                mt = torch.nn.functional.pad(mask, (0, nt_all * bn - sk))
                drop = drop | ~(mt[:, None, None, k0:k0 + bn] > 0)
            x = torch.where(drop, MASKED, x)
            x = torch.where(cols >= sk, -math.inf, x)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l_new = l * alpha + p.sum(-1)
            acc_new = product(p, vp[:, :, k0:k0 + bn], mode,
                              acc=acc * alpha[..., None])
            m = torch.where(visit, mx, m)
            l = torch.where(visit, l_new, l)
            acc = torch.where(visit[..., None], acc_new, acc)
        den = torch.clamp(l, min=1e-30)
        out[:, :, q0:q0 + BLOCK_M] = acc / den[..., None]
        lse[:, :, q0:q0 + BLOCK_M] = torch.where(
            m == MASKED, NEG_INF, m * LN2) + torch.log(den)
    return out, lse


def _inputs(seed, s, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, s, d).astype(np.float32) for _ in range(3)]


def _mask(s, first_pad):
    if first_pad is None:
        return None
    mask = np.ones((B, s), np.float32)
    for i, first in enumerate(first_pad):
        mask[i, first:] = 0.0
    return mask


CASES = {
    # causal over a sequence of two 64-row blocks
    "causal": dict(s=128, causal=True, first_pad=None),
    # padded keys, non-causal; batch row 1's keys are all padding
    "padded": dict(s=128, causal=False, first_pad=(77, 0)),
    # a ragged S (not a multiple of the tiles or of 8), causal, with a
    # padded tail
    "ragged": dict(s=100, causal=True, first_pad=(100, 61)),
}


@pytest.mark.parametrize("d", [8, 64, 72])
@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_forward_matches_jax_pallas(case, d):
    c = CASES[case]
    s, causal = c["s"], c["causal"]
    q, k, v = _inputs(d + s + causal, s, d)
    mask = _mask(s, c["first_pad"])
    scale = 1.0 / math.sqrt(d)
    want_o, want_lse = jattn._flash_pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal, scale, s, s,
        True, with_lse=True)
    want_o, want_lse = np.asarray(want_o), np.asarray(want_lse)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    errs = {}
    for mode in ("3x", "1x"):
        o, lse = tf32_forward(*args, causal, scale, tm, mode)
        errs[mode] = (float(np.abs(o.numpy() - want_o).max()),
                      float(np.abs(lse.numpy() - want_lse).max()))
    (e3, el3), (e1, _) = errs["3x"], errs["1x"]
    assert e3 <= TOL and el3 <= TOL, errs["3x"]
    assert e1 >= ONE_TF32_FACTOR * e3, (e1, e3)


@pytest.mark.parametrize("d", [136, 256])
@pytest.mark.parametrize("case", ["causal", "padded"])
def test_3xtf32_wide_head_forward_matches_jax_pallas(case, d):
    """The layout of the float32 forward's instantiations above head_dim
    128: head_dim zero-padded to a multiple of 32 (cp.async's zero fill;
    136 -> 160: the zero k-steps add nothing), 32-key tiles, Q split again
    from shared memory at each tile, the padded output columns not stored;
    against the JAX Pallas forward at head_dim 136 and 256 (GPT-J-6B's).

    The bar is TOL scaled by sqrt(head_dim / 64), 4e-6 at 256: each score
    and output sums head_dim or more float32 terms, and the same recurrence
    with no TF32 rounding at all lands 2.4e-6 from JAX at head_dim 256
    (1.5e-6 at 136, 6.6e-7 at 64): the summation order, not the 3xTF32
    products, sets it. One TF32 product stays at least 10x further off."""
    c = CASES[case]
    s, causal = c["s"], c["causal"]
    q, k, v = _inputs(d + s + causal, s, d)
    mask = _mask(s, c["first_pad"])
    scale = 1.0 / math.sqrt(d)
    want_o, want_lse = jattn._flash_pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal, scale, s, s,
        True, with_lse=True)
    pad = -d % 32
    args = [torch.nn.functional.pad(torch.from_numpy(x), (0, pad))
            for x in (q, k, v)]
    assert _tile_keys(d + pad) == 32
    tm = None if mask is None else torch.from_numpy(mask)
    tol = TOL * math.sqrt(d / 64)
    errs = {}
    for mode in ("3x", "1x"):
        o, lse = tf32_forward(*args, causal, scale, tm, mode)
        errs[mode] = (float(np.abs(o[..., :d].numpy()
                                   - np.asarray(want_o)).max()),
                      float(np.abs(lse.numpy() - np.asarray(want_lse)).max()))
    (e3, el3), (e1, _) = errs["3x"], errs["1x"]
    assert e3 <= tol and el3 <= tol, errs["3x"]
    assert e1 >= ONE_TF32_FACTOR * e3, (e1, e3)


SKIP_CASES = {
    # padded tails, one row all padding: tiles skipped and walks cut short
    "padded": dict(s=200, d=64, causal=False, first_pad=(77, 0)),
    # causal, ragged, a padded tail at head_dim 72 (32-key tiles)
    "ragged": dict(s=150, d=72, causal=True, first_pad=(150, 40)),
    # causal with leading padding: the first block's rows attend no live
    # key, so it may not skip (its rows average their visited keys)
    "leading": dict(s=192, d=64, causal=True, first_pad=None, lead=100),
}


@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_padded_tile_skip_changes_no_bit(case):
    c = SKIP_CASES[case]
    s, d, causal = c["s"], c["d"], c["causal"]
    q, k, v = (torch.from_numpy(x) for x in _inputs(11 + s, s, d))
    if c["first_pad"] is not None:
        mask = torch.from_numpy(_mask(s, c["first_pad"]))
    else:
        mask = torch.ones(B, s)
        mask[1, :c["lead"]] = 0
        mask[0, 130:170] = 0
    scale = 1.0 / math.sqrt(d)
    with_skip = tf32_forward(q, k, v, causal, scale, mask, skip=True)
    without = tf32_forward(q, k, v, causal, scale, mask, skip=False)
    assert torch.equal(with_skip[0], without[0])
    assert torch.equal(with_skip[1], without[1])
    # the skip did happen: some block's walk left out a tile
    bn = _tile_keys(d)
    nt = [_ntiles(q0, s, s, bn, causal) for q0 in range(0, s, BLOCK_M)]
    assert any(len(_walk(mask[i], q0, n, bn, s, causal, True)) < n
               for i in range(B)
               for q0, n in zip(range(0, s, BLOCK_M), nt))


def test_all_padding_row_averages_uniformly():
    s, d = 130, 64
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, s, d))
    mask = torch.ones(B, s)
    mask[0, 90:] = 0
    mask[1] = 0
    o, lse = tf32_forward(q, k, v, False, 0.125, mask)
    want = v[1].mean(-2, keepdim=True).expand(H, s, d)
    assert float((o[1] - want).abs().max()) <= 1e-6
    assert bool((lse[1] == NEG_INF).all())
    assert bool((lse[0] > -1e3).all())


def test_emulation_without_rounding_is_the_plain_forward():
    """With the TF32 rounding taken out (``mode="float32"``), the
    emulation's recurrence is the port's plain float32 attention: the test
    checks the kernel's recurrence, not only its rounding."""
    s, d = 150, 64
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, s, d))
    mask = torch.ones(B, s)
    mask[1, 40:] = 0
    for causal in (True, False):
        o, lse = tf32_forward(q, k, v, causal, 0.125, mask, "float32")
        want_o, want_lse = attention_reference(q, k, v, causal, 0.125,
                                               kv_mask=mask, return_lse=True)
        assert float((o - want_o).abs().max()) <= TOL
        assert float((lse - want_lse).abs().max()) <= TOL
