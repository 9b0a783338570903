"""PyTorch port at head_dim above 128 (up to 256, GPT-J-6B's head): the
forward, decode and verify kernels' plain versions against the JAX Pallas
kernels in interpret mode at head_dim 136 and 256, the decode kernel's lane
layout and split at those widths, and a transformer_lm whose heads are 256
wide (hidden 512, 2 heads) against the JAX package: prefill and decode-step
logits, the ``DecodeEngine``'s greedy tokens over a plain pool, an int8
pool and self-speculation, and one request through ``/v1/generate``.

Inputs and weights are drawn with numpy from fixed seeds and handed to both
packages; dropout is off.

Tolerances: the plain versions against the Pallas kernels in interpret
mode 2e-5 absolute and relative, in float32 (both sides compute in float32
from the same values; only the order of the sums differs); logits 1e-4 (the
model's float32 forward, as in test_torch_models.py); greedy tokens
identical.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged import decode_layout as _kernel_layout
from test_torch_shared import numpy_params, to_torch
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.utils import quant as jquant
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.ops import (attention_reference,
                                     paged_attention_reference,
                                     paged_attention_verify_reference)
from sparkflow_tpu_torch.ops.attention import (DECODE_CHUNK, _decode_trip,
                                               _paged_split)
from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                         InferenceServer, ServingClient)

TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
WIDE = (136, 256)          # padded to 160 in the forward kernels; GPT-J's
PAGE = 16


# -- the forward kernel's plain version --------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["causal", "masked"])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", WIDE)
def test_flash_forward_plain_matches_jax_pallas(d, s, masked):
    """O and the logsumexp, causal, or non-causal over padded keys with one
    batch row all padding (its output the uniform average, as in JAX)."""
    rs = np.random.RandomState(d + s + masked)
    q, k, v = (rs.randn(2, 2, s, d).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((2, s), np.float32)
        mask[0, s - 45:] = 0.0
        mask[1] = 0.0
    causal = not masked
    scale = 1.0 / math.sqrt(d)
    want_o, want_lse = jattn._flash_pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal, scale, s, s,
        True, with_lse=True)
    got_o, got_lse = attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, scale,
        kv_mask=None if mask is None else torch.from_numpy(mask),
        return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


# -- the decode and verify kernels' plain versions ---------------------------

def _pool_case(seed, d, kind, b=4, h=2, maxp=6):
    """Pools (JAX-quantized when ``kind``, one page-head of scale 0), a
    table with an aliased page and slot 0 on scratch page 0."""
    rs = np.random.RandomState(seed)
    num_pages = 1 + b * maxp
    k = rs.randn(num_pages, PAGE, h, d).astype(np.float32)
    v = rs.randn(num_pages, PAGE, h, d).astype(np.float32)
    ids = list(range(1, num_pages))
    rs.shuffle(ids)
    table = np.array(ids[:b * maxp], np.int32).reshape(b, maxp)
    table[2, 0] = table[1, 0]                 # a shared prefix page
    jk, jv, jks, jvs = jnp.asarray(k), jnp.asarray(v), None, None
    if kind is not None:
        k[table[3, 1], :, 1] = 0.0
        jk, jks = jquant.quantize_kv_pages(jnp.asarray(k), kind)
        jv, jvs = jquant.quantize_kv_pages(jnp.asarray(v), kind)
    return rs, jk, jv, jks, jvs, table


def _scales(jks, jvs):
    if jks is None:
        return {}, {}
    return (dict(k_scales=jks, v_scales=jvs),
            dict(k_scales=to_torch(jks), v_scales=to_torch(jvs)))


@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["plain", "int8", "fp8"])
@pytest.mark.parametrize("d", WIDE)
def test_paged_decode_plain_matches_jax_pallas(d, kind):
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
@pytest.mark.parametrize("d", WIDE)
def test_paged_verify_plain_matches_jax_pallas(d, kind):
    s = 5
    rs, jk, jv, jks, jvs, table = _pool_case(d + 1, d, kind)
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


# -- the decode kernel's lane layout and split -------------------------------

@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("d", list(range(8, 257, 8)))
def test_decode_lane_layout_covers_the_row(d, itemsize):
    """Every head_dim up to 256: at most 32 lanes a row, the lanes' runs
    cover the row's elements exactly once, each run is aligned and wholly
    inside the row or wholly past it, and the trip the wrapper sizes its
    chunk by is the kernel's."""
    vec, nr, g, _, trip = _kernel_layout(d, itemsize)
    assert g <= 32 and 32 % g == 0
    seen = np.zeros(d, np.int32)
    for sub in range(g):
        for r in range(nr):
            d0 = (sub + r * g) * vec
            # the run's bytes start aligned to its size in every head's
            # slice of a pool row ([..., H, D])
            assert all((h * d + d0) * itemsize % (vec * itemsize) == 0
                       for h in range(3))
            if d0 < d:
                assert d0 + vec <= d
                seen[d0:d0 + vec] += 1
    assert np.all(seen == 1)
    assert _decode_trip(d, itemsize) == trip


@pytest.mark.parametrize("itemsize,layout,split", [
    (4, (4, 2, 32, 2, 16), (128, 8)),     # float32: 32 lanes x 2 runs
    (2, (8, 1, 32, 4, 32), (128, 8)),     # bf16: 32 lanes, one run each
    (1, (16, 1, 16, 4, 64), (128, 8)),    # int8 / fp8: 16 lanes
])
def test_split_at_head_dim_256(itemsize, layout, split):
    """At D = 256 and the decode step's table (64 pages of 16): the layout
    each pool gets, and a split of 8 blocks of 128 tokens, as at D = 64 for
    a bf16 pool (an int8/fp8 trip is no longer 256 tokens)."""
    assert _kernel_layout(256, itemsize) == layout
    assert _paged_split(64, 16, 256, itemsize) == split
    chunk, blocks = split
    assert chunk >= max(DECODE_CHUNK, layout[-1])


# -- the slice: a transformer_lm of 256-wide heads ----------------------------

WIDE_LM = dict(vocab_size=512, hidden=512, num_layers=2, num_heads=2,
               mlp_dim=2048, max_len=256, dropout=0.0)
PROMPTS = [[5, 2, 8], list(range(1, 40)), [33], [300, 7, 511, 9, 12] * 4,
           list(range(100, 117))]
NEW = 6


@pytest.fixture(scope="module")
def wide():
    spec = build_registry_spec("transformer_lm", **WIDE_LM)
    jm = jax_from_json(jax_spec("transformer_lm", **WIDE_LM))
    npp = numpy_params(jm.param_specs(), seed=24, std=0.08)
    tm = model_from_json(spec, device="cpu")
    assert tm.head_dim == 256
    return jm, jax.tree.map(jnp.asarray, npp), tm, params_from_jax(tm, npp)


def test_wide_prefill_and_decode_logits_match_jax(wide):
    jm, jp, tm, tp = wide
    ids = np.random.default_rng(3).integers(
        0, WIDE_LM["vocab_size"], (2, 40)).astype(np.int32)
    lengths = np.asarray([40, 23], np.int32)
    jl, _ = jm.prefill(jp, jnp.asarray(ids), lengths=jnp.asarray(lengths))
    with torch.inference_mode():
        tl, _ = tm.prefill(tp, torch.from_numpy(ids),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jc = jm.init_decode_cache(2, max_len=16)
    tc = tm.init_decode_cache(2, max_len=16)
    with torch.inference_mode():
        for pos, t in enumerate([3, 9, 4, 1, 7, 22, 60]):
            tok = np.asarray([t, (t * 7) % 512], np.int32)
            p = np.asarray([pos, pos], np.int32)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(p))
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                    torch.from_numpy(p))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)


def _greedy(eng, prompts, n):
    out = []
    for p in prompts:
        info = eng.prefill(p, max_new_tokens=n, temperature=0.0)
        toks = [info["token"]]
        while len(toks) < n:
            toks.extend(eng.step()[info["slot"]])
        eng.release(info["slot"])
        out.append(toks[:n])
    return out


ARMS = {"plain": {}, "int8": {"kv_quant": "int8"}, "spec4": {"spec_k": 4}}


@pytest.mark.parametrize("arm", list(ARMS))
def test_wide_engine_greedy_tokens_identical_to_jax(wide, arm):
    jm, jp, tm, tp = wide
    kw = dict(num_slots=2, page_size=PAGE, seed=0, **ARMS[arm])
    want = _greedy(JaxDecodeEngine(jm, jp, **kw), PROMPTS, NEW)
    eng = DecodeEngine(tm, tp, **kw)
    got = _greedy(eng, PROMPTS, NEW)
    assert got == want
    assert len({tuple(t) for t in got}) > 2, "weights decode to one token"
    if arm == "spec4":
        assert eng.stats()["spec"]["steps"] > 0


def test_wide_generate_over_http_matches_jax(wide):
    jm, jp, tm, tp = wide
    prompt = PROMPTS[1]
    want = _greedy(JaxDecodeEngine(jm, jp, num_slots=1, page_size=PAGE,
                                   seed=0), [prompt], NEW)[0]
    eng = DecodeEngine(tm, tp, num_slots=1, page_size=PAGE, seed=0)
    srv = InferenceServer(None, generate_batcher=ContinuousBatcher(eng),
                          port=0, memory_watch=False).start()
    try:
        r = ServingClient(srv.url, timeout=60).generate(prompt,
                                                        max_new_tokens=NEW)
    finally:
        srv.stop()
    assert r["tokens"] == want and r["finish_reason"] == "length"
