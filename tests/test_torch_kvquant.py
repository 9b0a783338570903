"""PyTorch port, quantized KV (int8 / fp8 e4m3): the port's KV-quantization
helpers, the paged kernels' plain versions over quantized pools, the
quantized dense decode cache and the ``DecodeEngine(kv_quant=)``, against
the JAX package on the same numpy-drawn inputs (the JAX Pallas kernels in
interpret mode).

Tolerances: quantized rows bit-equal (both sides round half to even, and
fp8 clamps to +-448 before its round-to-nearest-even cast), scales within
1e-7 (one float32 absmax division); attention 2e-5 in float32 (both sides
accumulate in float32, only the summation order differs); decode logits
1e-4; greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import (CFG, NEW, PAGE, PROMPTS, SYS, _drive,
                               _run_all, jax_model, numpy_params, to_torch,
                               torch_model)
from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.utils import quant as jquant
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.ops import (last_attention_path, paged_attention,
                                     paged_attention_reference)
from sparkflow_tpu_torch.serving import DecodeEngine
from sparkflow_tpu_torch.utils import quant

TOL = dict(atol=2e-5, rtol=2e-5)
KINDS = ["int8", "fp8"]


def bits(t: torch.Tensor) -> np.ndarray:
    """Stored rows as raw bytes, for bit-equality."""
    return t.contiguous().view(torch.uint8).numpy()


def jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _pages(seed, shape, zero_head=True):
    rs = np.random.RandomState(seed)
    p = (rs.randn(*shape) * rs.uniform(0.1, 4.0, shape[:1] + (1,) * (
        len(shape) - 1))).astype(np.float32)
    if zero_head:
        p[1, :, 2] = 0.0            # a page-head never written: scale 0
    return p


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_and_dequantize_match_jax(kind):
    p = _pages(0, (5, PAGE, 4, 16))
    jq, js = jquant.quantize_kv_pages(jnp.asarray(p), kind)
    tq, ts = quant.quantize_kv_pages(torch.from_numpy(p), kind)
    assert tq.dtype == quant.kv_pool_dtype(kind)[0]
    np.testing.assert_array_equal(bits(tq), jbits(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert float(ts[1, 2]) == 0.0
    deq = quant.dequantize_kv_pages(tq, ts)
    assert torch.all(deq[1, :, 2] == 0)
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(jquant.dequantize_kv_pages(jq, js)),
        rtol=1e-7, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_pool_writes_and_appends_match_jax(kind):
    """Whole-page writes, then appends: into a written page with a larger
    absmax (the page rescales in place), at offset 0 of a used page (the
    running max resets), several rows into one page, masked lanes aimed at
    scratch page 0, and a [B, S] verify grid."""
    store, _ = quant.kv_pool_dtype(kind)
    jstore, _ = jquant.kv_pool_dtype(kind)
    L, P, h, d = 2, 7, 4, 16
    jq = jnp.zeros((L, P, PAGE, h, d), jstore)
    js = jnp.zeros((L, P, h), jnp.float32)
    tq = torch.zeros((L, P, PAGE, h, d), dtype=store)
    ts = torch.zeros((L, P, h))
    rs = np.random.RandomState(1)
    pages = _pages(2, (3, PAGE, h, d))
    ids = np.array([1, 2, 3], np.int32)
    jq, js = jquant.paged_quant_write_pages(jq, js, 1, jnp.asarray(ids),
                                           jnp.asarray(pages))
    quant.paged_quant_write_pages(tq, ts, 1, torch.from_numpy(ids),
                                  torch.from_numpy(pages))
    appends = [
        (np.array([1, 3, 3, 4]), np.array([5, 0, 1, 0]), 6.0),
        (np.array([0, 0, 0, 2]), np.array([0, 0, 0, 7]), 1.0),
        (np.array([[4, 4, 5], [2, 5, 5]]), np.array([[1, 2, 0], [3, 1, 2]]),
         2.0),
    ]
    for pids, offs, mag in appends:
        rows = (rs.randn(*pids.shape, h, d) * mag).astype(np.float32)
        jq, js = jquant.paged_quant_append(
            jq, js, 1, jnp.asarray(pids, jnp.int32),
            jnp.asarray(offs, jnp.int32), jnp.asarray(rows))
        quant.paged_quant_append(tq, ts, 1, torch.from_numpy(pids),
                                 torch.from_numpy(offs),
                                 torch.from_numpy(rows))
        # scratch page 0 takes several masked rows at one offset: its rows
        # hold an arbitrary one of them on either side; every other page
        # and every scale must agree
        np.testing.assert_array_equal(bits(tq[:, 1:]), jbits(jq[:, 1:]))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                                   atol=0)
    gid = np.array([[1, 3], [5, 2]], np.int32)
    np.testing.assert_allclose(
        quant.paged_quant_gather(tq, ts, 1, torch.from_numpy(gid)).numpy(),
        np.asarray(jquant.paged_quant_gather(jq, js, 1, jnp.asarray(gid))),
        rtol=1e-7, atol=0)


def _quant_case(kind, page, seed):
    """Random paged operands (ragged lengths incl. an empty slot, an
    aliased page) with JAX-quantized pools, as numpy."""
    rs = np.random.RandomState(seed)
    b, h, d, maxp = 5, 4, 16, 4
    lengths = np.array([page + 3, 2 * page, 0, 1, maxp * page], np.int32)
    num_pages = 1 + b * maxp
    q = rs.randn(b, h, d).astype(np.float32)
    k = _pages(seed + 1, (num_pages, page, h, d))
    v = _pages(seed + 2, (num_pages, page, h, d))
    table = np.zeros((b, maxp), np.int32)
    ids = list(range(1, num_pages))
    rs.shuffle(ids)
    table[:] = np.array(ids[:b * maxp]).reshape(b, maxp)
    table[4, 0] = 1                  # slot 4 reads the scale-0 page-head
    table[1, 0] = table[0, 0]        # aliased page
    jk, jks = jquant.quantize_kv_pages(jnp.asarray(k), kind)
    jv, jvs = jquant.quantize_kv_pages(jnp.asarray(v), kind)
    return q, jk, jks, jv, jvs, table, lengths


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_paged_attention_quant_matches_jax_pallas(kind, page):
    q, jk, jks, jv, jvs, table, lens = _quant_case(kind, page, page)
    jo = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lens),
        interpret=True, k_scales=jks, v_scales=jvs))
    to = paged_attention(torch.from_numpy(q), to_torch(jk), to_torch(jv),
                         torch.from_numpy(table), torch.from_numpy(lens),
                         k_scales=to_torch(jks), v_scales=to_torch(jvs))
    assert last_attention_path() == "reference"
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    assert np.all(to.numpy()[2] == 0.0)


def test_paged_attention_scales_both_or_neither():
    q, jk, jks, jv, jvs, table, lens = _quant_case("int8", PAGE, 3)
    args = (torch.from_numpy(q), to_torch(jk), to_torch(jv),
            torch.from_numpy(table), torch.from_numpy(lens))
    with pytest.raises(ValueError, match="both"):
        paged_attention(*args, k_scales=to_torch(jks))
    with pytest.raises(ValueError, match="both"):
        paged_attention_reference(*args, v_scales=to_torch(jvs))


@pytest.mark.parametrize("kind", KINDS)
def test_dense_quant_cache_decode_matches_jax(kind):
    """The dense decode cache with int8/fp8 rows and per-token scales."""
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=4)
    tm = torch_model()
    tp = params_from_jax(tm, npp)
    jp = jax.tree.map(jnp.asarray, npp)
    jc = jm.init_decode_cache(2, 16, kv_dtype=kind)
    tc = tm.init_decode_cache(2, 16, kv_dtype=kind)
    assert tc["k"].dtype == quant.kv_pool_dtype(kind)[0]
    toks = [[3, 9], [17, 4], [5, 5], [60, 1]]
    for i, tok in enumerate(toks):
        pos = np.array([i, i + 2], np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, tc, torch.tensor(tok),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(tc["k_scale"].numpy(),
                               np.asarray(jc["k_scale"]), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def weights():
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=2)
    tm = torch_model()
    return jm, jax.tree.map(jnp.asarray, npp), tm, params_from_jax(tm, npp)


@pytest.fixture(scope="module", params=[("int8", None), ("int8", 8),
                                        ("fp8", None), ("fp8", 8)],
                ids=["int8-ladder", "int8-chunk8", "fp8-ladder",
                     "fp8-chunk8"])
def jax_engine(request, weights):
    jm, jp, _, _ = weights
    kind, chunk = request.param
    eng = JaxDecodeEngine(jm, jp, num_slots=4, page_size=PAGE, seed=0,
                          prefill_chunk=chunk, kv_quant=kind)
    return kind, chunk, _run_all(eng), eng.stats()


def test_quant_engine_greedy_tokens_identical_to_jax(jax_engine, weights):
    kind, chunk, want, jst = jax_engine
    _, _, tm, tp = weights
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       prefill_chunk=chunk, kv_quant=kind)
    got = _run_all(eng)
    assert got == want
    assert len({tuple(t) for t in got}) > 3
    st = eng.stats()
    assert st["kv_quant"] == kind
    assert st["kv"]["pages_used"] == 0 and st["kv"]["slots_active"] == 0
    assert st["kv"]["prefix_hits"] >= 1
    assert abs(st["kv_quant_error"] - jst["kv_quant_error"]) < 1e-4


def test_quant_engine_stats_bytes_and_error_probe(weights):
    _, _, tm, tp = weights
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0,
                       kv_quant="int8")
    st = eng.stats()
    h, hd, L = CFG["num_heads"], CFG["hidden"] // CFG["num_heads"], \
        CFG["num_layers"]
    assert st["kv"]["kv_bytes_per_page"] == 2 * L * (PAGE * h * hd + h * 4)
    assert st["kv"]["kv_dtype"] == "int8"
    assert 0.0 <= st["kv_quant_error"] < 0.05
    assert eng.metrics.summary()["gauges"]["decode/kv_quant_error"] == \
        st["kv_quant_error"]
    pools = eng._k_pool
    assert pools[0].dtype == torch.int8 and pools[1].dtype == torch.float32
    assert st["parallel"]["kv_bytes_per_device"] == 2 * (
        pools[0].numel() + pools[1].numel() * 4)
    toks, _ = _drive(eng, SYS + [17, 18], NEW)
    assert len(toks) == NEW and eng.stats()["kv"]["pages_used"] == 0
    cold = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0,
                        kv_quant="fp8", warmup=False)
    assert cold.stats()["kv_quant_error"] is None


def test_quant_engine_rejects_unknown_layout_like_jax(weights):
    jm, jp, tm, tp = weights
    with pytest.raises(ValueError) as want:
        JaxDecodeEngine(jm, jp, num_slots=2, page_size=PAGE,
                        kv_quant="int4", warmup=False)
    with pytest.raises(ValueError) as got:
        DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, kv_quant="int4")
    assert str(got.value) == str(want.value)
    assert "kv_quant must be one of" in str(got.value)


def test_copy_pages_clones_rows_and_scales(weights):
    """The rollback COW copy moves a page's quantized rows and its scales."""
    _, _, tm, tp = weights
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0,
                       kv_quant="int8", warmup=False)
    _drive(eng, PROMPTS[1], 2)       # fills a few pages and their scales
    written = eng._k_pool[1][0].abs().sum(-1) > 0          # [pages]
    written[0] = True                                      # scratch page
    src = int(torch.nonzero(written)[1])
    dst = int(torch.nonzero(~written)[-1])
    with torch.inference_mode():
        eng._copy_pages(src, dst)
    for rows, scales in (eng._k_pool, eng._v_pool):
        assert torch.any(scales[:, src] != 0)
        assert torch.equal(rows[:, dst], rows[:, src])
        assert torch.equal(scales[:, dst], scales[:, src])
