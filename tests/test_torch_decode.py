"""PyTorch port, decode serving: the port's DecodeEngine (plain attention on
the CPU) against the JAX package's DecodeEngine (Pallas kernels in
interpret mode) on the same numpy-drawn weights — greedy tokens must be
identical — plus the port's own engine contract: page accounting, chunked
prefill cadence, prefix hits, seeded sampling, hot swap and the options that
are not ported yet (speculation and quantized KV: test_torch_spec.py,
test_torch_kvquant.py)."""

import jax
import jax.numpy as jnp
import pytest

from test_torch_shared import (CFG, NEW, PAGE, PROMPTS, SYS, _drive,
                               _run_all, jax_model, numpy_params,
                               torch_model)
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                         OutOfPages)


@pytest.fixture(scope="module")
def weights():
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=2)
    return jm, jax.tree.map(jnp.asarray, npp), npp


@pytest.fixture(scope="module")
def torch_lm(weights):
    tm = torch_model()
    return tm, params_from_jax(tm, weights[2])


@pytest.fixture(scope="module", params=[None, 8], ids=["ladder", "chunk8"])
def jax_tokens(request, weights):
    jm, jp, _ = weights
    eng = JaxDecodeEngine(jm, jp, num_slots=4, page_size=PAGE, seed=0,
                          prefill_chunk=request.param)
    return request.param, _run_all(eng)


def test_greedy_tokens_identical_to_jax_engine(jax_tokens, torch_lm):
    chunk, want = jax_tokens
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       prefill_chunk=chunk)
    got = _run_all(eng)
    assert got == want
    assert len({tuple(t) for t in got}) > 3, "weights decode to one token"
    st = eng.stats()
    assert st["kv"]["pages_used"] == 0 and st["kv"]["slots_active"] == 0
    assert st["kv"]["prefix_hits"] >= 1
    assert st["steady_traces"] == 0 and st["pending_prefills"] == 0


def test_prefix_replay_shares_pages(torch_lm):
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0)
    cold, info0 = _drive(eng, SYS + [17, 18], NEW)
    hot, info1 = _drive(eng, SYS + [17, 18], NEW)
    assert info0["shared_tokens"] == 0 and info1["shared_tokens"] == PAGE
    assert cold == hot
    off = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0,
                       prefix_cache=False)
    assert _drive(off, SYS + [17, 18], NEW)[0] == cold


def test_chunked_prefill_keeps_decode_cadence(torch_lm):
    """A long prompt admitted mid-stream advances one chunk per step while
    the in-flight request emits a token on every step."""
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       prefill_chunk=8)
    a = eng.prefill([1, 2, 3], max_new_tokens=12)
    b = eng.prefill(list(range(1, 25)), max_new_tokens=4)
    assert b["token"] is None and b["chunked"]
    first_b = None
    for i in range(6):
        out = eng.step()
        assert a["slot"] in out
        if b["slot"] in out and first_b is None:
            first_b = i
    assert first_b == 2   # 24 prompt tokens / chunk 8 -> 3 steps
    eng.release(a["slot"])
    eng.release(b["slot"])
    assert eng.kv.stats()["pages_used"] == 0


def test_seeded_sampling_repeats_and_greedy_is_default(torch_lm):
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0)

    def sample(seed):
        info = eng.prefill([4, 4, 9], max_new_tokens=8, temperature=1.0,
                           top_k=8, seed=seed)
        toks = [info["token"]]
        while len(toks) < 8:
            toks.extend(eng.step().get(info["slot"], []))
        eng.release(info["slot"])
        return toks

    a, b, c = sample(123), sample(123), sample(7)
    assert a == b
    assert all(0 <= t < CFG["vocab_size"] for t in a + c)
    assert a != c


def test_batcher_mixed_lengths_match_engine(torch_lm):
    tm, tp = torch_lm
    ref_eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0)
    want = [_drive(ref_eng, p, n)[0] for p, n in zip(PROMPTS, (3, 7, 2, 9, 5, 4))]
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0)
    cb = ContinuousBatcher(eng, max_queue=32)
    try:
        futs = [cb.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, (3, 7, 2, 9, 5, 4))]
        got = [f.result(timeout=120) for f in futs]
    finally:
        cb.close()
    assert [r["tokens"] for r in got] == want
    assert all(r["finish_reason"] == "length" for r in got)
    assert eng.kv.stats()["pages_used"] == 0


def test_admission_bounds_and_backpressure(torch_lm):
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=1, page_size=PAGE, seed=0)
    assert eng.can_admit(2, 4)
    assert not eng.can_admit(eng.max_prompt_len + 1, 1)
    assert not eng.can_admit(2, eng.max_seq_len)
    info = eng.prefill([1, 2], max_new_tokens=2)
    with pytest.raises(OutOfPages):
        eng.prefill([3], max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.prefill([], max_new_tokens=2)
    eng.release(info["slot"])


def test_swap_params_defers_until_drained(torch_lm, weights):
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0)
    before = _drive(eng, [5, 2, 8], NEW)[0]
    other = numpy_params(tm.param_specs(), seed=9)
    info = eng.prefill([1, 2, 3], max_new_tokens=4)
    assert eng.swap_params(other, version=3) is False   # a slot is live
    assert eng.stats()["pending_swap"]
    eng.release(info["slot"])
    assert eng.maybe_swap() and eng.serving_version() == 3
    after = _drive(eng, [5, 2, 8], NEW)[0]
    cold = DecodeEngine(tm, params_from_jax(tm, other), num_slots=2,
                        page_size=PAGE, seed=0)
    assert after == _drive(cold, [5, 2, 8], NEW)[0]
    assert after != before
    bad = numpy_params(tm.param_specs(), seed=9)
    bad["embed"]["tok"] = bad["embed"]["tok"][:-1]
    with pytest.raises(ValueError):
        eng.swap_params(bad)


@pytest.mark.parametrize("kw", [
    {"mesh": {"ep": 2}, "sharding": {"ep_axis": "ep"}},
    {"mesh": {"pp": 2}, "sharding": {"pp_axis": "pp"}, "num_slots": 3},
    {"mesh": {"pp": 2}, "sharding": {"pp_axis": "pp"}, "num_slots": 3,
     "pp_wave": False}])
def test_unported_engine_options_raise(torch_lm, kw):
    # tp and pp decode are ported (tests/test_torch_{tp,pp}_serving.py); ep
    # is not. A pp engine's waves split the slots into pp equal waves, so
    # num_slots=3 is refused with JAX's message; pp_wave=False stands that
    # rule down and serves the single-wave step
    tm, tp = torch_lm
    kw = dict({"num_slots": 2, "page_size": PAGE}, **kw)
    if kw.get("pp_wave") is False:
        eng = DecodeEngine(tm, tp, seed=0, **kw)
        plain = DecodeEngine(tm, tp, num_slots=3, page_size=PAGE, seed=0)
        assert _drive(eng, [5, 2, 8], NEW)[0] == _drive(plain, [5, 2, 8],
                                                        NEW)[0]
        assert eng.stats()["parallel"]["pp_wave"] is False
        return
    match = ("ROADMAP.md" if "ep" in kw["mesh"]
             else "num_slots=3 is not divisible by pp=2")
    with pytest.raises(ValueError, match=match):
        DecodeEngine(tm, tp, **kw)


def test_executable_dir_reports_cold_start(torch_lm, tmp_path):
    """``executable_dir`` is accepted; on the CPU no library loads, tokens
    do not move, and ``stats()["cold_start"]`` has the JAX keys."""
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0,
                       executable_dir=str(tmp_path))
    plain = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0)
    assert _drive(eng, [5, 2, 8], NEW)[0] == _drive(plain, [5, 2, 8], NEW)[0]
    cs = eng.stats()["cold_start"]
    assert {"dir", "serialized_loads", "serialized_saves"} <= set(cs)
    assert cs["dir"] == str(tmp_path) and cs["source"] == "cpu"
    assert cs["tier"] is None and plain.stats()["cold_start"] is None


def test_engine_stats_carry_server_keys(torch_lm):
    tm, tp = torch_lm
    st = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE).stats()
    for key in ("num_slots", "prefill_buckets", "max_seq_len", "kv",
                "steady_traces", "spec", "parallel", "kv_quant"):
        assert key in st
    assert st["prefill_buckets"] == [8, 16, 32, 64]
    assert st["kv"]["kv_bytes_per_page"] == (
        2 * CFG["num_layers"] * PAGE * CFG["hidden"] * 4)
    assert st["device"] == "cpu"
