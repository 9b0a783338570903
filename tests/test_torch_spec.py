"""PyTorch port, speculative decoding: ``TransformerLM.decode_verify``, the
verify kernel's plain version (plain and int8/fp8 pools) against the JAX
Pallas kernel in interpret mode, and the port's ``DecodeEngine(spec_k=)`` —
self-speculation, an external draft model, and speculation over an int8
pool — against the JAX ``DecodeEngine`` on the same numpy-drawn weights.

Tolerances: verify attention 2e-5 in float32 (both sides accumulate in
float32, only the summation order differs); verify logits 1e-4 (the
model's float32 forward, as in test_torch_models.py); greedy tokens,
acceptance counts and the engines' error messages identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import (CFG, NEW, PAGE, PROMPTS, _drive, _run_all,
                               jax_model, numpy_params, to_torch,
                               torch_model)
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.utils import quant as jquant
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.ops import (last_attention_path,
                                     paged_attention_reference,
                                     paged_attention_verify,
                                     paged_attention_verify_reference)
from sparkflow_tpu_torch.serving import ContinuousBatcher, DecodeEngine

TOL = dict(atol=2e-5, rtol=2e-5)
# the external draft: one block, same vocab, its own weights
DRAFT_CFG = dict(CFG, num_layers=1, hidden=16, num_heads=2, mlp_dim=32)


def _verify_case(seed, s, kind=None):
    """q [B,H,S,D], pools (JAX-quantized when ``kind``), a page table with
    an aliased page and ragged starts incl. 0, as numpy / JAX arrays."""
    rs = np.random.RandomState(seed)
    b, h, d, page, maxp = 4, 4, 16, PAGE, 4
    num_pages = 1 + b * maxp
    q = rs.randn(b, h, s, d).astype(np.float32)
    k = rs.randn(num_pages, page, h, d).astype(np.float32)
    v = rs.randn(num_pages, page, h, d).astype(np.float32)
    ids = list(range(1, num_pages))
    rs.shuffle(ids)
    table = np.array(ids[:b * maxp], np.int32).reshape(b, maxp)
    table[2, 0] = table[1, 0]                 # aliased page
    start = np.array([0, page - 2, 2 * page + 3, maxp * page - s], np.int32)
    if kind is None:
        return q, jnp.asarray(k), None, jnp.asarray(v), None, table, start
    k[table[3, 1], :, 1] = 0.0                # a page-head of scale 0
    jk, jks = jquant.quantize_kv_pages(jnp.asarray(k), kind)
    jv, jvs = jquant.quantize_kv_pages(jnp.asarray(v), kind)
    return q, jk, jks, jv, jvs, table, start


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["plain", "int8", "fp8"])
def test_paged_verify_matches_jax_pallas(kind, s):
    q, jk, jks, jv, jvs, table, start = _verify_case(s + 10, s, kind)
    scales = {} if kind is None else dict(k_scales=jks, v_scales=jvs)
    jo = np.asarray(jattn.paged_attention_verify(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(start),
        interpret=True, **scales))
    tsc = {n: to_torch(a) for n, a in scales.items()}
    args = (torch.from_numpy(q), to_torch(jk), to_torch(jv),
            torch.from_numpy(table), torch.from_numpy(start))
    to = paged_attention_verify(*args, **tsc)
    assert last_attention_path() == "reference"
    assert to.shape == q.shape
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    if s == 1:
        # one query row is single-query decode with lengths = start + 1
        one = paged_attention_reference(args[0][:, :, 0], *args[1:4],
                                        args[4] + 1, **tsc)
        np.testing.assert_allclose(to.numpy()[:, :, 0], one.numpy(), **TOL)


def test_paged_verify_ignores_rows_past_each_query():
    """A row beyond query s's position never moves query s's output."""
    q, jk, _, jv, _, table, start = _verify_case(5, 4)
    k, v = to_torch(jk), to_torch(jv)
    args = (torch.from_numpy(q), k, v, torch.from_numpy(table),
            torch.from_numpy(start))
    out1 = paged_attention_verify_reference(*args)
    k2, v2 = k.clone(), v.clone()
    t = int(start[1]) + 3                     # slot 1's last query position
    k2[table[1, t // PAGE], t % PAGE] = 50.0
    v2[table[1, t // PAGE], t % PAGE] = -50.0
    out2 = paged_attention_verify_reference(args[0], k2, v2, *args[3:])
    np.testing.assert_allclose(out1[1, :, :3].numpy(), out2[1, :, :3].numpy(),
                               atol=1e-6)
    assert not np.allclose(out1[1, :, 3].numpy(), out2[1, :, 3].numpy())


def _causal_chunk_mask(t, s):
    """[S, T+S]: chunk row i sees the T history rows and chunk rows <= i."""
    return np.arange(t + s)[None, :] <= (t + np.arange(s))[:, None]


def _jax_chunk_attend(hist):
    """A ``decode_verify`` attend over a dense history (``hist[layer] =
    (k, v)`` [B,H,T,D] from a prefill) followed by the chunk itself."""
    def attend(layer, q, k_new, v_new, cache, start):
        k = jnp.concatenate([hist[layer][0], k_new], 2)
        v = jnp.concatenate([hist[layer][1], v_new], 2)
        sc = jnp.einsum("bhsd,bhkd->bhsk", q, k) / np.sqrt(q.shape[-1])
        ok = _causal_chunk_mask(hist[layer][0].shape[2], q.shape[2])
        p = jax.nn.softmax(jnp.where(ok, sc, -1e30), axis=-1)
        return jnp.einsum("bhsk,bhkd->bhsd", p, v), cache
    return attend


def _torch_chunk_attend(hist):
    def attend(layer, q, k_new, v_new, cache, start):
        k = torch.cat([hist[layer][0], k_new], 2)
        v = torch.cat([hist[layer][1], v_new], 2)
        sc = torch.einsum("bhsd,bhkd->bhsk", q, k) / np.sqrt(q.shape[-1])
        ok = torch.from_numpy(_causal_chunk_mask(hist[layer][0].shape[2],
                                                 q.shape[2]))
        p = torch.softmax(torch.where(ok, sc, -1e30), dim=-1)
        return torch.einsum("bhsk,bhkd->bhsd", p, v), cache
    return attend


def test_decode_verify_logits_match_jax():
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=6)
    tm = torch_model()
    tp = params_from_jax(tm, npp)
    jp = jax.tree.map(jnp.asarray, npp)
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, CFG["vocab_size"], (2, 11)).astype(np.int32)
    chunk = rs.randint(0, CFG["vocab_size"], (2, 4)).astype(np.int32)
    start = np.array([11, 11], np.int32)
    _, jkv = jm.prefill(jp, jnp.asarray(prompt))
    jl, _ = jm.decode_verify(jp, jnp.asarray(chunk), jnp.asarray(start), None,
                             _jax_chunk_attend(jkv))
    with torch.inference_mode():
        _, tkv = tm.prefill(tp, torch.from_numpy(prompt).long())
        tl, _ = tm.decode_verify(tp, torch.from_numpy(chunk),
                                 torch.from_numpy(start), None,
                                 _torch_chunk_attend(tkv))
    assert tl.shape == (2, 4, CFG["vocab_size"]) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=2)
    tm = torch_model()
    djm = jax_from_json(jax_spec("transformer_lm", **DRAFT_CFG))
    dnp = numpy_params(djm.param_specs(), seed=7)
    return dict(jm=jm, jp=jax.tree.map(jnp.asarray, npp), tm=tm,
                tp=params_from_jax(tm, npp), djm=djm,
                djp=jax.tree.map(jnp.asarray, dnp), dnp=dnp)


ARMS = {"self": {"spec_k": 3}, "external": {"spec_k": 3, "external": True},
        "self-int8": {"spec_k": 3, "kv_quant": "int8"}}


def _engine(cls, w, arm, chunk, jax_side):
    kw = dict(ARMS[arm])
    if kw.pop("external", False):
        if jax_side:
            kw.update(draft_model=w["djm"], draft_params=w["djp"])
        else:   # the spec JSON and the flat weight list, as a client sends
            flat = [w["dnp"][ln][pn] for ln, ps in
                    w["djm"].param_specs().items() for pn in ps]
            kw.update(draft_model=jax_spec("transformer_lm", **DRAFT_CFG),
                      draft_params=flat)
    model, params = ((w["jm"], w["jp"]) if jax_side else (w["tm"], w["tp"]))
    return cls(model, params, num_slots=4, page_size=PAGE, seed=0,
               prefill_chunk=chunk, **kw)


@pytest.fixture(scope="module",
                params=[(a, c) for a in ARMS for c in (None, 8)],
                ids=[f"{a}-{'chunk8' if c else 'ladder'}" for a in ARMS
                     for c in (None, 8)])
def jax_run(request, weights):
    arm, chunk = request.param
    eng = _engine(JaxDecodeEngine, weights, arm, chunk, True)
    return arm, chunk, _run_all(eng), eng.stats()


def test_spec_greedy_tokens_identical_to_jax(jax_run, weights):
    arm, chunk, want, jst = jax_run
    eng = _engine(DecodeEngine, weights, arm, chunk, False)
    got = _run_all(eng)
    assert got == want
    assert len({tuple(t) for t in got}) > 3
    st = eng.stats()
    for key in ("enabled", "k", "mode", "draft_layers", "steps", "proposed",
                "accepted", "accept_rate", "mean_accepted"):
        assert st["spec"][key] == jst["spec"][key], key
    assert st["spec"]["steps"] > 0
    assert 0.0 < st["spec"]["accept_rate"] < 1.0   # real rejections
    assert st["kv"]["pages_used"] == 0 and st["kv"]["slots_active"] == 0
    assert st["kv"]["prefix_hits"] >= 1
    assert st["kv_quant"] == ARMS[arm].get("kv_quant", "bf16")


def test_spec_stats_and_gauges(weights):
    eng = _engine(DecodeEngine, weights, "self", None, False)
    assert eng.stats()["spec"] == {
        "enabled": True, "k": 3, "mode": "self", "draft_layers": 1,
        "steps": 0, "proposed": 0, "accepted": 0, "accept_rate": 0.0,
        "mean_accepted": 0.0, "draft_ms": 0.0, "verify_ms": 0.0}
    toks, _ = _drive(eng, PROMPTS[0], NEW)
    st = eng.stats()["spec"]
    assert st["steps"] > 0 and st["draft_ms"] > 0 and st["verify_ms"] > 0
    g = eng.metrics.summary()["gauges"]
    assert g["decode/spec/accept_rate"] == st["accept_rate"]
    assert g["decode/spec/mean_accepted"] == st["mean_accepted"]
    off = DecodeEngine(weights["tm"], weights["tp"], num_slots=4,
                       page_size=PAGE, seed=0)
    assert toks == _drive(off, PROMPTS[0], NEW)[0]
    assert off.stats()["spec"]["enabled"] is False


def test_spec_temperature_lanes_sample_reproducibly(weights):
    """A temperature slot runs with a window of 0 beside greedy slots and
    repeats under its seed; the greedy slot's tokens do not change."""
    eng = _engine(DecodeEngine, weights, "self", None, False)
    greedy = _drive(eng, PROMPTS[3], NEW)[0]

    def burst(seed):
        g = eng.prefill(PROMPTS[3], max_new_tokens=NEW)
        h = eng.prefill([4, 4, 9], max_new_tokens=NEW, temperature=1.0,
                        top_k=8, seed=seed)
        out = {g["slot"]: [g["token"]], h["slot"]: [h["token"]]}
        while min(len(v) for v in out.values()) < NEW:
            for s, t in eng.step().items():
                out[s].extend(t)
        eng.release(g["slot"])
        eng.release(h["slot"])
        return out[g["slot"]][:NEW], out[h["slot"]][:NEW]

    (g1, a), (g2, b), (_, c) = burst(5), burst(5), burst(6)
    assert g1 == g2 == greedy
    assert a == b and a != c


def test_spec_engine_behind_the_batcher(weights):
    eng = _engine(DecodeEngine, weights, "self-int8", 8, False)
    ref = _engine(DecodeEngine, weights, "self-int8", 8, False)
    want = [_drive(ref, p, n)[0] for p, n in zip(PROMPTS, (3, 7, 2, 9, 5, 4))]
    cb = ContinuousBatcher(eng, max_queue=32)
    try:
        futs = [cb.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, (3, 7, 2, 9, 5, 4))]
        got = [f.result(timeout=120) for f in futs]
    finally:
        cb.close()
    assert [r["tokens"] for r in got] == want
    assert eng.kv.stats()["pages_used"] == 0


@pytest.mark.parametrize("kw", [
    {"draft_layers": 1},                                # without spec_k
    {"spec_k": 2, "draft_model": "draft"},              # without params
    {"spec_k": 2, "draft_layers": CFG["num_layers"] + 1},
    {"spec_k": -1},
], ids=["layers-without-spec", "model-without-params", "too-deep",
        "negative"])
def test_spec_misuse_raises_like_jax(weights, kw):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("draft_model") == "draft":
        jkw["draft_model"] = weights["djm"]
        tkw["draft_model"] = jax_spec("transformer_lm", **DRAFT_CFG)
    with pytest.raises(ValueError) as want:
        JaxDecodeEngine(weights["jm"], weights["jp"], num_slots=2,
                        page_size=PAGE, warmup=False, **jkw)
    with pytest.raises(ValueError) as got:
        DecodeEngine(weights["tm"], weights["tp"], num_slots=2,
                     page_size=PAGE, warmup=False, **tkw)
    assert str(got.value) == str(want.value)
