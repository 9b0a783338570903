"""PyTorch port, pipeline-parallel decode: ``DecodeEngine(mesh=,
sharding=ShardingConfig(pp_axis=...))`` in one process — the staged arms,
``pp x tp``, the micro-token waves (``pp_wave``) and the refusals —
against the JAX package's engines on the same numpy-drawn weights.

The greedy tokens of every arm are held to the JAX engine WITHOUT a mesh
(JAX's own tests hold its pp engines to it), which saves the JAX side the
compiles of a pp engine per arm; one JAX pp wave engine is built for the
wave cadence (the same slots emit the same tokens on the same steps) and
for ``stats()["parallel"]``'s keys. The models are tiny (hidden 32, 2
layers: a stage holds one block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_shared import (NEW, PAGE, PROMPTS, SYS, _drive, jax_model,
                               numpy_params, torch_model)
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.serving import InferenceEngine as JaxInferenceEngine
from sparkflow_tpu.sharding import ShardingConfig as JaxConfig
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.serving import DecodeEngine, InferenceEngine
from sparkflow_tpu_torch.sharding import ShardingConfig

PP = dict(mesh={"pp": 2}, sharding=ShardingConfig(pp_axis="pp"))
PP_TP = dict(mesh={"pp": 2, "tp": 2},
             sharding=ShardingConfig(pp_axis="pp", tp_axis="tp"))


@pytest.fixture(scope="module")
def weights():
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=2)
    return jm, jax.tree.map(jnp.asarray, npp), npp


@pytest.fixture(scope="module")
def torch_lm(weights):
    tm = torch_model()
    return tm, params_from_jax(tm, weights[2])


def _run_some(eng):
    """Greedy tokens of a short prompt, the 24-token one (a chunked
    admission with ``prefill_chunk=8``), one publishing the shared prefix,
    and its prefix-hit replay."""
    out = [_drive(eng, p, NEW)[0] for p in (PROMPTS[0], PROMPTS[1],
                                             SYS + [17, 18])]
    replay, info = _drive(eng, SYS + [17, 18], NEW)
    assert info["shared_tokens"] == PAGE
    return out + [replay]


@pytest.fixture(scope="module", params=[{}, {"kv_quant": "int8"}],
                ids=["bf16", "int8"])
def jax_tokens(request, weights):
    """The JAX engine without a mesh: its tokens for ``_run_some``."""
    jm, jp, _ = weights
    eng = JaxDecodeEngine(jm, jp, num_slots=4, page_size=PAGE, seed=0,
                          prefill_chunk=8, **request.param)
    return request.param, _run_some(eng)


ARMS = {
    "wave": dict(PP),
    "single_wave": dict(PP, pp_wave=False),
    "spec_self": dict(PP, spec_k=3, draft_layers=1),
    "spec_external": dict(PP, spec_k=2),
    "pp_x_tp": dict(PP_TP),
    "pp_x_tp_spec": dict(PP_TP, spec_k=2, draft_layers=1),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_pp_greedy_tokens_equal_the_jax_engine(jax_tokens, torch_lm, arm):
    """Every arm over the stages: the ladder and chunked prefill, a prefix
    hit, the plain and wave steps, speculation with the self draft (one
    stage) and an external draft, pp x tp, with the bf16 (here float32)
    and the int8 pool; the pool's bytes a stage halve (quarter under pp x
    tp) and so do the blocks a stage holds."""
    quant_kw, want = jax_tokens
    tm, tp = torch_lm
    kw = dict(ARMS[arm], **quant_kw)
    if arm == "spec_external":
        kw.update(draft_model=torch_model(), draft_params=tp)
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       prefill_chunk=8, **kw)
    assert _run_some(eng) == want
    ref = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       warmup=False, **quant_kw).stats()["parallel"]
    par = eng.stats()["parallel"]
    split = 4 if "tp" in kw["mesh"] else 2
    assert par["pp"] == par["stages"] == 2
    assert par["kv_bytes_per_device"] * split == ref["kv_bytes_per_device"]
    assert par["param_bytes_per_device"] < ref["param_bytes_per_device"]
    assert par["pp_wave"] == (not kw.get("spec_k")
                              and kw.get("pp_wave", True))
    st = eng.stats()
    assert st["kv"]["pages_used"] == 0 and st["pending_prefills"] == 0
    if kw.get("spec_k"):
        assert st["spec"]["steps"] > 0


@pytest.fixture(scope="module")
def jax_wave(weights):
    jm, jp, _ = weights
    return JaxDecodeEngine(jm, jp, num_slots=4, page_size=PAGE, seed=0,
                           prefill_chunk=8,
                           mesh=jax_make_mesh({"pp": 2},
                                              devices=jax.devices()[:2]),
                           sharding=JaxConfig(pp_axis="pp"))


def _burst(eng):
    """Four mixed-length greedy slots fill both waves; a fifth request
    (chunked, 25 tokens) is admitted mid-flight into a released lane, so
    the waves drain around its chunks and refill. Returns every step's
    emissions ``{slot: tokens}`` in order, and the final stats."""
    steps, first = [], {}
    infos = [eng.prefill(p, max_new_tokens=5, temperature=0.0)
             for p in ([5, 2, 8], [1, 2, 3, 4, 5, 6, 7], [9], [4, 4])]
    for i in infos:
        first[i["slot"]] = i["token"]
    got = {i["slot"]: [i["token"]] for i in infos}
    late = None
    for _ in range(60):
        out = eng.step()
        steps.append({int(k): list(v) for k, v in out.items()})
        for s, ts in out.items():
            got.setdefault(s, []).extend(ts)
        if late is None and len(got[infos[1]["slot"]]) >= 5:
            eng.release(infos[1]["slot"])
            late = eng.prefill(list(range(2, 27)), max_new_tokens=4,
                               temperature=0.0)
            steps.append({"admitted": late["slot"],
                          "chunked": late["chunked"]})
        if late is not None and len(got.get(late["slot"], [])) >= 4 and \
                all(len(got[i["slot"]]) >= 5 for i in infos
                    if i["slot"] != late["slot"]):
            break
    return steps, first, eng.stats()["parallel"]


def test_waves_emit_the_same_slots_on_the_same_steps_as_jax(jax_wave,
                                                            torch_lm):
    """``pp_wave`` step for step against JAX's pp wave engine: each step is
    one tick, the same slots emit the same tokens on the same ticks, a
    chunked admission drains the waves first, and the parallel stats carry
    JAX's keys and values (the per-device byte counts aside)."""
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       prefill_chunk=8, **PP)
    got, want = _burst(eng), _burst(jax_wave)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert set(got[2]) == set(want[2])
    bytes_keys = ("kv_bytes_per_device", "param_bytes_per_device")
    assert ({k: v for k, v in got[2].items() if k not in bytes_keys}
            == {k: v for k, v in want[2].items() if k not in bytes_keys})
    assert got[2]["pp_wave"] and got[2]["wave_ticks"] > 0


def test_seeded_sampling_through_the_waves_repeats(torch_lm):
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0, **PP)

    def run():
        info = eng.prefill([4, 4], max_new_tokens=4, temperature=1.0,
                           top_k=8, seed=123)
        toks = [] if info["token"] is None else [info["token"]]
        while len(toks) < 4:
            toks.extend(eng.step().get(info["slot"], []))
        eng.release(info["slot"])
        return toks[:4]

    first = run()
    assert first == run()
    assert all(0 <= t < 61 for t in first)


def test_hot_swap_lands_on_every_stage(torch_lm):
    """A swap stages a new tree per stage and lands at a drained boundary:
    the tokens equal a cold pp engine's on the new weights."""
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0, **PP)
    before = _drive(eng, [5, 2, 8], NEW)[0]
    other = params_from_jax(tm, numpy_params(tm.param_specs(), seed=9))
    assert eng.swap_params(other, version=2) is True
    after = _drive(eng, [5, 2, 8], NEW)[0]
    cold = DecodeEngine(tm, other, num_slots=4, page_size=PAGE, seed=0, **PP)
    assert after == _drive(cold, [5, 2, 8], NEW)[0] != before
    assert eng.serving_version() == 2


def _lm(layers, moe=False):
    from sparkflow_tpu.models.registry import (
        build_registry_spec as jax_spec, model_from_json as jax_from)
    cfg = dict(vocab_size=61, hidden=32, num_layers=layers, num_heads=4,
               mlp_dim=64, max_len=32, dropout=0.0)
    family = "transformer_lm"
    if moe:
        family = "transformer_moe_lm"
        cfg.update(num_experts=4, moe_every=1)
    jm = jax_from(jax_spec(family, **cfg))
    tm = model_from_json(build_registry_spec(family, **cfg), device="cpu")
    npp = numpy_params(jm.param_specs(), seed=3)
    return jm, jax.tree.map(jnp.asarray, npp), tm, params_from_jax(tm, npp)


@pytest.mark.parametrize("case", [
    ("num_layers", 3, dict(num_slots=2), {}),
    ("num_slots", 2, dict(num_slots=3), {}),
    ("stage boundary", 4, dict(num_slots=4, spec_k=2, draft_layers=1), {}),
    ("pp with ep", 2, dict(num_slots=2), {"ep": 2}),
], ids=lambda c: c[0])
def test_pp_engine_refusals_match_jax(case):
    name, layers, kw, extra_axes = case
    jm, jp, tm, tp = _lm(layers, moe=name == "pp with ep")
    axes = dict({"pp": 2}, **extra_axes)
    cfg = {"pp_axis": "pp", **({"ep_axis": "ep"} if extra_axes else {})}
    n = int(np.prod(list(axes.values())))
    with pytest.raises(ValueError) as want:
        JaxDecodeEngine(jm, jp, page_size=PAGE, warmup=False,
                        mesh=jax_make_mesh(axes, devices=jax.devices()[:n]),
                        sharding=JaxConfig(**cfg), **kw)
    with pytest.raises(ValueError) as got:
        DecodeEngine(tm, tp, page_size=PAGE, warmup=False, mesh=axes,
                     sharding=ShardingConfig(**cfg), **kw)
    assert str(got.value) == str(want.value)


def test_the_predict_engine_refuses_a_pp_axis_with_jax_message(weights,
                                                               torch_lm):
    jm, jp, _ = weights
    tm, tp = torch_lm
    kw = dict(input_name="input_ids:0", output_name="logits:0", max_batch=4)
    with pytest.raises(ValueError) as want:
        JaxInferenceEngine(jm, jp, mesh=jax_make_mesh(
            {"pp": 2}, devices=jax.devices()[:2]),
            sharding=JaxConfig(pp_axis="pp"), **kw)
    with pytest.raises(ValueError) as got:
        InferenceEngine(tm, tp, mesh={"pp": 2},
                        sharding=ShardingConfig(pp_axis="pp"),
                        device="cpu", **kw)
    assert str(got.value) == str(want.value)
