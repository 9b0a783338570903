"""PyTorch port, tensor-parallel serving in one process: the decode engine
(``DecodeEngine(mesh=, sharding=ShardingConfig(tp_axis=...))``), the
predict engine and ``predict_fn(mesh=)`` on a ``tp`` mesh, against the JAX
package's tp engines (``shard_map`` decode, GSPMD predict) on its virtual
CPU devices, on the same numpy-drawn weights.

Bars: greedy tokens identical to the JAX tp engine in the plain, spec and
int8 arms (and after a hot swap, to a cold engine on the new weights); the
quantized pool's shards, side by side, bit-equal to JAX's global pool
written with the same rows (scales within 1e-7 relative, as
``tests/test_torch_kvquant.py``); tp predictions within 1e-4 of JAX's tp
engine (``tests/test_decode.py``'s case) and ``predict_fn`` on a dp=2 x
tp=2 mesh within 1e-5 of one copy. On the CPU every shard lives on the
CPU: the partials are summed in shard order there as on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import (CFG, NEW, PAGE, PROMPTS, SYS, _drive,
                               jax_model, numpy_params, torch_model)
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.serving import InferenceEngine as JaxInferenceEngine
from sparkflow_tpu.sharding import ShardingConfig as JaxConfig
from sparkflow_tpu.utils import quant as jquant
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.serving import DecodeEngine, InferenceEngine
from sparkflow_tpu_torch.sharding import ShardingConfig
from sparkflow_tpu_torch.trainer import Trainer
from sparkflow_tpu_torch.utils import quant

TP = ShardingConfig(tp_axis="tp")


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
    """Greedy tokens of a short prompt, the 24-token one, one publishing
    the shared prefix, and its prefix-hit replay."""
    out = [_drive(eng, p, NEW)[0] for p in (PROMPTS[0], PROMPTS[1],
                                             SYS + [17, 18])]
    out.append(_drive(eng, SYS + [17, 18], NEW)[0])
    return out


def _jmesh():
    return jax_make_mesh({"tp": 2}, devices=jax.devices()[:2])


@pytest.fixture(scope="module", params=[{}, {"spec_k": 3},
                                        {"kv_quant": "int8"}],
                ids=["plain", "spec", "int8"])
def jax_arm(request, weights):
    jm, jp, _ = weights
    eng = JaxDecodeEngine(jm, jp, num_slots=4, page_size=PAGE, seed=0,
                          mesh=_jmesh(), sharding=JaxConfig(tp_axis="tp"),
                          **request.param)
    return request.param, _run_some(eng), eng.stats()["parallel"]


def test_tp_decode_tokens_identical_to_jax_tp_engine(jax_arm, torch_lm):
    """Every arm over the shards: the ladder and chunk-free prefill, a
    prefix hit (the replay), speculation with the self draft, the int8
    pool; the pool's heads and the weights halve on each shard."""
    kw, want, jpar = jax_arm
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       mesh={"tp": 2}, sharding=TP, **kw)
    got = _run_some(eng)
    assert got == want
    assert len({tuple(t) for t in got}) > 2, "weights decode to one token"
    st = eng.stats()
    par = st["parallel"]
    assert par["tp"] == jpar["tp"] == 2 and par["mesh"] == {"tp": 2}
    plain = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0, **kw)
    ref = plain.stats()["parallel"]
    assert par["kv_bytes_per_device"] * 2 == ref["kv_bytes_per_device"]
    assert par["param_bytes_per_device"] < ref["param_bytes_per_device"]
    assert st["kv"]["prefix_hits"] >= 1 and st["kv"]["pages_used"] == 0
    if kw.get("spec_k"):
        assert st["spec"]["steps"] > 0
    if kw.get("kv_quant"):
        assert st["kv_quant_error"] is not None


def test_chunked_prefill_on_the_shards(torch_lm):
    """Chunked admission advances one chunk per step on every shard; the
    tokens equal the unsharded engine's, with speculation on too."""
    tm, tp = torch_lm
    kw = dict(num_slots=4, page_size=PAGE, seed=0, prefill_chunk=8,
              spec_k=3)
    prompts = [list(range(1, 25)), SYS + [17, 18], [5, 2, 8]]
    sharded = DecodeEngine(tm, tp, mesh={"tp": 2}, sharding=TP, **kw)
    plain = DecodeEngine(tm, tp, **kw)
    for p in prompts + [SYS + [17, 18]]:
        assert _drive(sharded, p, 6)[0] == _drive(plain, p, 6)[0]


def test_an_external_draft_stays_whole_beside_the_shards(torch_lm):
    """``spec_k`` with an external ``draft_model``: the draft keeps its own
    dense cache, whole, on the engine's device (as in JAX); the target's
    verify runs over the shards. Greedy tokens equal the unsharded
    engine's."""
    tm, tp = torch_lm
    draft = torch_model()
    dparams = draft.init(seed=11)
    kw = dict(num_slots=2, page_size=PAGE, seed=0, spec_k=3,
              draft_model=draft, draft_params=dparams)
    sharded = DecodeEngine(tm, tp, mesh={"tp": 2}, sharding=TP, **kw)
    plain = DecodeEngine(tm, tp, **kw)
    for p in ([5, 2, 8], SYS + [17, 18]):
        assert _drive(sharded, p, 6)[0] == _drive(plain, p, 6)[0]
    assert sharded.stats()["spec"]["mode"] == "external"
    assert sharded._draft_k.shape[2] == CFG["num_heads"]


def test_quantized_pool_shards_are_jax_global_pool(torch_lm):
    """The int8 pool sharded on heads: each shard written through the
    engine's own write path with its heads of the same rows, side by side,
    is JAX's global pool bit for bit — rows, and scales sharded on heads
    with them."""
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0,
                       mesh={"tp": 2}, sharding=TP, kv_quant="int8",
                       warmup=False)
    H, d = CFG["num_heads"], CFG["hidden"] // CFG["num_heads"]
    (k0, _v0), (k1, _v1) = eng._shard_pools
    assert k0[0].shape[3] == H // 2 and k0[1].shape[2] == H // 2
    rs = np.random.RandomState(3)
    pages = (rs.randn(3, PAGE, H, d) * 2).astype(np.float32)
    ids = np.array([1, 2, 3])
    rows = (rs.randn(4, H, d) * 6).astype(np.float32)
    pids, offs = np.array([1, 3, 3, 4]), np.array([5, 0, 1, 0])
    h = H // 2
    with torch.inference_mode():
        for s, pool in enumerate((k0, k1)):
            eng._kv_pages(pool, 1, torch.from_numpy(ids),
                          torch.from_numpy(pages[:, :, s * h:(s + 1) * h]))
            eng._kv_rows(pool, 1, torch.from_numpy(pids),
                         torch.from_numpy(offs),
                         torch.from_numpy(rows[:, s * h:(s + 1) * h]))
    L, P = k0[0].shape[:2]
    jstore, _ = jquant.kv_pool_dtype("int8")
    jq = jnp.zeros((L, P, PAGE, H, d), jstore)
    js = jnp.zeros((L, P, H), jnp.float32)
    jq, js = jquant.paged_quant_write_pages(jq, js, 1, jnp.asarray(ids),
                                           jnp.asarray(pages))
    jq, js = jquant.paged_quant_append(jq, js, 1, jnp.asarray(pids),
                                       jnp.asarray(offs), jnp.asarray(rows))
    glob = torch.cat([k0[0], k1[0]], dim=3)
    scales = torch.cat([k0[1], k1[1]], dim=2)
    np.testing.assert_array_equal(glob.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=1e-7,
                               atol=0)
    assert quant.kv_pool_dtype("int8")[0] == glob.dtype


def test_hot_swap_under_tp(torch_lm, weights):
    """A swap lands on every shard through the ctor's placement: the
    swapped tp engine decodes as a cold tp engine and as the unsharded
    engine on the new weights."""
    tm, tp = torch_lm
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0,
                       mesh={"tp": 2}, sharding=TP)
    before = _drive(eng, [5, 2, 8], 6)[0]
    other = numpy_params(weights[0].param_specs(), seed=9)
    assert eng.swap_params(other) is True
    after = _drive(eng, [5, 2, 8], 6)[0]
    cold = DecodeEngine(tm, params_from_jax(tm, other), num_slots=2,
                        page_size=PAGE, seed=0, mesh={"tp": 2}, sharding=TP)
    plain = DecodeEngine(tm, params_from_jax(tm, other), num_slots=2,
                         page_size=PAGE, seed=0)
    assert after == _drive(cold, [5, 2, 8], 6)[0] == \
        _drive(plain, [5, 2, 8], 6)[0]
    assert after != before and eng.stats()["swaps"] == 1


def test_tp_decode_validation_matches_jax(torch_lm, weights):
    tm, tp = torch_lm
    jm, jp, _ = weights
    with pytest.raises(ValueError) as a:
        DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, sharding=TP)
    with pytest.raises(ValueError) as b:
        JaxDecodeEngine(jm, jp, num_slots=2, page_size=PAGE,
                        sharding=JaxConfig(tp_axis="tp"), warmup=False)
    assert str(a.value) == str(b.value)
    with pytest.raises(ValueError, match="num_heads=4 is not divisible by "
                                         "tp=3"):
        DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, mesh={"tp": 3},
                     sharding=TP)


# -- the predict plane ------------------------------------------------------------


def test_inference_engine_tp_predict_matches_jax(torch_lm, weights):
    """``tests/test_decode.py``'s case: logits of the tp=2 engine within
    1e-4 of JAX's tp engine, the params sharded at rest, and quantize with
    tp refused with JAX's message."""
    tm, tp = torch_lm
    jm, jp, _ = weights
    kw = dict(input_name="input_ids:0", output_name="logits:0", max_batch=4)
    x = np.array([[(i * 7 + k + 1) % CFG["vocab_size"]
                   for k in range(CFG["max_len"])] for i in range(3)],
                 np.int32)
    j2 = JaxInferenceEngine(jm, jp, mesh=_jmesh(),
                            sharding=JaxConfig(tp_axis="tp"), **kw)
    e2 = InferenceEngine(tm, tp, mesh={"tp": 2}, sharding=TP, **kw)
    e1 = InferenceEngine(tm, tp, **kw)
    np.testing.assert_allclose(e2.predict(x), np.asarray(j2.predict(x)),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(e2.predict(x), e1.predict(x), atol=1e-4,
                               rtol=1e-4)
    s = e2.stats()
    assert s["tp"] == 2 and s["ep"] == 1
    assert s["param_bytes_per_device"] < e1.stats()["param_bytes_per_device"]
    other = numpy_params(jm.param_specs(), seed=5)
    e2.swap_params(other)
    np.testing.assert_allclose(
        e2.predict(x), InferenceEngine(tm, params_from_jax(tm, other),
                                       **kw).predict(x), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError) as a:
        InferenceEngine(tm, tp, mesh={"tp": 2}, sharding=TP,
                        quantize="weight_only", **kw)
    with pytest.raises(ValueError) as b:
        JaxInferenceEngine(jm, jp, mesh=_jmesh(),
                           sharding=JaxConfig(tp_axis="tp"),
                           quantize="weight_only", **kw)
    assert str(a.value) == str(b.value)


def test_predict_fn_on_a_dp_tp_mesh_matches_one_copy():
    """``Trainer.predict_fn(mesh={"dp": 2, "tp": 2})``: two copies of two
    shards each, rows split over the copies, within 1e-5 of one copy."""
    spec = build_registry_spec("transformer_classifier", vocab_size=64,
                               num_classes=3, hidden=32, num_layers=2,
                               num_heads=4, mlp_dim=64, max_len=16,
                               dropout=0.0)
    names = ["input_ids", "attention_mask"]
    tr = Trainer(spec, names, "y", device="cpu")
    params = tr.model.init(seed=3)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 64, (5, 16)).astype(np.int64)
    mask = np.ones((5, 16), np.float32)
    mask[2, 9:] = 0.0
    got = tr.predict_fn("probs:0", mesh={"dp": 2, "tp": 2})(
        params, (ids, mask)).numpy()
    want = tr.predict_fn("probs:0")(params, (ids, mask)).numpy()
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
