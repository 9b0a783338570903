"""PyTorch port, the predict plane: ``InferenceEngine`` (``device="cpu"``)
against the JAX package's ``InferenceEngine`` on the same numpy weights and
inputs, the int8 weight half of ``utils/quant.py``, ``from_checkpoint`` on
both packages' npz layouts, and ``ServingClient.predict`` ->
``InferenceServer`` ``/v1/predict`` -> ``MicroBatcher`` -> the engine.

Two models, as in the JAX package's own serving tests: an ``nn`` MLP
(``tests/test_serving.py``) and a 2-layer, 64-wide ``transformer_classifier``
fed ``input_ids:0`` + ``attention_mask:0``. Tolerances: float32 outputs
within 1e-5 absolute, int8-served outputs (``weight_only``, ``dynamic``)
within 1e-4 absolute; quantized trees and ``int8_matmul`` exactly.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import sparkflow_tpu.nn as jnn
from sparkflow_tpu.checkpoint import CheckpointManager as JaxCheckpoints
from sparkflow_tpu.graph_utils import build_graph
from sparkflow_tpu.graphdef import list_to_params as jax_list_to_params
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.serving import InferenceEngine as JaxEngine
from sparkflow_tpu.utils import quant as jquant

from test_torch_shared import numpy_params
from sparkflow_tpu_torch.checkpoint import CheckpointError, CheckpointManager
from sparkflow_tpu_torch.convert import list_to_params
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.resilience import faults
from sparkflow_tpu_torch.serving import (InferenceEngine, InferenceServer,
                                         ServingClient)
from sparkflow_tpu_torch.utils import quant

MLP_IN, MLP_OUT = "x:0", "out/BiasAdd:0"
CLS = dict(vocab_size=50, num_classes=2, hidden=64, num_layers=2,
           num_heads=4, mlp_dim=128, max_len=32, dropout=0.0)
CLS_IN, CLS_OUT = ["input_ids:0", "attention_mask:0"], "probs:0"
MAX_BATCH = 4
F32_TOL, INT8_TOL = 1e-5, 1e-4


def mlp_graph():
    x = jnn.placeholder([None, 4], name="x")
    h = jnn.dense(x, 3, activation="relu")
    out = jnn.dense(h, 2, name="out")
    jnn.mean_squared_error(x, out)


def _mlp():
    rs = np.random.RandomState(0)
    weights = [rs.randn(4, 3).astype(np.float32),
               rs.randn(3).astype(np.float32),
               rs.randn(3, 2).astype(np.float32),
               rs.randn(2).astype(np.float32)]
    return build_graph(mlp_graph), weights, MLP_IN, MLP_OUT


def _classifier():
    spec = build_registry_spec("transformer_classifier", **CLS)
    assert spec == jax_spec("transformer_classifier", **CLS)
    tree = numpy_params(jax_from_json(spec).param_specs(), seed=3, std=0.1)
    weights = [tree[ln][pn] for ln, ps in
               jax_from_json(spec).param_specs().items() for pn in ps]
    return spec, weights, CLS_IN, CLS_OUT


MODELS = {"mlp": _mlp, "classifier": _classifier}


def _rows(kind, n, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "mlp":
        return rs.randn(n, 4).astype(np.float32)
    ids = rs.randint(1, CLS["vocab_size"], (n, CLS["max_len"])).astype(
        np.int32)
    mask = np.zeros((n, CLS["max_len"]), np.float32)
    for i in range(n):
        mask[i, :rs.randint(CLS["max_len"] // 2, CLS["max_len"] + 1)] = 1.0
    return ids * mask.astype(np.int32), mask


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(kind, spec, weights, JAX engine, port engine) per model, float32."""
    spec, weights, inp, out = MODELS[request.param]()
    kw = dict(input_name=inp, output_name=out, max_batch=MAX_BATCH)
    return (request.param, spec, weights, JaxEngine(spec, weights, **kw),
            InferenceEngine(spec, weights, device="cpu", **kw))


# -- float32 parity ------------------------------------------------------------

def test_predict_matches_jax_over_request_sizes(pair):
    kind, _spec, _w, jeng, teng = pair
    for n in range(1, MAX_BATCH + 4):           # every bucket, then chunks
        x = _rows(kind, n, seed=n)
        got, want = teng.predict(x), jeng.predict(x)
        assert got.shape == want.shape and got.shape[0] == n
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    assert teng.buckets == jeng.buckets == [1, 2, 4]
    assert teng.aot_compiles == len(teng.buckets)
    assert teng.fallback_compiles == 0


def test_single_row_and_empty_request(pair):
    kind, _spec, _w, jeng, teng = pair
    x = _rows(kind, 1, seed=9)
    row = tuple(a[0] for a in x) if isinstance(x, tuple) else x[0]
    np.testing.assert_allclose(teng.predict(row), jeng.predict(row),
                               atol=F32_TOL, rtol=0)
    empty = tuple(a[:0] for a in x) if isinstance(x, tuple) else x[:0]
    got, want = teng.predict(empty), jeng.predict(empty)
    assert got.shape == want.shape and got.shape[0] == 0


def test_row_shape_is_checked_with_the_jax_message(pair):
    kind, _spec, _w, _jeng, teng = pair
    bad = (np.zeros((2, 5), np.float32) if kind == "mlp"
           else (np.zeros((2, 7), np.int32), np.zeros((2, 7), np.float32)))
    with pytest.raises(ValueError, match="model expects"):
        teng.predict(bad)


# -- int8 weights --------------------------------------------------------------

def test_quantized_trees_are_bit_equal_to_jax():
    spec, weights, _i, _o = _classifier()
    jtree = jquant.quantize_params(jax_list_to_params(jax_from_json(spec),
                                                      weights))
    model = model_from_json(spec, device="cpu")
    ttree = quant.quantize_params(list_to_params(model, weights))
    assert sorted(jtree) == sorted(ttree)
    n_q8 = 0
    for ln in jtree:
        assert sorted(jtree[ln]) == sorted(ttree[ln])
        for pn, a in jtree[ln].items():
            t = ttree[ln][pn]
            assert str(t.dtype).split(".")[-1] == str(a.dtype)
            assert np.array_equal(np.asarray(a), t.numpy()), (ln, pn)
            n_q8 += pn.endswith("_q8")
    assert n_q8 == 4 * CLS["num_layers"]     # qkv, o, fc1, fc2; head < 4096
    served = quant.quantize_for_serving(model, list_to_params(model, weights),
                                        "dynamic")
    assert model.quant_mode == "dynamic"
    assert all(torch.equal(served[ln][pn], ttree[ln][pn])
               for ln in ttree for pn in ttree[ln])
    with pytest.raises(ValueError, match="quant mode must be one of"):
        quant.quantize_for_serving(model, served, "int4")


def test_quantize_params_warns_when_nothing_matched(caplog):
    tree = {"l": {"W": torch.ones(64, 64), "kernel": torch.ones(4, 4)}}
    with caplog.at_level("WARNING"):
        out = quant.quantize_params(tree)
    assert "no kernel leaf quantized" in caplog.text
    assert set(out["l"]) == {"W", "kernel"}


@pytest.mark.parametrize("m,k,n", [(32, 64, 24), (1, 3, 2), (5, 7, 9),
                                   (16, 8, 8), (17, 12, 30)],
                         ids=lambda v: str(v))
def test_int8_matmul_is_exact(m, k, n):
    rs = np.random.RandomState(m * 100 + k * 10 + n)
    x = rs.randn(m, k).astype(np.float32)
    q8 = rs.randint(-127, 128, (k, n)).astype(np.int8)
    scale = (rs.rand(1, n) + 0.5).astype(np.float32)
    # the integer product against int64 numpy, exactly
    xq = rs.randint(-127, 128, (m, k)).astype(np.int8)
    got = quant._int_mm(torch.from_numpy(xq), torch.from_numpy(q8))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert np.array_equal(got.numpy().astype(np.int64),
                          xq.astype(np.int64) @ q8.astype(np.int64))
    # the whole function against the JAX package's, bit for bit
    want = np.asarray(jquant.int8_matmul(x, q8, scale))
    mine = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(q8),
                             torch.from_numpy(scale)).numpy()
    assert np.array_equal(mine, want)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_quantized_engine_matches_jax(kind, mode):
    spec, weights, inp, out = MODELS[kind]()
    kw = dict(input_name=inp, output_name=out, max_batch=MAX_BATCH,
              quantize=mode, quant_min_size=1 if kind == "mlp" else 4096)
    jeng = JaxEngine(spec, weights, **kw)
    teng = InferenceEngine(spec, weights, device="cpu", **kw)
    assert teng.model.quant_mode == mode
    assert teng.stats()["quantize"] == mode
    for n in (1, 3, MAX_BATCH + 2):
        x = _rows(kind, n, seed=20 + n)
        np.testing.assert_allclose(teng.predict(x), jeng.predict(x),
                                   atol=INT8_TOL, rtol=0)


# -- construction --------------------------------------------------------------

def test_bad_names_modes_and_weights_fail_at_construction():
    spec, weights, inp, out = _mlp()
    with pytest.raises(KeyError, match="not found in graph"):
        InferenceEngine(spec, weights, input_name="nope:0", output_name=out,
                        max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="quantize must be one of"):
        InferenceEngine(spec, weights, input_name=inp, output_name=out,
                        quantize="int4", max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="weights are required"):
        InferenceEngine(spec, None, input_name=inp, output_name=out,
                        max_batch=2, device="cpu")


@pytest.mark.parametrize("option,item", [
    ({"mesh": {"dp": 1, "ep": 2}}, "item 7"),
    ({"sharding": {"ep_axis": "ep"}}, "item 7")],
    ids=lambda v: next(iter(v)) if isinstance(v, dict) else v)
def test_unported_options_are_refused(option, item):
    # dp and tp serving are ported (tests/test_torch_{mesh_predict,
    # tp_serving}.py); an ep axis, on the mesh or in the sharding config,
    # is not
    spec, weights, inp, out = _mlp()
    with pytest.raises(ValueError, match=f"not yet ported.*{item}"):
        InferenceEngine(spec, weights, input_name=inp, output_name=out,
                        device="cpu", **option)


# -- cold start (executable_dir / compile_cache_dir) ---------------------------

def test_cold_start_options_report_in_stats(tmp_path, rng):
    """On the CPU the plain versions run and no library is loaded: the
    options are accepted, predictions do not move, and ``stats()`` carries
    the JAX engine's cold_start and compile_cache keys with no tier."""
    spec, weights, inp, out = _mlp()
    kw = dict(input_name=inp, output_name=out, max_batch=4, device="cpu")
    plain = InferenceEngine(spec, weights, **kw)
    eng = InferenceEngine(spec, weights, executable_dir=str(tmp_path / "exe"),
                          compile_cache_dir=str(tmp_path / "cc"), **kw)
    x = rng.randn(6, 4).astype(np.float32)
    np.testing.assert_array_equal(eng.predict(x), plain.predict(x))
    st = eng.stats()
    assert st["cold_start"] == {
        "dir": str(tmp_path / "exe"), "serialized_loads": 0,
        "serialized_saves": 0, "tier": None, "source": "cpu",
        "library": None, "boot_s": 0.0}
    assert st["compile_cache"] == {"dir": str(tmp_path / "cc"), "hits": 0,
                                   "misses": 0}
    assert plain.stats()["cold_start"] is None
    assert plain.stats()["compile_cache"] is None
    jeng = JaxEngine(spec, weights, input_name=inp, output_name=out,
                     max_batch=4, executable_dir=str(tmp_path / "jexe"))
    assert set(jeng.stats()["cold_start"]) <= set(st["cold_start"])


def test_cold_start_boots_the_kernels_before_warmup(tmp_path, monkeypatch):
    """The engine hands its store and build directory to ``boot_kernels``
    before any bucket runs, reports the tier it returns, and lets a failed
    boot raise out of the constructor."""
    import sparkflow_tpu_torch.serving.engine as engine_mod
    spec, weights, inp, out = _mlp()
    calls = []
    warm = InferenceEngine.warmup

    def boot(store, cache_dir, device):
        calls.append(("boot", store.directory, cache_dir, str(device)))
        return {"tier": 1, "source": "store", "library": "lib.so",
                "boot_s": 0.5, "saved": False}

    def warmup(self):
        calls.append(("warmup",))
        return warm(self)

    monkeypatch.setattr(engine_mod, "boot_kernels", boot)
    monkeypatch.setattr(InferenceEngine, "warmup", warmup)
    eng = InferenceEngine(spec, weights, input_name=inp, output_name=out,
                          max_batch=4, device="cpu",
                          executable_dir=str(tmp_path / "exe"),
                          compile_cache_dir=str(tmp_path / "cc"))
    assert calls == [("boot", str(tmp_path / "exe"), str(tmp_path / "cc"),
                      "cpu"), ("warmup",)]
    st = eng.stats()
    assert st["cold_start"]["tier"] == 1
    assert st["cold_start"]["serialized_loads"] == 1
    assert st["compile_cache"]["hits"] == 0

    def failing(store, cache_dir, device):
        raise RuntimeError("nvcc not found (set CUDA_HOME)")

    monkeypatch.setattr(engine_mod, "boot_kernels", failing)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        InferenceEngine(spec, weights, input_name=inp, output_name=out,
                        device="cpu", compile_cache_dir=str(tmp_path))


def test_the_card_is_the_default_device():
    spec, weights, inp, out = _mlp()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceEngine(spec, weights, input_name=inp, output_name=out)


def test_lazy_engine_counts_first_use():
    spec, weights, inp, out = _mlp()
    eng = InferenceEngine(spec, weights, input_name=inp, output_name=out,
                          max_batch=8, warmup=False, device="cpu")
    assert eng.aot_compiles == 0
    eng.predict(np.zeros((3, 4), np.float32))
    eng.predict(np.zeros((4, 4), np.float32))
    assert eng.fallback_compiles == 1
    eng.warmup()
    assert eng.aot_compiles == len(eng.buckets) - 1


# -- hot swap ------------------------------------------------------------------

def test_hot_swap_checks_shapes_and_bumps_the_version(pair):
    kind, spec, weights, _jeng, _t = pair
    inp, out = MODELS[kind]()[2:]
    eng = InferenceEngine(spec, weights, input_name=inp, output_name=out,
                          max_batch=MAX_BATCH, device="cpu")
    x = _rows(kind, 3, seed=5)
    before = eng.predict(x)
    bad = [np.zeros((w.shape[0] + 1,) + w.shape[1:], w.dtype)
           if i == 0 else w for i, w in enumerate(weights)]
    with pytest.raises(ValueError):
        eng.swap_params(bad)
    assert eng.serving_version() == 0
    np.testing.assert_array_equal(eng.predict(x), before)
    new = [w * 0.5 for w in weights]
    assert eng.swap_params(new) is True
    assert eng.serving_version() == 1 and eng.stats()["swaps"] == 1
    assert eng.swap_params(new, version=7) and eng.serving_version() == 7
    fresh = InferenceEngine(spec, new, input_name=inp, output_name=out,
                            max_batch=MAX_BATCH, device="cpu")
    np.testing.assert_array_equal(eng.predict(x), fresh.predict(x))
    with faults.inject("engine.swap", fail_calls=[0]):
        with pytest.raises(faults.InjectedFault):
            eng.swap_params(weights)
    assert eng.serving_version() == 7


def test_weights_param_string_forms():
    spec, weights, inp, out = _mlp()
    import json
    inline = json.dumps([w.tolist() for w in weights])
    a = InferenceEngine(spec, inline, input_name=inp, output_name=out,
                        max_batch=2, device="cpu")
    b = InferenceEngine(spec, weights, input_name=inp, output_name=out,
                        max_batch=2, device="cpu")
    x = _rows("mlp", 2)
    np.testing.assert_array_equal(a.predict(x), b.predict(x))


# -- checkpoints ---------------------------------------------------------------

def test_from_checkpoint_reads_a_jax_weights_export(tmp_path):
    spec, weights, inp, out = _classifier()
    JaxCheckpoints.save_weights(str(tmp_path), jax_from_json(spec),
                                jax_list_to_params(jax_from_json(spec),
                                                   weights))
    kw = dict(input_name=inp, output_name=out, max_batch=MAX_BATCH)
    eng = InferenceEngine.from_checkpoint(str(tmp_path), spec, device="cpu",
                                          **kw)
    x = _rows("classifier", 3, seed=2)
    np.testing.assert_allclose(eng.predict(x),
                               JaxEngine(spec, weights, **kw).predict(x),
                               atol=F32_TOL, rtol=0)


def test_from_checkpoint_reads_a_port_npz_checkpoint(tmp_path):
    spec, weights, inp, out = _classifier()
    model = model_from_json(spec, device="cpu")
    params = list_to_params(model, weights)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": params, "step": 3})
    mgr.save(5, {"params": params, "step": 5,
                 "moments": [np.zeros(2, np.float32), torch.ones(3)]})
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5
    assert mgr.verify_step(5) is True
    import json
    with open(tmp_path / "step_5" / "manifest.json") as f:
        assert json.load(f)["format"] == "npz"
    state = mgr.restore()
    assert int(state["step"]) == 5
    assert [m.tolist() for m in state["moments"]] == [[0, 0], [1, 1, 1]]
    kw = dict(input_name=inp, output_name=out, max_batch=MAX_BATCH)
    eng = InferenceEngine.from_checkpoint(str(tmp_path), spec, device="cpu",
                                          **kw)
    x = _rows("classifier", 3, seed=4)
    want = InferenceEngine(spec, weights, device="cpu", **kw).predict(x)
    np.testing.assert_array_equal(eng.predict(x), want)
    # a torn newest step falls back to the older one; naming it raises
    faults.corrupt_latest_checkpoint(str(tmp_path), mode="flip")
    assert mgr.verify_step(5) is False
    assert int(mgr.restore()["step"]) == 3
    with pytest.raises(CheckpointError, match="torn or corrupt"):
        mgr.restore(step=5)


def test_an_orbax_checkpoint_is_refused(tmp_path):
    import sparkflow_tpu.checkpoint as jax_ckpt
    if not jax_ckpt._HAVE_ORBAX:
        pytest.skip("orbax is not importable on the JAX side here")
    spec, weights, inp, out = _classifier()
    jm = jax_from_json(spec)
    jax_ckpt.CheckpointManager(str(tmp_path)).save(
        1, {"params": jax.tree.map(np.asarray,
                                   jax_list_to_params(jm, weights))})
    with pytest.raises(CheckpointError, match="'orbax' format.*npz"):
        InferenceEngine.from_checkpoint(str(tmp_path), spec, device="cpu",
                                        input_name=inp, output_name=out)


# -- HTTP ----------------------------------------------------------------------

def test_predict_over_http_matches_jax(pair):
    kind, spec, weights, jeng, teng = pair
    srv = InferenceServer(teng, port=0, max_delay_ms=2.0,
                          memory_watch=False).start()
    try:
        errors = []

        def client(i):
            try:
                cli = ServingClient(srv.url, timeout=60)
                for j in range(3):
                    x = _rows(kind, 1 + (i + j) % 3, seed=100 + 10 * i + j)
                    wire = (dict(zip(("input_ids", "attention_mask"), x))
                            if isinstance(x, tuple) else x)
                    got = np.asarray(cli.predict(wire), np.float32)
                    np.testing.assert_allclose(got, jeng.predict(x),
                                               atol=F32_TOL, rtol=0)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        h = ServingClient(srv.url).healthz()
        assert h["status"] == "ok"
        assert h["engine"]["fallback_compiles"] == 0
        summary = ServingClient(srv.url).metrics()
        assert "serving/request_latency_ms" in summary["histograms"]
    finally:
        srv.stop()
