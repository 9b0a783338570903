"""PyTorch port, expert-parallel serving in one process: the decode engine
(``DecodeEngine(mesh=, sharding=ShardingConfig(ep_axis=...))``, alone and
under ``tp x ep``) through ``/v1/generate``, the predict engine and
``predict_fn(mesh=)`` on an ``ep`` mesh, and the estimator's ``ep``
``meshShape``, against the JAX package on its virtual CPU devices, on the
same numpy-drawn weights.

The model is the JAX test's ``moe_lm`` preset (``tests/test_decode.py``'s
expert-parallel case: hidden 32, 2 layers, 4 experts on every block,
top-2) at the shared parity config's vocabulary and length.

Bars: greedy tokens identical to the JAX ep engine in the plain, spec and
int8 arms (one real expert row per token beside exact zeros, so the
port's ep tokens also equal its engine without a mesh); the engine's
refusals with JAX's messages in JAX's order; ep predictions bit-equal to
the port's engine without a mesh and within 1e-5 of JAX's ep engine,
relative to the largest logit (atol 1e-5 x max |logit|, rtol 1e-5: the
two packages' unsharded float32 engines already differ by 2.3e-5 on logits
up to ~5 here, their summation orders differing); the estimator's ep fits
within atol 5e-5 / rtol 1e-5 (weights) of JAX's Trainer on the same mesh
from the estimator's initial weights (JAX's estimator needs its mesh to
span every visible device, so its Trainer stands in).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import NEW, PAGE, PROMPTS, SYS, _drive, numpy_params
from sparkflow_tpu.core import make_predict_fn as jax_predict_fn
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.models import presets as jax_presets
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.serving import InferenceEngine as JaxInferenceEngine
from sparkflow_tpu.sharding import ShardingConfig as JaxConfig
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.core import make_predict_fn
from sparkflow_tpu_torch.models import model_from_json, presets
from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                         InferenceEngine, InferenceServer,
                                         ServingClient)
from sparkflow_tpu_torch.sharding import ShardingConfig

PRESET = dict(hidden=32, num_layers=2, num_heads=4, mlp_dim=64, max_len=64,
              num_experts=4, router_top_k=2, moe_every=1)
SPEC = presets.moe_lm(61, **PRESET)
EP = ShardingConfig(ep_axis="ep")
TP_EP = ShardingConfig(tp_axis="tp", ep_axis="ep")


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def weights():
    assert SPEC == jax_presets.moe_lm(61, **PRESET)
    jm = jax_model(SPEC)
    npp = numpy_params(jm.param_specs(), seed=4)
    return jm, jax.tree.map(jnp.asarray, npp), npp


@pytest.fixture(scope="module")
def torch_moe(weights):
    tm = model_from_json(SPEC, device="cpu")
    return tm, params_from_jax(tm, weights[2])


def _run_some(eng):
    """Greedy tokens of a short prompt, the 24-token one, one publishing
    the shared prefix, and its prefix-hit replay."""
    out = [_drive(eng, p, NEW)[0] for p in (PROMPTS[0], PROMPTS[1],
                                             SYS + [17, 18])]
    out.append(_drive(eng, SYS + [17, 18], NEW)[0])
    return out


@pytest.fixture(scope="module", params=[{}, {"spec_k": 2},
                                        {"kv_quant": "int8"}],
                ids=["plain", "spec", "int8"])
def jax_arm(request, weights):
    jm, jp, _ = weights
    eng = JaxDecodeEngine(jm, jp, num_slots=4, page_size=PAGE, seed=0,
                          prefix_cache=True, mesh=_jmesh({"ep": 2}),
                          sharding=JaxConfig(ep_axis="ep"), **request.param)
    return request.param, _run_some(eng), eng.stats()["parallel"]


@pytest.mark.parametrize("axes,cfg", [({"ep": 2}, EP),
                                      ({"tp": 2, "ep": 2}, TP_EP)],
                         ids=["ep", "tp-ep"])
def test_ep_decode_tokens_identical_to_jax_ep_engine(jax_arm, torch_moe,
                                                     axes, cfg):
    """Every arm over the expert shards (with ``tp`` the attention over the
    tp shards too): the ladder prefill, a prefix hit, speculation with the
    self draft, the int8 pool — the tokens of JAX's ep engine and of the
    port's engine without a mesh."""
    kw, want, jpar = jax_arm
    tm, tp = torch_moe
    eng = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                       prefix_cache=True, mesh=axes, sharding=cfg, **kw)
    got = _run_some(eng)
    assert got == want
    plain = DecodeEngine(tm, tp, num_slots=4, page_size=PAGE, seed=0,
                         prefix_cache=True, **kw)
    assert got == _run_some(plain)
    par = eng.stats()["parallel"]
    assert par["ep"] == jpar["ep"] == 2
    assert par["tp"] == axes.get("tp", 1)
    # one device holds expert shard 0: fewer param bytes than the whole
    assert (par["param_bytes_per_device"]
            < plain.stats()["parallel"]["param_bytes_per_device"])


def test_ep_generate_endpoint_end_to_end(weights, torch_moe):
    """JAX's end-to-end case: ``/v1/generate`` through a ContinuousBatcher
    over an ep engine gives JAX's ep engine's tokens, and ``/healthz``
    reports the mesh."""
    jm, jp, _ = weights
    tm, tp = torch_moe
    prompt = [3, 1, 4, 1, 5]
    jeng = JaxDecodeEngine(jm, jp, num_slots=2, page_size=8, seed=0,
                           mesh=_jmesh({"ep": 2}),
                           sharding=JaxConfig(ep_axis="ep"))
    want = _drive(jeng, prompt, 5)[0]
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=8, seed=0,
                       mesh={"ep": 2}, sharding=EP)
    cb = ContinuousBatcher(eng, max_queue=8)
    srv = InferenceServer(None, generate_batcher=cb, port=0).start()
    try:
        cli = ServingClient(srv.url, timeout=120)
        r = cli.generate(prompt, max_new_tokens=5, request_id="moe-ep")
        assert r["tokens"] == want
        assert r["finish_reason"] == "length"
        h = cli.healthz()
        assert h["decode"]["ep"] == 2
        assert h["decode"]["mesh_shape"] == {"ep": 2}
    finally:
        srv.stop()


def test_ep_decode_refusals_in_jax_order(torch_moe, weights):
    """The ctor's checks in JAX's order: an ep axis over a model without an
    expert bank (also with a pp axis, which JAX checks later), experts not
    dividing ep, then pp with ep."""
    from test_torch_shared import jax_model as jax_lm, torch_model
    tm, tp = torch_moe
    jm, jp, _ = weights
    dense_j = jax_lm()
    dense_np = numpy_params(dense_j.param_specs(), seed=1)
    dense_t = torch_model()
    dense_tp = params_from_jax(dense_t, dense_np)
    cases = [
        (dense_j, jax.tree.map(jnp.asarray, dense_np), dense_t, dense_tp,
         {"ep": 2}, {"ep_axis": "ep"}, "has no expert bank"),
        (dense_j, jax.tree.map(jnp.asarray, dense_np), dense_t, dense_tp,
         {"pp": 2, "ep": 2}, {"pp_axis": "pp", "ep_axis": "ep"},
         "has no expert bank"),
        (jm, jp, tm, tp, {"ep": 3}, {"ep_axis": "ep"},
         "num_experts=4 is not divisible by ep=3"),
        (jm, jp, tm, tp, {"pp": 2, "ep": 2},
         {"pp_axis": "pp", "ep_axis": "ep"},
         "pp_axis does not compose with ep_axis")]
    for jmod, jpar, tmod, tpar, axes, cfg, match in cases:
        with pytest.raises(ValueError, match=match):
            JaxDecodeEngine(jmod, jpar, num_slots=2, page_size=PAGE,
                            mesh=_jmesh(axes), sharding=JaxConfig(**cfg))
        with pytest.raises(ValueError, match=match):
            DecodeEngine(tmod, tpar, num_slots=2, page_size=PAGE, mesh=axes,
                         sharding=ShardingConfig(**cfg))


def _ids(n=3, seed=5):
    return np.random.RandomState(seed).randint(1, 61, (n, 64)).astype(
        np.int32)


@pytest.mark.parametrize("axes,cfg", [({"ep": 2}, EP),
                                      ({"dp": 2, "ep": 2},
                                       ShardingConfig(ep_axis="ep"))],
                         ids=["ep", "dp-ep"])
def test_inference_engine_ep_predict_matches_jax(torch_moe, weights, axes,
                                                 cfg):
    """The predict plane with the banks split over ep (each dp copy split
    so under ``dp x ep``): logits within 1e-5 of JAX's ep engine, the
    shard's bytes below the whole tree's, and ``quantize`` with ep refused
    as in JAX."""
    tm, tp = torch_moe
    jm, jp, _ = weights
    x = _ids()
    eng = InferenceEngine(tm, tp, input_name="input_ids:0",
                          output_name="logits:0", max_batch=4, mesh=axes,
                          sharding=cfg, device="cpu")
    jeng = JaxInferenceEngine(jm, jp, input_name="input_ids:0",
                              output_name="logits:0", max_batch=4,
                              mesh=_jmesh(axes),
                              sharding=JaxConfig(ep_axis="ep"))
    got = eng.predict(x)
    want = np.asarray(jeng.predict(x))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=1e-5)
    st = eng.stats()
    assert st["ep"] == jeng.stats()["ep"] == 2
    plain = InferenceEngine(tm, tp, input_name="input_ids:0",
                            output_name="logits:0", max_batch=4,
                            device="cpu")
    np.testing.assert_array_equal(got, plain.predict(x))
    assert st["param_bytes_per_device"] < plain.stats()[
        "param_bytes_per_device"]
    match = "quantize does not compose with tensor/expert-parallel"
    with pytest.raises(ValueError, match=match):
        JaxInferenceEngine(jm, jp, input_name="input_ids:0",
                           output_name="logits:0", max_batch=4,
                           mesh=_jmesh(axes), quantize="weight_only",
                           sharding=JaxConfig(ep_axis="ep"))
    with pytest.raises(ValueError, match=match):
        InferenceEngine(tm, tp, input_name="input_ids:0",
                        output_name="logits:0", max_batch=4, mesh=axes,
                        sharding=cfg, quantize="weight_only", device="cpu")


def test_split_banks_run_the_per_expert_products(torch_moe):
    """A bank split for serving runs one product per expert (an expert's
    bits then cannot follow its bank's size); a whole bank with
    ``per_expert_products`` gives the split engine's logits bit for bit,
    its batched products within float32 rounding (1e-5 of the largest
    logit), and under autograd the same loss and gradients as the batched
    products (1e-5)."""
    tm, tp = torch_moe
    ref = model_from_json(SPEC, device="cpu")
    ref.per_expert_products = True
    x = _ids()
    kw = dict(input_name="input_ids:0", output_name="logits:0", max_batch=4,
              device="cpu")
    got = InferenceEngine(tm, tp, mesh={"ep": 2}, sharding=EP,
                          **kw).predict(x)
    np.testing.assert_array_equal(got, InferenceEngine(ref, tp,
                                                       **kw).predict(x))
    np.testing.assert_allclose(got, InferenceEngine(tm, tp, **kw).predict(x),
                               rtol=1e-5, atol=1e-5 * np.abs(got).max())
    feeds = {"input_ids": torch.as_tensor(x)}
    grads = []
    for model in (tm, ref):
        p = {ln: {k: v.detach().clone().requires_grad_(True)
                  for k, v in d.items()} for ln, d in tp.items()}
        loss = model._loss(p, feeds, train=False).sum()
        loss.backward()
        grads.append((loss.item(), [v.grad for d in p.values()
                                    for v in d.values()]))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-5)
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_predict_fn_on_an_ep_mesh_matches_jax(torch_moe, weights):
    """``make_predict_fn(mesh={"ep": 2})`` (a mesh axis named ep splits the
    banks) against JAX's ``make_predict_fn`` on the same mesh, which
    replicates."""
    tm, tp = torch_moe
    jm, jp, _ = weights
    x = _ids(5, 6)
    got = make_predict_fn(tm, "input_ids:0", "logits:0",
                          mesh={"ep": 2})(tp, x).numpy()
    want = np.asarray(jax_predict_fn(jm, "input_ids:0", "logits:0",
                                     mesh=_jmesh({"ep": 2}))(jp, x))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=1e-5)
    with torch.inference_mode():
        one = make_predict_fn(tm, "input_ids:0", "logits:0")(tp, x).numpy()
    np.testing.assert_array_equal(got, one)


# -- the estimator ---------------------------------------------------------------


EST_SPEC = presets.moe_lm(30, hidden=32, num_layers=2, num_heads=4,
                          mlp_dim=64, max_len=8, num_experts=4,
                          router_top_k=1, moe_every=2)
FIT_KW = dict(optimizer="adam", learning_rate=0.01, iters=2,
              mini_batch_size=16, shuffle_per_iter=False,
              optimizer_options={"epsilon": 1e-4})


@pytest.mark.parametrize("mesh_shape", ["ep=2", "dp=2,ep=2"])
def test_estimator_ep_fit_matches_jax(mesh_shape):
    """``SparkAsyncDL(meshShape=...)`` with an ``ep`` axis launches its
    ranks and fits the MoE LM (unsupervised, rows in order) to JAX's
    Trainer on the same mesh from the estimator's initial weights (the
    port model's ``init(seed=0)``: the packages draw initial weights from
    different streams)."""
    from sparkflow_tpu_torch import localml
    from sparkflow_tpu_torch.ml_util import convert_json_to_weights
    from sparkflow_tpu_torch.parallel.mesh import parse_mesh_shape
    from sparkflow_tpu_torch.spark_async import SparkAsyncDL
    rs = np.random.RandomState(7)
    ids = rs.randint(0, 30, (32, 8)).astype(np.float32)
    tm = model_from_json(EST_SPEC, device="cpu")
    p0 = {ln: {k: v.detach().numpy() for k, v in d.items()}
          for ln, d in tm.init(seed=0).items()}
    spark = localml.LocalSession.builder.appName("ep").getOrCreate()
    df = spark.createDataFrame([(localml.Vectors.dense(v),) for v in ids],
                               ["features"])
    est = SparkAsyncDL(
        inputCol="features", tensorflowGraph=EST_SPEC, tfInput="input_ids",
        tfLabel=None, tfOutput="logits", tfOptimizer="adam",
        tfLearningRate=.01, iters=2, miniBatchSize=16,
        predictionCol="predicted", shufflePerIter=False,
        optimizerOptions='{"epsilon": 1e-4}', meshShape=mesh_shape,
        device="cpu")
    fitted = est.fit(df)
    jt = JaxTrainer(EST_SPEC, "input_ids", None,
                    mesh=_jmesh(parse_mesh_shape(mesh_shape)), **FIT_KW)
    jt.fit(ids, init_params=jax.tree.map(jnp.asarray, p0))
    got = convert_json_to_weights(fitted.getOrDefault(fitted.modelWeights))
    want = [np.asarray(w) for w in jt.weights_list()]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-5)
    assert est.last_mesh_stats["world"] == (2 if mesh_shape == "ep=2"
                                            else 4)


def test_scratch_writes_keep_the_last_lane(torch_moe):
    """Rows several lanes write to one place of scratch page 0 in one call
    resolve to the last lane's row — a sequential scatter's result (the
    CPU's, XLA's) — for token rows and whole pages; other rows are kept.
    On a card ``index_put_`` keeps an arbitrary duplicate, and an MoE
    model's lanes past their room read scratch rows and claim capacity
    from them, so the pick must not vary."""
    tm, tp = torch_moe
    eng = DecodeEngine(tm, tp, num_slots=2, page_size=PAGE, seed=0)
    rs = np.random.RandomState(0)
    pids = torch.tensor(rs.choice([0, 0, 3, 5], (4, 5)))
    offs = torch.tensor(rs.randint(0, PAGE, (4, 5)))
    rows = torch.tensor(rs.randn(4, 5, 2, 3).astype(np.float32))
    src = eng._scratch_src(pids, offs)
    got = eng._take(rows, src, pids.dim()).numpy()
    seq = {}
    for i, (p, o) in enumerate(zip(pids.reshape(-1).tolist(),
                                   offs.reshape(-1).tolist())):
        seq[(p, o)] = i
    flat = rows.reshape(20, 2, 3).numpy()
    for i, (p, o) in enumerate(zip(pids.reshape(-1).tolist(),
                                   offs.reshape(-1).tolist())):
        want = flat[seq[(p, o)]] if p == 0 else flat[i]
        np.testing.assert_array_equal(got.reshape(20, 2, 3)[i], want)
    pages = torch.tensor(rs.randn(4, PAGE, 2).astype(np.float32))
    page_ids = torch.tensor([7, 0, 2, 0])
    got = eng._take(pages, eng._scratch_src(page_ids), 1).numpy()
    np.testing.assert_array_equal(got[[0, 2]], pages.numpy()[[0, 2]])
    np.testing.assert_array_equal(got[1], pages.numpy()[3])
