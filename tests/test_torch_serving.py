"""PyTorch port, HTTP front: ServingClient.generate -> InferenceServer
/v1/generate -> ContinuousBatcher -> DecodeEngine on the CPU, token for token
equal to the JAX package's DecodeEngine on the same numpy-drawn weights;
malformed requests are structured 400s."""

import jax
import jax.numpy as jnp
import pytest

from test_torch_shared import PAGE, jax_model, numpy_params, torch_model
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                         InferenceServer, ServingClient,
                                         ServingError)

PROMPTS = [[3, 1, 4], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [1], [8, 8, 8, 8, 2]]
NEW = 5


@pytest.fixture(scope="module")
def served():
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=4)
    jeng = JaxDecodeEngine(jm, jax.tree.map(jnp.asarray, npp), num_slots=2,
                           page_size=PAGE, seed=0)
    want = []
    for p in PROMPTS:
        info = jeng.prefill(p, max_new_tokens=NEW)
        toks = [info["token"]]
        while len(toks) < NEW:
            toks.extend(jeng.step()[info["slot"]])
        jeng.release(info["slot"])
        want.append(toks)
    tm = torch_model()
    eng = DecodeEngine(tm, params_from_jax(tm, npp), num_slots=2,
                       page_size=PAGE, seed=0)
    cb = ContinuousBatcher(eng, max_queue=16)
    srv = InferenceServer(None, generate_batcher=cb, port=0,
                          memory_watch=False).start()
    try:
        yield srv, eng, want
    finally:
        srv.stop()


def test_generate_over_http_matches_jax_engine(served):
    srv, eng, want = served
    cli = ServingClient(srv.url, timeout=60)
    for i, (p, w) in enumerate(zip(PROMPTS, want)):
        r = cli.generate(p, max_new_tokens=NEW, request_id=f"rid-{i}")
        assert r["tokens"] == w
        assert r["finish_reason"] == "length" and r["num_tokens"] == NEW
        assert r["request_id"] == f"rid-{i}"
        assert r["x_request_id_header"] == f"rid-{i}"
        assert set(r["timing_ms"]) >= {"prefill_ms", "decode_ms", "total_ms"}
    h = cli.healthz()
    assert h["status"] == "ok"
    assert h["decode"]["engine"]["kv"]["pages_used"] == 0
    assert h["decode"]["free_slots"] == 2


def test_seeded_generation_repeats_over_http(served):
    srv, _, _ = served
    cli = ServingClient(srv.url, timeout=60)
    a = cli.generate([2, 7, 1], max_new_tokens=6, temperature=0.8, top_k=5,
                     seed=11)
    b = cli.generate([2, 7, 1], max_new_tokens=6, temperature=0.8, top_k=5,
                     seed=11)
    assert a["tokens"] == b["tokens"]


@pytest.mark.parametrize("prompt,new", [([], 1), ([1] * 65, 1), ([1], 0),
                                        ([1, 2], 100)],
                         ids=["empty", "too-long", "no-budget",
                              "past-max-seq"])
def test_misuse_is_a_structured_400(served, prompt, new):
    srv, _, _ = served
    cli = ServingClient(srv.url, timeout=30, retries=0)
    with pytest.raises(ServingError) as ei:
        cli.generate(prompt, max_new_tokens=new)
    assert ei.value.status == 400
