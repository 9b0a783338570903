"""PyTorch port, mixture of experts: ``transformer_moe_lm`` against the JAX
package's on the same numpy-drawn weights — the forward, one training
step's loss and gradients, the ``Trainer``, the serving engine's greedy
tokens and the int8 serving tree — at a small width (2 layers, hidden 32,
4 experts on the second block).

The parity cases run with ``capacity_factor`` 1.0, where capacity drops
tokens; a numpy recomputation of the routing from the MoE block's input
proves the drops, so the comparison covers the overflow slot.

Tolerances, float32: logits 1e-4 (as test_torch_models.py); one step's
loss 1e-5 relative and gradients 1e-5 absolute plus 1e-4 relative, 4
``Trainer`` steps' losses 1e-5 relative and weights 2e-4 with adam (as
test_torch_train.py, epsilon 1e-6 for the same reason). Greedy tokens and
the int8 tree are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import (NEW, PAGE, PROMPTS, SYS, _run_all,
                               numpy_params)
from sparkflow_tpu.models import presets as jax_presets
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu.utils import quant as jquant
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.models import (MoETransformerLM,
                                        build_registry_spec, model_from_json,
                                        presets)
from sparkflow_tpu_torch.serving import DecodeEngine
from sparkflow_tpu_torch.trainer import Trainer
from sparkflow_tpu_torch.utils import quant

S = 32
MOE = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4, mlp_dim=64,
           max_len=64, dropout=0.0, num_experts=4, moe_every=2,
           capacity_factor=1.0)
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the serving preset at parity width (top-2, capacity 1.25)
PRESET = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4,
              mlp_dim=64, max_len=32, num_experts=4)


def _pair(top_k, seed=1, **over):
    cfg = dict(dict(MOE, **over), router_top_k=top_k)
    spec = build_registry_spec("transformer_moe_lm", **cfg)
    assert spec == jax_spec("transformer_moe_lm", **cfg)
    jm = jax_from_json(spec)
    tm = model_from_json(spec, device="cpu")
    assert isinstance(tm, MoETransformerLM)
    assert list(tm.param_specs().items()) == list(jm.param_specs().items())
    return jm, tm, numpy_params(jm.param_specs(), seed=seed, std=0.3)


def _feeds(seed, b=3, masked=False):
    rs = np.random.default_rng(seed)
    feeds = {"input_ids": rs.integers(0, MOE["vocab_size"], (b, S)).astype(
        np.int32)}
    if masked:
        m = np.ones((b, S), np.float32)
        for i in range(b):
            m[i, rs.integers(S // 2, S):] = 0.0
        feeds["attention_mask"] = m
    return feeds


def _numpy_drops(x, mask, router, k, e, cf):
    """Tokens the capacity drops, recomputed in numpy from the MoE block's
    input ``x`` [B,S,H]: first choices claim slots before second ones."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xf @ router.astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    order = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    live = (np.ones(len(xf), bool) if mask is None
            else mask.reshape(-1) > 0)
    cap = max(1, int(np.ceil(cf * len(xf) * k / e)))
    used = np.zeros(e, int)
    dropped = 0
    for ci in range(k):
        for t in np.flatnonzero(live):
            ex = order[t, ci]
            used[ex] += 1
            dropped += used[ex] > cap
    return dropped


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_forward_matches_jax_and_capacity_drops(top_k, masked):
    jm, tm, npp = _pair(top_k)
    feeds = _feeds(3, masked=masked)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, npp),
                               {k: jnp.asarray(v) for k, v in feeds.items()},
                               ["logits"])["logits"])
    seen = []
    inner = tm._moe_mlp_slots

    def spy(bp, x, token_mask=None):
        seen.append((x.detach().numpy().copy(), None if token_mask is None
                     else token_mask.numpy().copy()))
        return inner(bp, x, token_mask)

    tm._moe_mlp_slots = spy
    with torch.inference_mode():
        got = tm.apply(params_from_jax(tm, npp),
                       {k: torch.from_numpy(v) for k, v in feeds.items()},
                       ["logits"])["logits"].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert len(seen) == 1                       # block_1 only
    x, mask = seen[0]
    assert (mask is not None) == masked
    drops = _numpy_drops(x, mask, npp["block_1"]["router"], top_k,
                         MOE["num_experts"], MOE["capacity_factor"])
    assert drops > 0, "the parity case must overflow an expert"


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_loss_and_gradients_match_jax(top_k, masked):
    jm, tm, npp = _pair(top_k, seed=2)
    feeds = _feeds(4, masked=masked)
    jp = jax.tree.map(jnp.asarray, npp)
    jfeeds = {k: jnp.asarray(v) for k, v in feeds.items()}
    jl, jg = jax.value_and_grad(lambda p: jnp.mean(
        jm.loss_vector(p, jfeeds, train=True,
                       rng=jax.random.PRNGKey(0))))(jp)
    tp = tm.load_params(params_from_jax(tm, npp), trainable=True)
    tl = tm.loss_vector(tp, {k: torch.from_numpy(v)
                             for k, v in feeds.items()}, train=True).mean()
    leaves = [tp[ln][pn] for ln, ps in tm.param_specs().items() for pn in ps]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    want = [np.asarray(jg[ln][pn]) for ln, ps in tm.param_specs().items()
            for pn in ps]
    for w, g in zip(want, tg):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
    # the router is trained through the gates and the aux loss
    assert np.abs(tg[[pn for ps in tm.param_specs().values()
                      for pn in ps].index("router")].numpy()).max() > 0


def test_aux_loss_is_the_switch_balance_term():
    """``_loss`` adds ``router_aux_weight`` times the summed per-block aux:
    a dense model's aux is exactly zero."""
    _, tm, npp = _pair(1, seed=3, router_aux_weight=0.0)
    _, tm1, _ = _pair(1, seed=3, router_aux_weight=1.0)
    feeds = {k: torch.from_numpy(v) for k, v in _feeds(5).items()}
    tp = params_from_jax(tm, npp)
    with torch.inference_mode():
        base = tm.loss_vector(tp, feeds, train=False)
        aux = tm1.loss_vector(tp, feeds, train=False) - base
        _, _, aux_total = tm._encode(tp, feeds, True)
    np.testing.assert_allclose(aux.numpy(), float(aux_total), rtol=1e-5)
    assert float(aux_total) > 0.0
    dense = model_from_json(build_registry_spec("transformer_lm", **{
        k: v for k, v in MOE.items() if k not in (
            "num_experts", "moe_every", "capacity_factor")}), device="cpu")
    dp = params_from_jax(dense, numpy_params(dense.param_specs(), seed=3))
    with torch.inference_mode():
        assert float(dense._encode(dp, feeds, True)[2]) == 0.0


@pytest.mark.parametrize("remat", [False, "full"])
def test_trainer_matches_jax_trainer(remat):
    """4 adam steps (2 epochs x 2 sweep batches, no shuffle, dropout 0)
    from the same weights, with and without remat."""
    cfg = dict(MOE, router_top_k=2, remat=remat, max_len=S)
    spec = build_registry_spec("transformer_moe_lm", **cfg)
    toks = np.random.default_rng(9).integers(
        0, MOE["vocab_size"], (8, S)).astype(np.float32)
    npp = numpy_params(jax_from_json(spec).param_specs(), seed=4, std=0.1)
    kw = dict(optimizer="adam", learning_rate=0.01, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0,
              optimizer_options={"learning_rate": 0.01, "epsilon": 1e-6})
    jt = JaxTrainer(spec, "input_ids", None, **kw)
    jr = jt.fit(toks, init_params=npp)
    tt = Trainer(spec, "input_ids", None, device="cpu", **kw)
    tr = tt.fit(toks, init_params=npp)
    np.testing.assert_allclose(tr.losses, jr.losses, **LOSS_TOL)
    from sparkflow_tpu.graphdef import params_to_list as jax_to_list
    for got, want in zip(tt.weights_list(), jax_to_list(jt.model, jt.params)):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    assert tr.losses[-1] < tr.losses[0]


# -- serving -------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    spec = presets.moe_lm(**PRESET)
    assert spec == jax_presets.moe_lm(**PRESET)
    jm = jax_from_json(spec)
    npp = numpy_params(jm.param_specs(), seed=6)
    tm = model_from_json(spec, device="cpu")
    assert tm.router_top_k == 2 and tm.capacity_factor == 1.25
    return spec, jm, jax.tree.map(jnp.asarray, npp), tm, params_from_jax(
        tm, npp)


def _batch(eng, prompts, n):
    """Admit every prompt at once, step until all have ``n`` tokens: the
    decode batch holds live and idle lanes together."""
    infos = [eng.prefill(p, max_new_tokens=n, temperature=0.0)
             for p in prompts]
    toks = {i["slot"]: ([] if i["token"] is None else [i["token"]])
            for i in infos}
    while any(len(t) < n for t in toks.values()):
        for slot, new in eng.step().items():
            toks[slot].extend(new)
    for i in infos:
        eng.release(i["slot"])
    return [toks[i["slot"]][:n] for i in infos]


ARMS = {"ladder": {}, "chunk8": {"prefill_chunk": 8}, "spec2": {"spec_k": 2}}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_greedy_tokens_identical_to_jax_engine(served, arm):
    """Ladder prefill, chunked prefill, ``spec_k=2`` self-speculation; each
    drives every prompt alone (three idle lanes), the prefix-hit replay
    (a suffix prefill), and three prompts in one batch (one idle lane)."""
    _spec, jm, jp, tm, tp = served
    kw = dict(num_slots=4, page_size=PAGE, seed=0, **ARMS[arm])
    jeng = JaxDecodeEngine(jm, jp, **kw)
    teng = DecodeEngine(tm, tp, **kw)
    group = [PROMPTS[1], SYS + [17, 19, 20], [5, 2, 8]]
    want = _run_all(jeng) + _batch(jeng, group, NEW)
    got = _run_all(teng) + _batch(teng, group, NEW)
    assert got == want
    assert len({tuple(t) for t in got}) > 3, "weights decode to one token"
    assert teng.stats()["kv"]["prefix_hits"] >= 1
    if arm == "spec2":
        js, ts = jeng.stats()["spec"], teng.stats()["spec"]
        assert (ts["steps"], ts["proposed"], ts["accepted"]) == (
            js["steps"], js["proposed"], js["accepted"])


def test_int8_tree_is_bit_equal_to_jax(served):
    """Only the attention projections quantize: the router and the expert
    banks are not ``*_kernel`` leaves."""
    _spec, jm, jp, tm, tp = served
    jtree = jquant.quantize_params(jp, min_size=1)
    ttree = quant.quantize_params(tp, min_size=1)
    assert sorted(jtree) == sorted(ttree)
    for ln in jtree:
        assert sorted(jtree[ln]) == sorted(ttree[ln])
        for pn, a in jtree[ln].items():
            assert np.array_equal(np.asarray(a), ttree[ln][pn].numpy()), (
                ln, pn)
    moe = ttree["block_1"]
    assert "qkv_kernel_q8" in moe and "o_kernel_q8" in moe
    assert {"router", "experts_fc1", "experts_fc2"} <= set(moe)
    # served through the quantized tree, the forward equals JAX's
    ids = np.asarray([PROMPTS[1][:16], SYS + [17, 18, 19, 20]], np.int32)
    jq = jm.quantize_for_serving(jp, "weight_only", min_size=1)
    want = np.asarray(jm.apply(jq, {"input_ids": jnp.asarray(ids)},
                               ["logits"])["logits"])
    tq = quant.quantize_for_serving(tm, tp, "weight_only", min_size=1)
    with torch.inference_mode():
        got = tm.apply(tq, {"input_ids": torch.from_numpy(ids)},
                       ["logits"])["logits"].numpy()
    tm.quant_mode = None
    np.testing.assert_allclose(got, want, **TOL)


def test_expert_parallelism_is_refused():
    """Expert parallelism is ported (tests/test_torch_ep.py): a spec with
    ``ep_axis`` builds in both packages, and outside a mesh each package
    refuses it as JAX does — the all_to_all forward with JAX's NameError,
    the local-bank prefill (``ep_axis=``) as a collective over an unbound
    axis (JAX's NameError, the port's "no mesh is bound")."""
    spec = build_registry_spec("transformer_moe_lm",
                               **dict(MOE, ep_axis="ep"))
    assert spec == jax_spec("transformer_moe_lm", **dict(MOE, ep_axis="ep"))
    jm, tm = jax_from_json(spec), model_from_json(spec, device="cpu")
    assert tm.ep_axis == jm.ep_axis == "ep"
    npp = numpy_params(jm.param_specs(), seed=1)
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(NameError, match="mesh axis 'ep' is not bound"):
        jm.apply(jax.tree.map(jnp.asarray, npp),
                 {"input_ids": jnp.asarray(ids)}, ["logits"])
    with pytest.raises(NameError, match="mesh axis 'ep' is not bound"):
        tm.apply(params_from_jax(tm, npp), {"input_ids": torch.tensor(ids)},
                 ["logits"])
    jm, tm, npp = _pair(1)
    with pytest.raises(NameError, match="unbound axis"):
        jm.prefill(jax.tree.map(jnp.asarray, npp), jnp.asarray(ids),
                   ep_axis="ep")
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        tm.prefill(params_from_jax(tm, npp), torch.tensor(ids),
                   ep_axis="ep")


@pytest.mark.parametrize("top_k", [1, 2])
def test_flops_count_the_products_the_dispatch_runs(top_k):
    """``moe_train_step_flops`` (non-causal) equals ``FlopCounterMode``'s
    count of one loss-and-gradient step of a small MoE LM over the plain
    attention: the router, every one of the E x C slots through both
    expert products, the dense layers and the head, forward and backward.
    The ``Trainer``'s MFU uses the causal count."""
    from torch.utils.flop_counter import FlopCounterMode
    from sparkflow_tpu_torch.ops import attention_reference
    from sparkflow_tpu_torch.utils.flops import (moe_train_step_flops,
                                                 transformer_train_step_flops)
    cfg = dict(MOE, num_layers=4, router_top_k=top_k)
    _, tm, npp = _pair(top_k, num_layers=cfg["num_layers"])
    tp = tm.load_params(params_from_jax(tm, npp), trainable=True)
    feeds = {"input_ids": torch.from_numpy(_feeds(8)["input_ids"])}
    counter = FlopCounterMode(display=False)
    with counter:
        loss = tm.loss_vector(tp, feeds, attention=attention_reference).mean()
        torch.autograd.grad(loss, [t for ps in tp.values()
                                   for t in ps.values()])
    b, s = feeds["input_ids"].shape
    args = (b, s, cfg["hidden"], cfg["num_layers"], cfg["mlp_dim"])
    want = moe_train_step_flops(*args, cfg["num_experts"], cfg["moe_every"],
                                cfg["capacity_factor"], top_k,
                                vocab_size=cfg["vocab_size"], causal=False)
    assert counter.get_total_flops() == want
    dense = transformer_train_step_flops(*args, vocab_size=cfg["vocab_size"],
                                         causal=False)
    assert want != dense
