"""PyTorch port, models: TransformerLM against the JAX package's on the same
numpy-drawn weights, the weight carry (convert.py), the registry and the
device rule. Tolerance 1e-4 in float32: the two frameworks sum matmuls in
different orders, a few 1e-6 per layer at these widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shared import CFG, jax_model, numpy_params, torch_model
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu_torch.convert import (list_to_params, params_from_jax,
                                         params_to_list)
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jm = jax_model()
    tm = torch_model()
    npp = numpy_params(jm.param_specs(), seed=1)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(tm, npp)
    return jm, jp, tm, tp, npp


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (b, s)).astype(np.int32)


def test_param_specs_match_jax(pair):
    jm, _, tm, _, _ = pair
    assert list(tm.param_specs().items()) == list(jm.param_specs().items())


@pytest.mark.parametrize("s", [1, 13, 40])
def test_forward_logits_match_jax(pair, s):
    jm, jp, tm, tp, _ = pair
    ids = _ids(s, 2, s)
    want = np.asarray(jm.apply(jp, {"input_ids": ids}, ["logits"])["logits"])
    with torch.inference_mode():
        got = tm.apply(tp, {"input_ids": torch.from_numpy(ids)},
                       ["logits"])["logits"].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_logits_and_kv_match_jax(pair):
    jm, jp, tm, tp, _ = pair
    ids = _ids(3, 2, 24)
    lengths = np.asarray([24, 17], np.int32)
    jl, jkv = jm.prefill(jp, jnp.asarray(ids), lengths=jnp.asarray(lengths))
    with torch.inference_mode():
        tl, tkv = tm.prefill(tp, torch.from_numpy(ids),
                             lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert len(tkv) == CFG["num_layers"]
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_decode_step_dense_cache_matches_jax(pair):
    jm, jp, tm, tp, _ = pair
    prompt = [3, 9, 4, 1, 7, 22, 60]
    jc = jm.init_decode_cache(2, max_len=16)
    tc = tm.init_decode_cache(2, max_len=16)
    with torch.inference_mode():
        for pos, t in enumerate(prompt):
            tok = np.asarray([t, (t * 7) % CFG["vocab_size"]], np.int32)
            p = np.asarray([pos, pos], np.int32)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(p))
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                    torch.from_numpy(p))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_decode_step_reproduces_full_forward(pair):
    """The port's own dense-cache decode equals its full causal forward."""
    _, _, tm, tp, _ = pair
    prompt = [5, 2, 8, 30, 11]
    cache = tm.init_decode_cache(1, max_len=8)
    with torch.inference_mode():
        for pos, t in enumerate(prompt):
            logits, cache = tm.decode_step(
                tp, cache, torch.tensor([t]), torch.tensor([pos]))
        full = tm.apply(tp, {"input_ids": torch.tensor([prompt])},
                        ["logits"])["logits"]
    np.testing.assert_allclose(logits[0].numpy(), full[0, -1].numpy(), **TOL)


def _jax_hist_attend(start_len):
    """Dense-history attend for prefill_suffix, JAX side: the cache holds
    committed K/V [B,H,L,D]; the chunk writes at ``start`` and attends
    causally over everything up to each query's position."""
    def attend(layer, q, k, v, cache, start):
        kc, vc = cache
        s = q.shape[2]
        kl = jax.lax.dynamic_update_slice(kc[layer], k, (0, 0, start_len, 0))
        vl = jax.lax.dynamic_update_slice(vc[layer], v, (0, 0, start_len, 0))
        sc = jnp.einsum("bhqd,bhkd->bhqk", q, kl) / np.sqrt(q.shape[-1])
        qpos = start_len + jnp.arange(s)[:, None]
        ok = jnp.arange(kl.shape[2])[None, :] <= qpos
        sc = jnp.where(ok, sc, -1e30)
        out = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(sc, -1), vl)
        return out, (kc.at[layer].set(kl), vc.at[layer].set(vl))
    return attend


def _torch_hist_attend(start_len):
    def attend(layer, q, k, v, cache, start):
        kc, vc = cache
        s = q.shape[2]
        kc[layer][:, :, start_len:start_len + s] = k
        vc[layer][:, :, start_len:start_len + s] = v
        sc = torch.einsum("bhqd,bhkd->bhqk", q, kc[layer]) / np.sqrt(
            q.shape[-1])
        qpos = start_len + torch.arange(s)[:, None]
        ok = torch.arange(kc.shape[3])[None, :] <= qpos
        sc = torch.where(ok, sc, -1e30)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1),
                           vc[layer])
        return out, cache
    return attend


def test_prefill_suffix_matches_jax(pair):
    """Prefix K/V from prefill, then the suffix through prefill_suffix:
    logits equal the JAX model's and the full-prompt prefill's."""
    jm, jp, tm, tp, _ = pair
    ids = _ids(11, 1, 20)
    n0, L = 12, 24
    h, d = CFG["num_heads"], CFG["hidden"] // CFG["num_heads"]
    _, jkv = jm.prefill(jp, jnp.asarray(ids[:, :n0]))
    jk = jnp.zeros((CFG["num_layers"], 1, h, L, d)).at[:, :, :, :n0].set(
        jnp.stack([k for k, _ in jkv]))
    jv = jnp.zeros((CFG["num_layers"], 1, h, L, d)).at[:, :, :, :n0].set(
        jnp.stack([v for _, v in jkv]))
    jl, _ = jm.prefill_suffix(jp, jnp.asarray(ids[:, n0:]),
                              jnp.asarray([n0], jnp.int32), (jk, jv),
                              _jax_hist_attend(n0))
    with torch.inference_mode():
        _, tkv = tm.prefill(tp, torch.from_numpy(ids[:, :n0]))
        tk = torch.zeros(CFG["num_layers"], 1, h, L, d)
        tv = torch.zeros(CFG["num_layers"], 1, h, L, d)
        tk[:, :, :, :n0] = torch.stack([k for k, _ in tkv])
        tv[:, :, :, :n0] = torch.stack([v for _, v in tkv])
        tl, _ = tm.prefill_suffix(tp, torch.from_numpy(ids[:, n0:]),
                                  torch.tensor([n0]), (tk, tv),
                                  _torch_hist_attend(n0))
        full, _ = tm.prefill(tp, torch.from_numpy(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl.numpy(), full.numpy(), **TOL)


def test_params_round_trip_is_exact(pair):
    jm, _, tm, tp, npp = pair
    flat = params_to_list(tm, tp)
    want = [npp[ln][pn] for ln, ps in jm.param_specs().items() for pn in ps]
    assert len(flat) == len(want)
    for a, b in zip(flat, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    again = list_to_params(tm, flat)
    for ln, layer in tp.items():
        for pn, t in layer.items():
            assert torch.equal(again[ln][pn], t)


def test_params_from_jax_flat_list_and_dtype(pair):
    jm, _, tm, tp, npp = pair
    flat = [npp[ln][pn] for ln, ps in jm.param_specs().items() for pn in ps]
    bf = params_from_jax(tm, flat, dtype=torch.bfloat16)
    assert bf["block_0"]["qkv_kernel"].dtype == torch.bfloat16
    assert torch.equal(bf["embed"]["tok"], tp["embed"]["tok"].bfloat16())
    with pytest.raises(ValueError):
        params_from_jax(tm, flat[:-1])
    bad = dict(npp, final_ln={"scale": np.ones(3, np.float32),
                              "bias": npp["final_ln"]["bias"]})
    with pytest.raises(ValueError):
        params_from_jax(tm, bad)


def test_init_follows_param_specs_with_generator():
    tm = torch_model()
    a = tm.init(torch.Generator().manual_seed(4))
    b = torch_model().init(torch.Generator().manual_seed(4))
    assert torch.equal(a["block_1"]["qkv_kernel"], b["block_1"]["qkv_kernel"])
    assert torch.equal(a["final_ln"]["scale"], torch.ones(CFG["hidden"]))
    assert torch.equal(a["block_0"]["fc1_bias"], torch.zeros(CFG["mlp_dim"]))
    std = float(a["embed"]["tok"].std())
    assert 0.015 < std < 0.025
    names = dict(tm.named_parameters())
    assert "block_0.qkv_kernel" in names and "embed.tok" in names
    assert not names["embed.tok"].requires_grad


def test_registry_spec_is_byte_identical_to_jax():
    kw = dict(vocab_size=50257, hidden=768, num_layers=12, num_heads=12,
              mlp_dim=3072, max_len=1024)
    assert (build_registry_spec("transformer_lm", **kw)
            == jax_spec("transformer_lm", **kw))
    m = model_from_json(build_registry_spec("transformer_lm", **CFG),
                        compute_dtype="bfloat16", device="cpu")
    assert m.compute_dtype == torch.bfloat16 and m.head_dim == 8


# one case per preset builder and one per registry family: the spec
# string is the JAX package's byte for byte, and the port builds the model
PRESETS = {
    "mlp": dict(input_dim=20, num_classes=3),
    "cnn": dict(side=12, channels=1, num_classes=4),
    "autoencoder": dict(input_dim=30, widths=(16, 8, 16)),
    "moe_lm": dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4,
                   mlp_dim=64, max_len=32),
}
FAMILIES = {
    "transformer_lm": CFG,
    "transformer_classifier": dict(CFG, num_classes=3),
    "transformer_moe_lm": dict(CFG, num_experts=4, router_top_k=2),
    "resnet": dict(num_classes=10, depth=18, image_size=32, width=8),
    "resnet50": dict(num_classes=10, image_size=32),
    "rnn_classifier": dict(vocab_size=40, num_classes=2, hidden=16,
                           cell="gru", bidirectional=True),
    "rnn_lm": dict(vocab_size=40, hidden=16, num_layers=1),
}


@pytest.mark.parametrize("name", sorted(PRESETS) + sorted(FAMILIES))
def test_specs_are_byte_identical_to_jax_and_build(name):
    from sparkflow_tpu.models import presets as jax_presets
    from sparkflow_tpu.models.registry import model_from_json as jax_from
    from sparkflow_tpu_torch.models import presets
    if name in PRESETS:
        spec = getattr(presets, name)(**PRESETS[name])
        assert spec == getattr(jax_presets, name)(**PRESETS[name])
    else:
        spec = build_registry_spec(name, **FAMILIES[name])
        assert spec == jax_spec(name, **FAMILIES[name])
    jm = jax_from(spec)
    tm = model_from_json(spec, device="cpu")
    assert list(tm.param_specs().items()) == list(jm.param_specs().items())
    if name in FAMILIES:
        assert tm.model_name == name == jm.model_name
    tree = tm.init(seed=0)
    flat = params_to_list(tm, tree)
    assert len(flat) == sum(len(p) for p in jm.param_specs().values())
    assert all(torch.equal(a, b) for ln in tree for a, b in zip(
        tree[ln].values(), list_to_params(tm, flat)[ln].values()))
    # JAX weights carry both ways: the flat list in spec order, and the
    # sorted-key leaf order of the on-disk trees
    from sparkflow_tpu.graphdef import params_to_list as jax_to_list
    from sparkflow_tpu_torch.convert import sorted_leaves
    npp = numpy_params(jm.param_specs(), seed=3)
    tp = params_from_jax(tm, npp)
    assert all(np.array_equal(a, b) for a, b in zip(
        params_to_list(tm, tp), jax_to_list(jm, npp), strict=True))
    assert all(np.array_equal(t.numpy(), a) for (_, t), a in zip(
        sorted_leaves(tp), jax.tree.leaves(npp), strict=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model_from_json(spec)


@pytest.mark.parametrize("kw", [{"sp_axis": "sp"}])
def test_unported_model_options_raise(kw):
    # sequence parallelism is ported: the model builds, and its forward
    # runs ring attention only inside a bound mesh (tests/test_torch_ring.py)
    spec = build_registry_spec("transformer_lm", **dict(CFG, **kw))
    m = model_from_json(spec, device="cpu")
    assert m.sp_axis == "sp"
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        m.apply(m.init(seed=0), {"input_ids": ids}, ["logits"])


def test_unported_call_options_raise(pair):
    _, _, tm, tp, _ = pair
    ids = torch.zeros(1, 4, dtype=torch.long)
    # tp_axis is ported (the Megatron forward of a tp rank,
    # tests/test_torch_tp.py): outside a bound mesh it raises, as a psum
    # over an unbound axis does in JAX; ep_axis is not ported
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        tm.prefill(tp, ids, tp_axis="tp")
    with pytest.raises(ValueError, match="kv_dtype"):
        tm.init_decode_cache(1, kv_dtype="int4")
    with pytest.raises(ValueError, match="ep_axis"):
        tm.prefill(tp, ids, ep_axis="ep")


def test_constructor_without_device_needs_a_card():
    """Entry points run on the card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    spec = build_registry_spec("transformer_lm", **CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_from_json(spec)
