"""PyTorch port on the CUDA card: each kernel against its plain PyTorch
version at the shapes of the decode-serving and training paths, and the
engine and the trainer through the kernels. Marked ``cuda``; every test
skips where there is no card.

This file imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` skips tests/conftest.py, which sets JAX up).

Tolerances (same as chip_smoke.py): float32 outputs 1e-4 (float32 flash:
the kernel runs on the tensor cores in 3xTF32, each product to ~2^-21
where the plain version's float32 product keeps 2^-24, and the summation
order differs — tests/test_torch_flash_fwd_tf32.py holds an emulation of
the kernel's arithmetic to the JAX Pallas forward within 2e-6 on the CPU;
float32 paged: float32 FMA on both sides, different summation order);
bfloat16 flash outputs 2e-2 (the
kernel runs on the tensor cores and rounds the unnormalised P of each
64-key tile to bfloat16 before P V, as the TPU kernel does; the plain
version rounds the normalised P; a few bfloat16 ulps at |O| ~ 1 —
tests/test_torch_flash_fwd.py holds an emulation of the kernel's rounding
against the JAX Pallas forward on the CPU); bfloat16
paged outputs 8e-3 (both sides compute in float32 from the same bfloat16
rows and round once: up to two ulps); logsumexp 1e-3 in bfloat16 inputs,
1e-4 in float32; backward kernels 1e-4 (float32: the kernels run on the
tensor cores in 3xTF32, each product to ~2^-21 where the plain version's
float32 product keeps 2^-24, and the summation order differs —
tests/test_torch_flash_bwd_tf32.py holds an emulation of the 3xTF32
arithmetic to the JAX Pallas backward within 2e-5 on the CPU)
and 2e-2 (bfloat16) of the largest |gradient|: the bfloat16 kernels run on
the tensor cores and round P and dS to bfloat16 before the second product
(dV = P^T dO, dQ = dS K, dK = dS^T Q), as FlashAttention-2 does, where the
plain version keeps them in float32 — tests/test_torch_flash_bwd.py holds
an emulation of that rounding to the float32 backward within 2e-2 on the
CPU.
"""

import numpy as np
import pytest
import torch

from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                     paged_attention,
                                     paged_attention_reference)

pytestmark = pytest.mark.cuda

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max |reference|


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [16, 100, 128, 700, 1024])
def test_flash_kernel_matches_plain_causal(dev, dtype, s):
    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn(1, 12, s, 64, generator=g, device=dev).to(dtype)
               for _ in range(3))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = attention_reference(q, k, v, causal=True, return_lse=True)
    assert _max_err(out, ref) < FLASH_TOL[dtype]
    assert _max_err(lse, ref_lse) < LSE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain_masked(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 12, 256, 64, generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = torch.ones(2, 256, device=dev)
    mask[0, 200:] = 0
    mask[1, 77:] = 0
    out = flash_attention(q, k, v, kv_mask=mask)
    ref = attention_reference(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert _max_err(out, ref) < FLASH_TOL[dtype]


def _check_fwd(q, k, v, causal, mask=None):
    """The forward kernel's output and logsumexp against the plain version
    (all-padding rows: lse at NEG_INF on both sides); returns the output."""
    out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                               return_lse=True)
    ref, ref_lse = attention_reference(q, k, v, causal, kv_mask=mask,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and torch.isfinite(out.float()).all()
    assert _max_err(out, ref) < FLASH_TOL[q.dtype]
    live = ref_lse > -0.5e30
    assert _max_err(lse[live], ref_lse[live]) < LSE_TOL[q.dtype]
    assert bool((lse[~live] <= -0.5e30).all())
    return out


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_fwd_bf16_every_head_dim(dev, d):
    """Every head_dim the wrapper takes (a multiple of 8 in [8, 128]) runs
    on the tensor-core forward, causal over a ragged S and non-causal with
    padded keys."""
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn(2, 2, 150, d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    _check_fwd(q, k, v, True)
    mask = torch.ones(2, 150, device=dev)
    mask[1, 61:] = 0
    _check_fwd(q, k, v, False, mask)


def test_flash_fwd_bf16_strided_training_operands_need_no_copy(dev):
    """q, k, v as the training step and the serving prefill hand them over
    (strided views of one [B,S,3,H,D] qkv projection, row stride 2304) are
    streamed as they are, without a copy."""
    from sparkflow_tpu_torch.ops.attention import _cp_async_ready
    g = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn(2, 333, 3, 12, 64, generator=g, device=dev).to(
        torch.bfloat16).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert q.stride(2) == 3 * 12 * 64
    assert all(_cp_async_ready(t) is t for t in (q, k, v))
    _check_fwd(q, k, v, True)


def test_flash_fwd_bf16_misaligned_operand_is_copied(dev):
    """A k whose pointer is not 16-byte aligned is copied to aligned memory
    before the launch: the result equals that of the aligned operand."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(1, 2, 200, 64, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)
    k_odd = buf[1:].view(k.shape).copy_(k)
    assert k_odd.data_ptr() % 16 != 0
    a = flash_attention(q, k, v, causal=True, return_lse=True)
    b = flash_attention(q, k_odd, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_flash_fwd_bf16_all_padding_row_averages_uniformly(dev):
    """Non-causal, padded keys; batch row 2's keys are all padding: its
    output is the uniform average of its values, as in JAX."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(3, 4, 300, 64, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    mask = torch.ones(3, 300, device=dev)
    mask[0, 250:] = 0
    mask[1, 77:] = 0
    mask[2] = 0
    out = _check_fwd(q, k, v, False, mask)
    uniform = v[2].float().mean(1, keepdim=True).expand(4, 300, 64)
    assert _max_err(out[2], uniform) < FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_fwd_repeats_bit_for_bit(dev, dtype):
    """Two launches on the same inputs give the same bits."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(2, 12, 700, 64, generator=g, device=dev).to(dtype)
               for _ in range(3))
    a = flash_attention(q, k, v, causal=True, return_lse=True)
    b = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _bwd_case(dev, dtype, b, s, causal, mask_rows=(), seed=0, h=12, d=64):
    """Inputs of the backward kernels: q, k, v, the forward's O and
    logsumexp (through the forward kernel), a non-uniform cotangent and the
    key mask (``mask_rows``: per batch row, the first padded key)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, s, d, generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    mask = None
    if mask_rows:
        mask = torch.ones(b, s, device=dev)
        for i, first in enumerate(mask_rows):
            mask[i, first:] = 0
    out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                               return_lse=True)
    return q, k, v, out, lse, dout, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(b=2, s=128, causal=True),
    dict(b=1, s=700, causal=True),               # ragged edges of S and Sk
    dict(b=2, s=1024, causal=True),
    dict(b=3, s=256, causal=False, mask_rows=(200, 77, 0)),  # row 2 all pad
], ids=["s128", "s700", "s1024", "masked"])
def test_flash_bwd_kernels_match_plain(dev, dtype, case):
    from sparkflow_tpu_torch.ops import (flash_attention_backward,
                                         flash_attention_backward_reference,
                                         flash_bwd_dkv, flash_bwd_dq)
    q, k, v, out, lse, dout, mask = _bwd_case(dev, dtype, **case)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_backward(q, k, v, out, lse, dout, case["causal"],
                                   kv_mask=mask)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_backward_reference(q, k, v, out, lse, dout,
                                              case["causal"], kv_mask=mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        scale = float(b.float().abs().max())
        assert _max_err(a, b) <= BWD_TOL[dtype] * scale, name
    if case.get("mask_rows"):
        # all keys of batch row 2 are padding: zero gradient, as in JAX
        assert torch.all(got[0][2] == 0) and torch.all(got[1][2] == 0)


def _check_bwd(got, want, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        scale = float(b.float().abs().max())
        assert _max_err(a, b) <= BWD_TOL[dtype] * scale, name


@pytest.mark.parametrize("d", [40, 64, 128])
def test_flash_bwd_bf16_head_dims_ragged(dev, d):
    """The tensor-core kernels at a padded head_dim (40 -> 48), GPT-2's 64
    and the largest, 128, over ragged S = 700, causal."""
    from sparkflow_tpu_torch.ops import (flash_attention_backward,
                                         flash_attention_backward_reference)
    q, k, v, out, lse, dout, mask = _bwd_case(dev, torch.bfloat16, 1, 700,
                                              True, seed=d, h=4, d=d)
    got = flash_attention_backward(q, k, v, out, lse, dout, True)
    torch.cuda.synchronize()
    _check_bwd(got, flash_attention_backward_reference(
        q, k, v, out, lse, dout, True), torch.bfloat16)


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_bwd_bf16_every_head_dim(dev, d):
    """Every head_dim the wrapper takes (a multiple of 8 in [8, 128]) runs
    on the bf16 kernels, non-causal with padded keys."""
    from sparkflow_tpu_torch.ops import (flash_attention_backward,
                                         flash_attention_backward_reference)
    q, k, v, out, lse, dout, mask = _bwd_case(
        dev, torch.bfloat16, 2, 150, False, mask_rows=(150, 61), seed=d,
        h=2, d=d)
    got = flash_attention_backward(q, k, v, out, lse, dout, False,
                                   kv_mask=mask)
    torch.cuda.synchronize()
    _check_bwd(got, flash_attention_backward_reference(
        q, k, v, out, lse, dout, False, kv_mask=mask), torch.bfloat16)


def _training_layout(dev, b, s, seed):
    """bf16 q, k, v as strided views of one [B,S,3,H,D] qkv projection and
    dO the [B,H,S,D] view of a [B,S,H,D] tensor, as the training step hands
    them to the backward kernels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3, 12, 64, generator=g, device=dev).to(
        torch.bfloat16).permute(2, 0, 3, 1, 4)
    dout = torch.randn(b, s, 12, 64, generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    q, k, v = qkv[0], qkv[1], qkv[2]
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    return q, k, v, out, lse, dout


def test_flash_bwd_bf16_strided_training_operands(dev):
    from sparkflow_tpu_torch.ops import (flash_attention_backward,
                                         flash_attention_backward_reference)
    q, k, v, out, lse, dout = _training_layout(dev, 2, 333, seed=7)
    assert q.stride(2) == 3 * 12 * 64 and dout.stride(2) == 12 * 64
    got = flash_attention_backward(q, k, v, out, lse, dout, True)
    torch.cuda.synchronize()
    _check_bwd(got, flash_attention_backward_reference(
        q, k, v, out, lse, dout, True), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_bwd_repeats_bit_for_bit(dev, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    from sparkflow_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq
    q, k, v, out, lse, dout, mask = _bwd_case(dev, dtype, 2, 640, True,
                                              seed=11)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, dout, lse, delta, True)
    first = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    second = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_bf16_misaligned_operand_is_copied(dev):
    """An operand whose pointer is not 16-byte aligned (a view at an odd
    element offset) is copied to aligned memory before the launch: the
    result equals that of the aligned operand."""
    from sparkflow_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq
    q, k, v, out, lse, dout, mask = _bwd_case(dev, torch.bfloat16, 1, 200,
                                              True, seed=5, h=2)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_odd = buf[1:].view(q.shape).copy_(q)
    assert q_odd.data_ptr() % 16 != 0
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        a = fn(q, k, v, dout, lse, delta, True)
        b = fn(q_odd, k, v, dout, lse, delta, True)
        torch.cuda.synchronize()
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_flash_attention_autograd_goes_through_the_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(2, 96, 3, 4, 32, generator=g, device=dev,
                      requires_grad=True)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)          # strided views, as the model
    counts = (flash_attention.launches, *_bwd_launches())
    out = flash_attention(q, k, v, causal=True)
    out.transpose(1, 2).square().sum().backward()
    assert (flash_attention.launches, *_bwd_launches()) == tuple(
        c + 1 for c in counts)
    ref_qkv = qkv.detach().clone().requires_grad_(True)
    rq, rk, rv = ref_qkv.permute(2, 0, 3, 1, 4)
    attention_reference(rq, rk, rv, causal=True).transpose(
        1, 2).square().sum().backward()
    assert _max_err(qkv.grad, ref_qkv.grad) <= 1e-4 * float(
        ref_qkv.grad.abs().max())


def _bwd_launches():
    from sparkflow_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq
    return flash_bwd_dq.launches, flash_bwd_dkv.launches


def _paged_inputs(dev, dtype, seed=0):
    b, h, d, page, maxp, num_pages = 8, 12, 64, 16, 64, 513
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    kp = torch.randn(num_pages, page, h, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(num_pages, page, h, d, generator=g, device=dev).to(dtype)
    lengths = torch.tensor([0, 1, 17, 100, 255, 512, 700, 1024],
                           dtype=torch.int32, device=dev)
    rs = np.random.RandomState(seed)
    table = rs.permutation(np.arange(1, num_pages))[:b * maxp].reshape(b, maxp)
    table[3, :2] = table[2, :2]      # slot 3 aliases slot 2's first pages
    table[0] = 0                     # the empty slot reads scratch page 0
    table = torch.as_tensor(table, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_matches_plain(dev, dtype):
    q, kp, vp, table, lengths = _paged_inputs(dev, dtype)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(q, kp, vp, table, lengths)
    assert _max_err(out, ref) < PAGED_TOL[dtype]
    assert torch.all(out[0] == 0)
    assert torch.isfinite(out.float()).all()


def test_paged_kernel_ignores_rows_past_length(dev):
    q, kp, vp, table, lengths = _paged_inputs(dev, torch.float32, seed=1)
    out1 = paged_attention(q, kp, vp, table, lengths)
    kp2, vp2 = kp.clone(), vp.clone()
    last = int(table[2, 1])          # slot 2 holds 17 tokens: row 1 of page 1
    kp2[last, 1:] = 1e4
    vp2[last, 1:] = -1e4
    out2 = paged_attention(q, kp2, vp2, table, lengths)
    torch.cuda.synchronize()
    assert _max_err(out1[2], out2[2]) == 0.0


def test_engine_on_card_matches_plain_forward(dev):
    """A small LM served through both kernels gives the greedy tokens of
    its own dense forward over the plain attention."""
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    from sparkflow_tpu_torch.ops import attention_reference as plain
    from sparkflow_tpu_torch.serving import DecodeEngine
    spec = build_registry_spec("transformer_lm", vocab_size=97, hidden=64,
                               num_layers=2, num_heads=4, mlp_dim=128,
                               max_len=64)
    model = model_from_json(spec, device="cuda")
    params = model.init(seed=3)
    for t in params["block_0"].values():     # wander instead of repeating
        t.mul_(10.0)
    eng = DecodeEngine(model, params, num_slots=4, page_size=8)
    f0, p0 = flash_attention.launches, paged_attention.launches
    prompt = [5, 9, 2, 40, 17, 3, 3, 60, 1, 8, 22]
    info = eng.prefill(prompt, max_new_tokens=8)
    toks = [info["token"]]
    while len(toks) < 8:
        toks.extend(eng.step()[info["slot"]])
    eng.release(info["slot"])
    assert flash_attention.launches > f0 and paged_attention.launches > p0
    ids = list(prompt)
    with torch.inference_mode():
        for _ in range(8):
            lg = model._forward(params, {"input_ids": torch.tensor([ids])},
                                attention=plain)["logits"]
            ids.append(int(lg[0, -1].argmax()))
    assert toks == ids[len(prompt):]


def _tiny_lm_spec(**kw):
    from sparkflow_tpu_torch.models import build_registry_spec
    cfg = dict(vocab_size=97, hidden=64, num_layers=2, num_heads=4,
               mlp_dim=128, max_len=64, dropout=0.0)
    cfg.update(kw)
    return build_registry_spec("transformer_lm", **cfg)


def test_trainer_step_on_card_goes_through_the_kernels(dev):
    """One SGD step of the Trainer on the card launches each attention
    kernel once per layer and lands where the same step on the CPU (the
    plain versions) lands."""
    from sparkflow_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq
    from sparkflow_tpu_torch.trainer import Trainer
    spec = _tiny_lm_spec()
    toks = np.random.default_rng(0).integers(0, 97, (8, 64)).astype(
        np.float32)
    kw = dict(optimizer="gradient_descent", learning_rate=0.1, iters=1,
              mini_batch_size=8, seed=0)
    cpu = Trainer(spec, "input_ids", None, device="cpu", **kw)
    want = cpu.fit(toks)
    counts = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    card = Trainer(spec, "input_ids", None, **kw)
    got = card.fit(toks)         # the same seed draws the same weights (CPU)
    assert (flash_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 2 for c in counts)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    for a, b in zip(card.weights_list(), cpu.weights_list()):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_remat_on_card_recomputes_the_forward_kernel(dev):
    """remat=True: the backward reruns each block's forward, so flash_fwd
    launches twice per layer; dropout draws repeat and the fit equals the
    one without remat."""
    from sparkflow_tpu_torch.trainer import Trainer
    toks = np.random.default_rng(1).integers(0, 97, (8, 64)).astype(
        np.float32)
    fits = []
    for remat in (False, True):
        before = flash_attention.launches
        tr = Trainer(_tiny_lm_spec(dropout=0.1, remat=remat), "input_ids",
                     None, optimizer="adam", learning_rate=1e-3, iters=1,
                     mini_batch_size=8, seed=3)
        res = tr.fit(toks)
        fits.append((flash_attention.launches - before, res.losses,
                     tr.weights_list()))
    assert fits[0][0] == 2 and fits[1][0] == 4
    assert fits[0][1] == fits[1][1]
    for a, b in zip(fits[0][2], fits[1][2]):
        np.testing.assert_array_equal(a, b)


def test_remat_dots_on_card_recomputes_flash_fwd_and_matches_no_remat(dev):
    """remat="dots" keeps the weight products' outputs and recomputes the
    rest: flash_fwd launches twice per layer, as with remat=True, and
    with the same dropout draws the fit equals the one without remat."""
    from sparkflow_tpu_torch.trainer import Trainer
    toks = np.random.default_rng(1).integers(0, 97, (8, 64)).astype(
        np.float32)
    fits = []
    for remat in (False, "dots"):
        before = flash_attention.launches
        tr = Trainer(_tiny_lm_spec(dropout=0.1, remat=remat), "input_ids",
                     None, optimizer="adam", learning_rate=1e-3, iters=1,
                     mini_batch_size=8, seed=3)
        res = tr.fit(toks)
        fits.append((flash_attention.launches - before, res.losses,
                     tr.weights_list()))
    assert fits[0][0] == 2 and fits[1][0] == 4
    assert fits[0][1] == fits[1][1]
    for a, b in zip(fits[0][2], fits[1][2]):
        np.testing.assert_array_equal(a, b)


def test_preempted_fit_resumed_on_card_equals_the_uninterrupted_fit(
        dev, tmp_path):
    """A float32 BERT-width classifier (768 / 12 heads / 3072, cut to 2
    layers and 128 tokens, dropout 0.1, adam) preempted by SIGTERM in epoch
    2 of 3 and fitted again on the same checkpoint_dir lands on the
    uninterrupted fit's weights, bit for bit: the kernels use no atomics and
    the restored generators repeat the dropout and shuffle streams."""
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.resilience import faults
    from sparkflow_tpu_torch.trainer import Trainer
    spec = build_registry_spec("transformer_classifier", vocab_size=30522,
                               num_classes=2, hidden=768, num_layers=2,
                               num_heads=12, mlp_dim=3072, max_len=128,
                               dropout=0.1)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 30522, (32, 128)).astype(np.float32)
    mask = (np.arange(128)[None] < rs.randint(64, 129, (32, 1))).astype(
        np.float32)
    labels = rs.randint(0, 2, 32).astype(np.float32)

    def fit(ck, cb):
        tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                     optimizer="adam", learning_rate=3e-4, iters=3,
                     mini_batch_size=16, seed=1, checkpoint_dir=ck,
                     checkpoint_every=1, loss_callback=cb)
        return tr, tr.fit((ids, mask), labels)

    base_tr, base = fit(str(tmp_path / "a"), lambda *a: None)
    tr, first = fit(str(tmp_path / "b"), faults.sigterm_at(2))
    assert first.stop_reason == "preempted" and len(first.losses) == 2
    again = tr.fit((ids, mask), labels)
    assert again.completed and first.losses + again.losses == base.losses
    for a, b in zip(tr.weights_list(), base_tr.weights_list()):
        np.testing.assert_array_equal(a, b)


# -- quantized paged attention and paged verify attention ---------------------
#
# Tolerances as for the plain paged kernel: both sides compute in float32
# from the same stored rows and scales and round the output once.


def _quant_pools(kp, vp, pool):
    """``(rows, scales)`` of a float pool quantized to ``pool`` ("int8" /
    "fp8"), with a page-head of scale 0 (its rows all zero, so never
    written: head 3, or the last of fewer) and a page rescaled mid-fill (a
    late row with a larger absmax appended through the running-scale
    path)."""
    from sparkflow_tpu_torch.utils import quant
    kp, vp = kp.float().clone(), vp.float().clone()
    zero = min(3, kp.shape[2] - 1)
    kp[5, :, zero] = 0.0
    vp[5, :, zero] = 0.0
    out = []
    for pages in (kp, vp):
        rows, scales = quant.quantize_kv_pages(pages, pool)
        rows, scales = rows[None].clone(), scales[None].clone()
        late = 3.0 * pages[9, 7:8]                   # [1, H, D]
        quant.paged_quant_append(rows, scales, 0, torch.tensor(
            [9], device=kp.device), torch.tensor([7], device=kp.device), late)
        out.append((rows[0], scales[0]))
    assert bool((out[0][1][5, zero] == 0).item())
    return out


def _verify_starts(lengths, s):
    return (lengths - s).clamp(min=0).to(torch.int32)


@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_quant_kernel_matches_plain(dev, dtype, pool):
    q, kp, vp, table, lengths = _paged_inputs(dev, dtype, seed=2)
    table[5, 0] = 5                                  # reads the scale-0 head
    table[6, 1] = 9                                  # and the rescaled page
    (kq, ks), (vq, vs) = _quant_pools(kp, vp, pool)
    before = (paged_attention.launches, paged_attention.quant_launches)
    out = paged_attention(q, kq, vq, table, lengths, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.quant_launches) == (
        before[0], before[1] + 1)
    ref = paged_attention_reference(q, kq, vq, table, lengths, k_scales=ks,
                                    v_scales=vs)
    assert _max_err(out, ref) < PAGED_TOL[dtype]
    assert torch.all(out[0] == 0)


# -- the decode kernel's walk split over a thread-block cluster ---------------
#
# Each case runs one call over slots of every kind (empty, within one chunk,
# across chunks, the table's whole width), a page aliased by two slots and,
# quantized, a page-head of scale 0 and a page rescaled mid-fill; against
# the plain version, and launched twice for the same bits.

POOLS = [None, "int8", "fp8"]
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


def _decode_case(dev, dtype, pool, lengths, *, d=64, h=12, page=16, maxp=64,
                 seed=0):
    """q, pools and scales (as the engine holds them), table and lengths.
    An empty slot 0 reads scratch page 0, as the engine's idle lanes do;
    the last slot's first page aliases the one before it and, quantized,
    its second page is the scale-0 page-head (page 5, head 3) and the third
    page of the slot before it the rescaled page (page 9)."""
    b = len(lengths)
    num_pages = b * maxp + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    kp = torch.randn(num_pages, page, h, d, generator=g, device=dev)
    vp = torch.randn(num_pages, page, h, d, generator=g, device=dev)
    rs = np.random.RandomState(seed)
    table = rs.permutation(np.arange(1, num_pages))[:b * maxp].reshape(b, maxp)
    if lengths[0] == 0:
        table[0] = 0
    if b > 2:
        table[-1, 0] = table[-2, 0]
    scales = {}
    if pool is None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        table[-1, 1] = 5
        table[max(b - 2, 0), 2] = 9
        (kp, ks), (vp, vs) = _quant_pools(kp, vp, pool)
        scales = dict(k_scales=ks, v_scales=vs)
    return (q, kp, vp, torch.as_tensor(table, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev), scales)


def _check_decode(q, kp, vp, table, lengths, scales):
    """The kernel against its plain version, the empty slots exact zeros,
    and a second launch bit-identical; returns the output."""
    counter = "launches" if not scales else "quant_launches"
    before = getattr(paged_attention, counter)
    out = paged_attention(q, kp, vp, table, lengths, **scales)
    again = paged_attention(q, kp, vp, table, lengths, **scales)
    torch.cuda.synchronize()
    assert getattr(paged_attention, counter) == before + 2
    ref = paged_attention_reference(q, kp, vp, table, lengths, **scales)
    assert torch.isfinite(out.float()).all()
    assert _max_err(out, ref) < PAGED_TOL[q.dtype]
    assert torch.all(out[lengths == 0] == 0)
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("pool", POOLS)
@DTYPES
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_paged_decode_every_head_dim(dev, dtype, pool, d):
    """Every head_dim 8-128: 2 to 32 lanes a row, and 8-byte runs for an
    int8/fp8 row whose D is not a multiple of 16."""
    _check_decode(*_decode_case(dev, dtype, pool, (0, 1, 17, 100, 255, 700,
                                                   1024), d=d, h=4, seed=d))


@pytest.mark.parametrize("pool", POOLS)
@DTYPES
@pytest.mark.parametrize("page", [8, 16, 64])
def test_paged_decode_lengths_at_chunk_edges(dev, dtype, pool, page):
    """Lengths 0, 1, page-1, page, 127, 128, 129 and 255, 256, 257 (the
    edges of a 128-token chunk and of an int8/fp8 pool's 256-token one)
    and the table's whole 1024 tokens, in one call."""
    lengths = (0, 1, page - 1, page, 127, 128, 129, 255, 256, 257, 1024)
    _check_decode(*_decode_case(dev, dtype, pool, lengths, page=page,
                                maxp=1024 // page, seed=page))


@pytest.mark.parametrize("pool", POOLS)
@DTYPES
def test_paged_decode_one_long_slot(dev, dtype, pool):
    """B = 1 with 1024 tokens: the whole cluster works for one slot."""
    _check_decode(*_decode_case(dev, dtype, pool, (1024,), seed=11))


@pytest.mark.parametrize("pool", POOLS)
@DTYPES
def test_paged_decode_table_of_2048_tokens(dev, dtype, pool):
    """maxp * page = 2048: the chunk grows to 256 tokens (8 blocks), each
    block walking more than one trip of a bf16 or float32 pool."""
    _check_decode(*_decode_case(dev, dtype, pool,
                                (0, 1, 255, 256, 257, 1500, 2048), maxp=128,
                                seed=12))


@pytest.mark.parametrize("pool", POOLS)
@DTYPES
def test_paged_decode_replays_in_a_cuda_graph(dev, dtype, pool):
    """A call captured in a CUDA graph and replayed equals the eager call,
    and reads the lengths on the card at replay time: after new lengths are
    copied into the same tensor, a replay equals the eager call on them."""
    q, kp, vp, table, lengths, scales = _decode_case(
        dev, dtype, pool, (0, 1, 17, 100, 255, 512, 700, 1024), seed=13)
    want = paged_attention(q, kp, vp, table, lengths, **scales)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = paged_attention(q, kp, vp, table, lengths, **scales)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    lengths.copy_(torch.tensor([1024, 0, 900, 5, 129, 128, 16, 300],
                               dtype=torch.int32, device=dev))
    want = paged_attention(q, kp, vp, table, lengths, **scales)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("pool", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 5, 16])
def test_paged_verify_kernel_matches_plain(dev, dtype, pool, s):
    from sparkflow_tpu_torch.ops import (paged_attention_verify,
                                         paged_attention_verify_reference)
    _, kp, vp, table, lengths = _paged_inputs(dev, dtype, seed=3)
    g = torch.Generator(device=dev).manual_seed(s)
    # q as the model hands it over: a strided view of one qkv permutation
    qkv = torch.randn(8, s, 3, 12, 64, generator=g, device=dev).to(dtype)
    q = qkv.permute(2, 0, 3, 1, 4)[0]
    start = _verify_starts(lengths, s)
    scales = {}
    if pool is not None:
        table[5, 0] = 5
        (kp, ks), (vp, vs) = _quant_pools(kp, vp, pool)
        scales = dict(k_scales=ks, v_scales=vs)
    counter = "launches" if pool is None else "quant_launches"
    before = getattr(paged_attention_verify, counter)
    out = paged_attention_verify(q, kp, vp, table, start, **scales)
    torch.cuda.synchronize()
    assert getattr(paged_attention_verify, counter) == before + 1
    ref = paged_attention_verify_reference(q, kp, vp, table, start, **scales)
    assert out.shape == (8, 12, s, 64) and out.dtype == dtype
    assert _max_err(out, ref) < PAGED_TOL[dtype]


@pytest.mark.parametrize("pool", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 5, 16])
def test_paged_verify_split_walks_one_to_eight_chunks(dev, dtype, pool, s):
    """One call whose slots walk 1 to 8 chunks of 128 tokens (starts 0 to
    1024 - S, the table's end), over a page-head of scale 0 (quantized
    pools): within the tolerance of the plain version, and a second launch
    gives the same bits (the chunks are combined in a fixed order)."""
    from sparkflow_tpu_torch.ops import (paged_attention_verify,
                                         paged_attention_verify_reference)
    _, kp, vp, table, _ = _paged_inputs(dev, dtype, seed=8)
    g = torch.Generator(device=dev).manual_seed(20 + s)
    q = torch.randn(8, 12, s, 64, generator=g, device=dev).to(dtype)
    ends = torch.tensor([5, 200, 300, 400, 600, 700, 800, 1024], device=dev)
    start = (ends - s).clamp(min=0).to(torch.int32)
    start[0] = 0
    scales = {}
    if pool is not None:
        table[0, 0] = 5                              # the scale-0 page-head
        (kp, ks), (vp, vs) = _quant_pools(kp, vp, pool)
        scales = dict(k_scales=ks, v_scales=vs)
    out = paged_attention_verify(q, kp, vp, table, start, **scales)
    again = paged_attention_verify(q, kp, vp, table, start, **scales)
    torch.cuda.synchronize()
    ref = paged_attention_verify_reference(q, kp, vp, table, start, **scales)
    assert torch.isfinite(out.float()).all()
    assert _max_err(out, ref) < PAGED_TOL[dtype]
    assert torch.equal(out, again)


def test_paged_verify_one_row_is_the_decode_kernel(dev):
    """S = 1 is single-query decode attention with lengths = start + 1."""
    from sparkflow_tpu_torch.ops import paged_attention_verify
    q, kp, vp, table, lengths = _paged_inputs(dev, torch.float32, seed=4)
    start = _verify_starts(lengths, 1)
    one = paged_attention_verify(q[:, :, None], kp, vp, table, start)[:, :, 0]
    dec = paged_attention(q, kp, vp, table, start + 1)
    torch.cuda.synchronize()
    assert _max_err(one, dec) < PAGED_TOL[torch.float32]


def test_paged_verify_refuses_more_rows_than_the_kernel_takes(dev):
    from sparkflow_tpu_torch.ops import MAX_VERIFY_ROWS, paged_attention_verify
    _, kp, vp, table, lengths = _paged_inputs(dev, torch.float32)
    q = torch.zeros(8, 12, MAX_VERIFY_ROWS + 1, 64, device=dev)
    with pytest.raises(ValueError, match=str(MAX_VERIFY_ROWS)):
        paged_attention_verify(q, kp, vp, table, lengths)


@pytest.mark.parametrize("kw", [{"spec_k": 3}, {"kv_quant": "int8"},
                                {"spec_k": 3, "kv_quant": "int8"}],
                         ids=["spec", "int8", "spec-int8"])
def test_spec_and_quant_engine_on_card_match_the_cpu_engine(dev, kw):
    """Speculation and the quantized pool on the card give the greedy
    tokens of the same engine on the CPU (the plain versions), and the
    step goes through the new kernels."""
    from sparkflow_tpu_torch.convert import params_from_jax
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import DecodeEngine
    spec = _tiny_lm_spec()
    cpu_model = model_from_json(spec, device="cpu")
    params = cpu_model.init(seed=3)
    for t in params["block_0"].values():     # wander instead of repeating
        t.mul_(10.0)
    flat = [t.numpy() for layer in params.values() for t in layer.values()]
    card_model = model_from_json(spec, device="cuda")
    prompts = [[5, 9, 2, 40, 17, 3, 3, 60, 1, 8, 22], [7, 7, 7], list(
        range(1, 30))]
    got = {}
    for name, model, p in (("cpu", cpu_model, params),
                           ("card", card_model,
                            params_from_jax(card_model, flat))):
        eng = DecodeEngine(model, p, num_slots=4, page_size=8, **kw)
        reset_launch_counts()
        got[name] = []
        for prompt in prompts:
            info = eng.prefill(prompt, max_new_tokens=10)
            toks = [info["token"]]
            while len(toks) < 10:
                toks.extend(eng.step()[info["slot"]])
            eng.release(info["slot"])
            got[name].append(toks[:10])
        if name == "card":
            counts = launch_counts()
            quant = "kv_quant" in kw
            assert (counts["paged_attention_quant"] > 0) == quant
            assert (counts["paged_attention"] > 0) != quant
            if "spec_k" in kw:
                want = 2 * eng.stats()["spec"]["steps"]
                key = "paged_verify_quant" if quant else "paged_verify"
                assert counts[key] == want
    assert got["card"] == got["cpu"]


# -- the estimator's shapes: float32, S=512, non-causal, padded keys ---------

def test_estimator_shape_f32_kernels_match_plain(dev):
    """The three flash kernels at the BERT-base estimator's operands, cut
    to B=2: float32, H=12, S=512, D=64, non-causal, padded key tails as
    ``examples/bert_classifier.py``'s ``synthetic_text`` makes them (one
    row unpadded)."""
    from sparkflow_tpu_torch.ops import (flash_attention_backward,
                                         flash_attention_backward_reference,
                                         flash_bwd_dkv, flash_bwd_dq)
    q, k, v, out, lse, dout, mask = _bwd_case(
        dev, torch.float32, 2, 512, False, mask_rows=(301, 512), seed=5)
    _check_fwd(q, k, v, False, mask)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_backward(q, k, v, out, lse, dout, False,
                                   kv_mask=mask)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    _check_bwd(got, flash_attention_backward_reference(
        q, k, v, out, lse, dout, False, kv_mask=mask), torch.float32)


# -- the float32 backward on the tensor cores (3xTF32) -----------------------

def _bwd_f32(q, k, v, out, lse, dout, causal, mask=None):
    """The float32 backward through the kernels, checked against the plain
    backward; returns the kernels' (dq, dk, dv)."""
    from sparkflow_tpu_torch.ops import (flash_attention_backward,
                                         flash_attention_backward_reference)
    got = flash_attention_backward(q, k, v, out, lse, dout, causal,
                                   kv_mask=mask)
    torch.cuda.synchronize()
    _check_bwd(got, flash_attention_backward_reference(
        q, k, v, out, lse, dout, causal, kv_mask=mask), torch.float32)
    return got


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_bwd_f32_every_head_dim(dev, d):
    """Every head_dim the float32 entry takes (a multiple of 8 in [8, 128]),
    each its own 3xTF32 instantiation: causal over a ragged S = 150, and
    non-causal with padded keys."""
    for causal, rows in ((True, ()), (False, (150, 61))):
        q, k, v, out, lse, dout, mask = _bwd_case(
            dev, torch.float32, 2, 150, causal, mask_rows=rows, seed=d, h=2,
            d=d)
        _bwd_f32(q, k, v, out, lse, dout, causal, mask)


def test_flash_bwd_f32_keys_of_another_length(dev):
    """S = 77 queries against S_k = 200 padded keys: the dq kernel's walk
    and the dkv kernel's grid follow S_k, each ragged edge masked."""
    g = torch.Generator(device=dev).manual_seed(17)
    q, dout = (torch.randn(2, 3, 77, 64, generator=g, device=dev)
               for _ in range(2))
    k, v = (torch.randn(2, 3, 200, 64, generator=g, device=dev)
            for _ in range(2))
    mask = torch.ones(2, 200, device=dev)
    mask[1, 130:] = 0
    out, lse = flash_attention(q, k, v, kv_mask=mask, return_lse=True)
    _bwd_f32(q, k, v, out, lse, dout, False, mask)


def test_flash_bwd_f32_strided_training_operands_need_no_copy(dev):
    """float32 q, k, v as the estimator's training step hands them over
    (strided views of one [B,S,3,H,D] qkv projection, row stride 2304) and
    dO as the [B,H,S,D] view of a [B,S,H,D] tensor stream as they are."""
    from sparkflow_tpu_torch.ops.attention import _cp_async_ready
    g = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn(2, 333, 3, 12, 64, generator=g,
                      device=dev).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    dout = torch.randn(2, 333, 12, 64, generator=g,
                       device=dev).transpose(1, 2)
    assert q.stride(2) == 3 * 12 * 64 and dout.stride(2) == 12 * 64
    assert all(_cp_async_ready(t) is t for t in (q, k, v, dout))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    _bwd_f32(q, k, v, out, lse, dout, True)


def _misaligned_copy(q, how):
    """``q``'s values at a 4-byte offset (``"pointer"``) or with rows 66
    floats apart (``"stride"``): not ready for 16-byte cp.async copies."""
    if how == "pointer":
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
        odd = buf[1:].view(q.shape).copy_(q)
        assert odd.data_ptr() % 16 != 0
    else:
        buf = torch.empty(*q.shape[:3], q.shape[3] + 2, dtype=q.dtype,
                          device=q.device)
        odd = buf[..., :q.shape[3]].copy_(q)
        assert odd.stride(2) % 4 != 0
    return odd


@pytest.mark.parametrize("how", ["pointer", "stride"])
def test_flash_bwd_f32_misaligned_operand_is_copied(dev, how):
    """A float32 operand whose pointer is not 16-byte aligned, or whose
    sequence stride is not a multiple of 4 elements, is copied to aligned
    memory before the launch: the result equals the aligned operand's bit
    for bit."""
    from sparkflow_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq
    from sparkflow_tpu_torch.ops.attention import _cp_async_ready
    q, k, v, out, lse, dout, mask = _bwd_case(dev, torch.float32, 1, 200,
                                              True, seed=5, h=2)
    q_odd = _misaligned_copy(q, how)
    assert _cp_async_ready(q_odd) is not q_odd
    delta = (dout * out).sum(-1).contiguous()
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        a = fn(q, k, v, dout, lse, delta, True)
        b = fn(q_odd, k, v, dout, lse, delta, True)
        torch.cuda.synchronize()
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("how", ["pointer", "stride"])
def test_flash_bwd_f32_entry_refuses_misaligned_operand(dev, how):
    """The C entry points themselves refuse a float32 operand that 16-byte
    cp.async copies cannot stream: cudaErrorInvalidValue (1), no launch."""
    import ctypes
    from sparkflow_tpu_torch.ops import _build
    from sparkflow_tpu_torch.ops.attention import _seq_strides
    q, k, v, out, lse, dout, _ = _bwd_case(dev, torch.float32, 1, 96, True,
                                           seed=6, h=2)
    q_odd = _misaligned_copy(q, how)
    delta = (dout * out).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    common = (q_odd.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), None)
    st = _seq_strides(q_odd, k, v, dout, dq)
    assert lib.sf_flash_bwd_dq(0, *common, dq.data_ptr(), 1, 2, 96, 96, 64,
                               ctypes.addressof(st), 0.125, 1, stream) == 1
    st = _seq_strides(q_odd, k, v, dout, dk, dv)
    assert lib.sf_flash_bwd_dkv(0, *common, dk.data_ptr(), dv.data_ptr(), 1,
                                2, 96, 96, 64, ctypes.addressof(st), 0.125, 1,
                                stream) == 1


def test_flash_bwd_f32_padding_gets_zero_gradient(dev):
    """Non-causal, S = 300, padded keys: batch row 1's keys are all padding
    (dQ = dK = dV = 0, as in JAX), row 0 is padded from key 130 and row 2
    has a hole of padding over keys 64-191 (two whole 64-key tiles, which
    the dq kernel skips) — padded keys get exactly zero dK and dV, the rest
    is within the tolerance of the plain backward."""
    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v, dout = (torch.randn(3, 4, 300, 64, generator=g, device=dev)
                     for _ in range(4))
    mask = torch.ones(3, 300, device=dev)
    mask[0, 130:] = 0
    mask[1] = 0
    mask[2, 64:192] = 0
    out, lse = flash_attention(q, k, v, kv_mask=mask, return_lse=True)
    dq, dk, dv = _bwd_f32(q, k, v, out, lse, dout, False, mask)
    assert torch.all(dq[1] == 0)
    padded = (mask == 0)[:, None, :, None].expand_as(dk)
    assert torch.all(dk[padded] == 0) and torch.all(dv[padded] == 0)
    assert bool((dk[~padded] != 0).any())


def test_flash_bwd_f32_replays_in_a_cuda_graph(dev):
    """The float32 dq and dk/dv calls captured in a CUDA graph and replayed
    equal the eager calls; after new dO, D and mask values are copied into
    the same tensors, a replay equals the eager calls on them."""
    from sparkflow_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq
    q, k, v, out, lse, dout, mask = _bwd_case(
        dev, torch.float32, 2, 300, False, mask_rows=(300, 140), seed=21, h=4)
    delta = (dout * out).sum(-1).contiguous()

    def calls():
        return (flash_bwd_dq(q, k, v, dout, lse, delta, kv_mask=mask),
                *flash_bwd_dkv(q, k, v, dout, lse, delta, kv_mask=mask))

    want = calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = calls()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g = torch.Generator(device=dev).manual_seed(22)
    dout.copy_(torch.randn(dout.shape, generator=g, device=dev))
    delta.copy_((dout * out).sum(-1))
    mask[1, 200:] = 1
    want = calls()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- the float32 forward on the tensor cores (3xTF32) ------------------------

@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_fwd_f32_every_head_dim(dev, d):
    """Every head_dim the float32 entry takes (a multiple of 8 in [8, 128]),
    each its own 3xTF32 instantiation: causal over a ragged S = 150, and
    non-causal with padded keys."""
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn(2, 2, 150, d, generator=g, device=dev)
               for _ in range(3))
    _check_fwd(q, k, v, True)
    mask = torch.ones(2, 150, device=dev)
    mask[1, 61:] = 0
    _check_fwd(q, k, v, False, mask)


def test_flash_fwd_f32_strided_training_operands_need_no_copy(dev):
    """float32 q, k, v as the estimator's step hands them over (strided
    views of one [B,S,3,H,D] qkv projection, row stride 2304) stream as
    they are, without a copy."""
    from sparkflow_tpu_torch.ops.attention import _cp_async_ready
    g = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn(2, 333, 3, 12, 64, generator=g,
                      device=dev).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert q.stride(2) == 3 * 12 * 64
    assert all(_cp_async_ready(t) is t for t in (q, k, v))
    _check_fwd(q, k, v, True)
    mask = torch.ones(2, 333, device=dev)
    mask[0, 200:] = 0
    _check_fwd(q, k, v, False, mask)


@pytest.mark.parametrize("how", ["pointer", "stride"])
def test_flash_fwd_f32_misaligned_operand_is_copied(dev, how):
    """A float32 k whose pointer is not 16-byte aligned, or whose sequence
    stride is not a multiple of 4 elements, is copied to aligned memory
    before the launch: the result equals the aligned operand's bit for
    bit."""
    from sparkflow_tpu_torch.ops.attention import _cp_async_ready
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(1, 2, 200, 64, generator=g, device=dev)
               for _ in range(3))
    k_odd = _misaligned_copy(k, how)
    assert _cp_async_ready(k_odd) is not k_odd
    a = flash_attention(q, k, v, causal=True, return_lse=True)
    b = flash_attention(q, k_odd, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("how", ["pointer", "stride"])
def test_flash_fwd_f32_entry_refuses_misaligned_operand(dev, how):
    """The C entry itself refuses a float32 operand that 16-byte cp.async
    copies cannot stream: cudaErrorInvalidValue (1), no launch."""
    import ctypes
    from sparkflow_tpu_torch.ops import _build
    from sparkflow_tpu_torch.ops.attention import _seq_strides
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(1, 2, 96, 64, generator=g, device=dev)
               for _ in range(3))
    q_odd = _misaligned_copy(q, how)
    o = torch.empty_like(q)
    st = _seq_strides(q_odd, k, v, o)
    lib = _build.load()
    assert lib.sf_flash_fwd(
        0, q_odd.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
        None, 1, 2, 96, 96, 64, ctypes.addressof(st), 0.125, 1,
        torch.cuda.current_stream().cuda_stream) == 1


def test_flash_fwd_f32_all_padding_row_averages_uniformly(dev):
    """Non-causal, S = 300, padded keys: batch row 2's keys are all padding
    (its output is the uniform average of its values and its logsumexp
    NEG_INF, as in JAX), row 0 is padded from key 250 and row 1 has a hole
    of padding over keys 64-191 (two whole 64-key tiles, which the kernel
    skips)."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(3, 4, 300, 64, generator=g, device=dev)
               for _ in range(3))
    mask = torch.ones(3, 300, device=dev)
    mask[0, 250:] = 0
    mask[1, 64:192] = 0
    mask[2] = 0
    out = _check_fwd(q, k, v, False, mask)
    uniform = v[2].mean(1, keepdim=True).expand(4, 300, 64)
    assert _max_err(out[2], uniform) < FLASH_TOL[torch.float32]


@pytest.mark.parametrize("s", [1, 700])
def test_flash_fwd_f32_ragged_sequence(dev, s):
    """A ragged S of 700 (not a multiple of the 64-row and 64-key tiles)
    and a single query, causal and with a padded key tail."""
    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn(2, 3, s, 64, generator=g, device=dev)
               for _ in range(3))
    _check_fwd(q, k, v, True)
    mask = torch.ones(2, s, device=dev)
    mask[1, s // 2 + 1:] = 0
    _check_fwd(q, k, v, False, mask)
    _check_fwd(q, k, v, True, mask)


def test_flash_fwd_f32_replays_in_a_cuda_graph(dev):
    """The float32 forward captured in a CUDA graph and replayed equals the
    eager call; after new q values and a new mask are copied into the same
    tensors, a replay equals the eager call on them."""
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn(2, 4, 300, 64, generator=g, device=dev)
               for _ in range(3))
    mask = torch.ones(2, 300, device=dev)
    mask[1, 140:] = 0

    def call():
        return flash_attention(q, k, v, kv_mask=mask, return_lse=True)

    want = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    q.copy_(torch.randn(q.shape, generator=g, device=dev))
    mask[1, 140:200] = 1
    mask[0, 30:] = 0
    want = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_graph_model_conv_on_card_matches_cpu(dev):
    """An ``nn`` graph's SAME convolution and pool at stride 2 on the card
    against the same graph and weights on the CPU, forward and weight
    gradients, float32 (the op turns cuDNN's TF32 off): within 1e-5
    absolute plus 1e-5 relative."""
    import sparkflow_tpu_torch.nn as nn
    from sparkflow_tpu_torch.graph_utils import build_graph
    from sparkflow_tpu_torch.graphdef import GraphModel

    def cnn():
        x = nn.placeholder([None, 15, 16, 3], name="x")
        y = nn.placeholder([None, 4], name="y")
        h = nn.conv2d(x, 8, 3, strides=2, padding="same", activation="relu")
        h = nn.avg_pooling2d(h, 3, strides=2, padding="same")
        out = nn.dense(nn.flatten(h), 4, name="out")
        nn.softmax_cross_entropy(y, out)

    spec = build_graph(cnn)
    cpu = GraphModel.from_json(spec, device="cpu")
    card = GraphModel.from_json(spec, device=dev)
    tree = cpu.init(seed=0)
    rs = np.random.RandomState(0)
    feeds = {"x": torch.from_numpy(rs.normal(0, 1, (6, 15, 16, 3))
                                   .astype(np.float32)),
             "y": torch.eye(4)[rs.randint(0, 4, 6)]}
    results = []
    for model in (cpu, card):
        p = {ln: {pn: t.to(model.device).requires_grad_(True)
                  for pn, t in layer.items()} for ln, layer in tree.items()}
        out = model.apply(p, feeds, ["out:0"])["out:0"]
        loss = model.loss_vector(p, feeds).sum()
        grads = torch.autograd.grad(loss, [p[ln][pn] for ln in p
                                           for pn in p[ln]])
        results.append([t.detach().cpu() for t in (out, *grads)])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


# -- the predict plane: InferenceEngine and int8 weights ----------------------

PREDICT_CLS = dict(vocab_size=500, num_classes=3, hidden=128, num_layers=2,
                   num_heads=2, mlp_dim=256, max_len=128, dropout=0.0)
# probs, card against CPU: float32 1e-4 (3xTF32 flash, TF32 off in the
# GEMMs); bf16 2e-2 (bf16 GEMMs and flash on both sides, different
# summation and rounding); int8 weight_only 1e-4 (float32 once
# dequantized); dynamic 1e-3 (an activation on an int8 rounding boundary
# may round apart between the devices, as between the packages —
# tests/test_torch_estimator.py QUANT_TOL)
PREDICT_TOL = {None: 1e-4, "bfloat16": 2e-2, "weight_only": 1e-4,
               "dynamic": 1e-3}


def _predict_rows(n, seed):
    rs = np.random.RandomState(seed)
    s = PREDICT_CLS["max_len"]
    ids = rs.randint(1, PREDICT_CLS["vocab_size"], (n, s)).astype(np.int32)
    mask = np.zeros((n, s), np.float32)
    for i in range(n):
        mask[i, :rs.randint(s // 2, s + 1)] = 1.0
    return ids, mask


@pytest.mark.parametrize("arm", [None, "bfloat16", "weight_only", "dynamic"],
                         ids=["f32", "bf16", "weight_only", "dynamic"])
def test_inference_engine_on_card_matches_cpu(dev, arm):
    """The predict engine on the card against the same engine on the CPU,
    every bucket (1..8) and a chunked request; the forward launches the
    flash kernel once a layer per bucket call, nothing else."""
    from sparkflow_tpu_torch.convert import params_to_list
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import InferenceEngine
    spec = build_registry_spec("transformer_classifier", **PREDICT_CLS)
    cpu_model = model_from_json(spec, device="cpu")
    weights = params_to_list(cpu_model, cpu_model.init(seed=3))
    kw = dict(input_name=["input_ids:0", "attention_mask:0"],
              output_name="probs:0", max_batch=8,
              quantize=arm if arm in ("weight_only", "dynamic") else None,
              quant_min_size=1024,
              compute_dtype="bfloat16" if arm == "bfloat16" else None)
    card = InferenceEngine(spec, weights, **kw)
    cpu = InferenceEngine(spec, weights, device="cpu", warmup=False, **kw)
    assert card.device.type == "cuda" and card.aot_compiles == 4
    for n in (1, 3, 8, 11):
        x = _predict_rows(n, seed=n)
        reset_launch_counts()
        got = card.predict(x)
        counts = launch_counts()
        calls = -(-n // 8)
        assert counts["flash_fwd"] == PREDICT_CLS["num_layers"] * calls
        assert sum(counts.values()) == counts["flash_fwd"]
        want = cpu.predict(x)
        assert got.shape == want.shape == (n, PREDICT_CLS["num_classes"])
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() < PREDICT_TOL[arm]
    assert card.fallback_compiles == 0


@pytest.mark.parametrize("m,k,n", [(2048, 768, 2304), (1, 768, 2),
                                   (16, 64, 64), (33, 100, 30)],
                         ids=lambda v: str(v))
def test_int8_matmul_on_card_matches_cpu(dev, m, k, n):
    """The int32 product on the card (torch._int_mm, padded where a shape
    breaks its rule) equals the CPU's exactly, and so does the rescaled
    result of ``int8_matmul``; the quantized tree built on the card is
    bit-equal to the CPU's."""
    from sparkflow_tpu_torch.utils import quant
    rs = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rs.randn(k, n) * 0.05).astype(np.float32))
    q8, scale = quant.quantize_tensor(w)
    q8c, scalec = quant.quantize_tensor(w.to(dev))
    assert torch.equal(q8c.cpu(), q8) and torch.equal(scalec.cpu(), scale)
    xq = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8))
    want = quant._int_mm(xq, q8)
    assert torch.equal(quant._int_mm(xq.to(dev), q8c).cpu(), want)
    got = quant.int8_matmul(x.to(dev), q8c, scalec).cpu()
    assert torch.equal(got, quant.int8_matmul(x, q8, scale))


# -- cold start: the kernel library from a store, with no nvcc ---------------

_COLDSTART_PROBE = """
import json, sys
import torch
from sparkflow_tpu_torch.ops import _build, attention_reference, flash_attention
from sparkflow_tpu_torch.serving.coldstart import ExecutableStore, boot_kernels
torch.backends.cuda.matmul.allow_tf32 = False
store = ExecutableStore(sys.argv[1]) if sys.argv[1] != "-" else None
boot = boot_kernels(store, None, torch.device("cuda"))
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(2, 12, 512, 64, generator=g, device="cuda")
           for _ in range(3))
out = flash_attention(q, k, v, causal=True)
ref = attention_reference(q, k, v, causal=True)
torch.cuda.synchronize()
print(json.dumps({"boot": boot, "err": float((out - ref).abs().max()),
                  "launches": flash_attention.launches,
                  "report": _build.ptxas_report()}))
"""


def _no_nvcc_env(kernel_dir):
    """An environment whose ``PATH`` and ``CUDA_HOME`` reach no nvcc, with
    an empty kernel build directory."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH", "PYTHONPATH")}
    env.update(
        PATH=os.pathsep.join(d for d in env.get("PATH", "").split(os.pathsep)
                             if d and not os.path.exists(
                                 os.path.join(d, "nvcc"))),
        CUDA_HOME=str(kernel_dir), SPARKFLOW_TORCH_KERNEL_DIR=str(kernel_dir),
        PYTHONPATH=repo)
    return env


def _probe(store_arg, kernel_dir):
    import subprocess
    import sys
    kernel_dir.mkdir()
    return subprocess.run([sys.executable, "-c", _COLDSTART_PROBE, store_arg],
                          env=_no_nvcc_env(kernel_dir), capture_output=True,
                          text=True, timeout=600)


def test_coldstart_store_boots_flash_without_nvcc(dev, tmp_path):
    """A process with an empty build directory and no nvcc loads the
    library from the store (tier 1) and launches flash_fwd within its
    plain version's limit; the stored ptxas reports come with it."""
    import json
    from sparkflow_tpu_torch.ops import _build
    from sparkflow_tpu_torch.serving.coldstart import (ExecutableStore,
                                                       kernel_key)
    _build.load()
    store = ExecutableStore(str(tmp_path / "exe"))
    assert store.save(kernel_key(), _build.loaded()["path"],
                      _build.ptxas_report())
    r = _probe(str(tmp_path / "exe"), tmp_path / "kernels")
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["boot"]["tier"] == 1 and res["boot"]["source"] == "store"
    assert res["launches"] == 1
    assert res["err"] < FLASH_TOL[torch.float32]
    assert res["report"] == _build.ptxas_report()
    # nothing was compiled there: the verified copy is all it holds
    assert [f for f in (tmp_path / "kernels").iterdir()
            if not f.name.endswith(".stored.so")] == []


def test_coldstart_without_store_or_nvcc_raises(dev, tmp_path):
    """With no store and no nvcc the same process raises the build's
    "nvcc not found": it never falls back to the plain version."""
    r = _probe("-", tmp_path / "kernels")
    assert r.returncode != 0
    assert "nvcc not found" in r.stderr


# -- the other registry families: MoE dispatch, ResNet, LSTM / GRU ------------

def _on(tree, device, grad=False):
    return {k: v.detach().to(device).requires_grad_(grad)
            for k, v in tree.items()}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_slot_dispatch_on_card_matches_cpu(dev, top_k):
    """``_moe_mlp_slots`` at 512 tokens, 8 experts, capacity 1.25, a
    padding mask: the same routing (slot table) and, float32 with TF32
    off, the expert output, the aux loss and the gradients within 1e-5
    absolute plus 1e-5 relative of the CPU's."""
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    spec = build_registry_spec(
        "transformer_moe_lm", vocab_size=64, hidden=64, num_layers=2,
        num_heads=4, mlp_dim=128, max_len=256, num_experts=8,
        router_top_k=top_k)
    cpu = model_from_json(spec, device="cpu")
    card = model_from_json(spec, device=dev)
    bp = {k: v for k, v in cpu.init(seed=top_k)["block_1"].items()
          if k == "router" or k.startswith("experts_")}
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 256, 64, generator=g)
    mask = torch.ones(2, 256)
    mask[1, 200:] = 0.0
    results = []
    for model in (cpu, card):
        p = _on(bp, model.device, grad=True)
        xd = x.to(model.device)
        _, top_idx, _, _ = model.route(p, xd.reshape(-1, 64),
                                       mask.to(model.device))
        y, aux = model._moe_mlp_slots(p, xd, mask.to(model.device))
        grads = torch.autograd.grad((y * y).sum() + aux,
                                    [p[k] for k in sorted(p)])
        results.append([t.detach().cpu() for t in (top_idx, y, aux, *grads)])
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bottleneck", [False, True],
                         ids=["basic", "bottleneck"])
def test_resnet_block_on_card_matches_cpu(dev, bottleneck):
    """A strided residual block with its projection (SAME pads (0, 1) at
    stride 2 on 16 pixels, group norm, ReLU), forward and weight
    gradients, float32 (cuDNN's TF32 off): each tensor within 1e-5 of its
    largest entry on the CPU (the gradients reach ~180; float32 against
    float64 on the CPU lands within 1e-6 of it)."""
    from sparkflow_tpu_torch.models import ResNet
    model = ResNet(10, depth=50 if bottleneck else 18, image_size=32,
                   width=16, device="cpu")
    bp = model.init(seed=1)["stage1_block0"]
    block = model._bottleneck_block if bottleneck else model._basic_block
    cin = 64 if bottleneck else 16
    x = torch.randn(4, cin, 16, 16, generator=torch.Generator().manual_seed(2))
    results = []
    for device in ("cpu", dev):
        p = _on(bp, device, grad=True)
        y = block(p, x.to(device), 2)
        grads = torch.autograd.grad((y * y).sum(), [p[k] for k in sorted(p)])
        results.append([t.detach().cpu() for t in (y, *grads)])
    for a, b in zip(*results):
        assert _max_err(a, b) <= 1e-5 * float(a.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_steps_on_card_match_cpu(dev, cell, dtype):
    """20 steps of a 650-unit LSTM / GRU layer over a ragged mask, forward
    and gradients, each tensor within a share of its largest entry on the
    CPU: float32 (TF32 off) 1e-5 (float32 against float64 on the CPU
    lands within 4e-7); bf16 operands (float32 gate products and state on
    both devices) 2e-2 — the hidden state is rounded to bf16 before each
    step's product, so a last-bit float32 difference can move an operand
    by one bf16 ulp (2^-8) and compounds over the steps."""
    from sparkflow_tpu_torch.models.rnn import _gru_scan, _lstm_scan
    g = torch.Generator().manual_seed(3)
    gates = 4 if cell == "lstm" else 3
    h = 650
    kernel = torch.randn(2 * h, gates * h, generator=g) * 0.02
    bias = torch.randn(gates * h, generator=g) * 0.02
    x = torch.randn(20, 8, h, generator=g)
    mask = torch.ones(20, 8, 1)
    mask[11:, 3] = 0.0
    results = []
    for device in ("cpu", dev):
        k, b = (t.to(device).requires_grad_(True) for t in (kernel, bias))
        xd, md = x.to(device, dtype), mask.to(device)
        h0 = torch.zeros(8, h, device=device)
        if cell == "lstm":
            ys, hl, _ = _lstm_scan(xd, md, h0, h0, k, b)
        else:
            ys, hl = _gru_scan(xd, md, h0, k, b)
        gk, gb = torch.autograd.grad((ys * ys).sum() + hl.sum(), [k, b])
        results.append([t.detach().cpu() for t in (ys, hl, gk, gb)])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(*results):
        assert _max_err(a, b) <= tol * float(a.abs().max())


def test_hogwild_on_card_launches_the_flash_kernels(dev):
    """A two-layer ``transformer_classifier`` through
    ``HogwildSparkModel(...).train(rdd)`` on the card: 2 replica threads, 2
    pushes each; the three flash kernels launch 2 x (pushes + the warm-up
    gradient) times each (one per layer, forward and backward), and the
    fitted weights are finite."""
    from sparkflow_tpu_torch.HogwildSparkModel import HogwildSparkModel
    from sparkflow_tpu_torch.localml import RDD
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    spec = build_registry_spec("transformer_classifier", vocab_size=256,
                               num_classes=2, hidden=64, num_layers=2,
                               num_heads=4, mlp_dim=128, max_len=64,
                               dropout=0.1)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (16, 64)).astype(np.float32)
    labels = rs.randint(0, 2, 16).astype(np.float32)
    hw = HogwildSparkModel(tensorflowGraph=spec, tfInput="input_ids:0",
                           tfLabel="y:0", mini_batch=8, iters=2,
                           optimizer="adam")
    reset_launch_counts()
    weights = hw.train(RDD(list(zip(ids, labels)), 2))
    counts = launch_counts()
    st = hw.elastic_stats
    assert st["accepted"] > 0 and len(st["per_replica_accepted"]) == 2
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] == 2 * (st["pushes"] + 1), (name, counts)
    assert all(np.isfinite(w).all() for w in weights)


# -- ring attention over two ranks on the card ----------------------------------

@pytest.fixture(scope="module")
def card_ranks(dev):
    """Two rank processes on the card (gloo over CUDA tensors when they
    share one card, NCCL when each has its own)."""
    import torch_rank_tasks as tasks
    with tasks.rank_pool(2, device="cuda", timeout_s=300) as pool:
        yield pool


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "kv_mask"])
def test_ring_flash_on_card_matches_the_plain_ring(card_ranks, dtype, causal,
                                                   masked):
    """``ring_flash_attention`` (kernels 1-3 per visit) against the plain
    ring on two ranks, forward and backward: output within the flash
    tolerance, dq / dk / dv within the backward tolerance of the largest
    plain gradient; a causal ring launches each kernel 3 times summed over
    the ranks (the later shard's visit is skipped), a full one 4."""
    import torch_rank_tasks as tasks
    dt = getattr(torch, dtype)
    ours = card_ranks.run(tasks.ring, 0, causal, masked, (2, 4, 256, 64),
                          device="cuda", dtype=dtype)
    for o in ours:
        flash, plain = o["flash"], o["plain"]
        assert np.abs(flash[0] - plain[0]).max() < FLASH_TOL[dt]
        for got, want in zip(flash[1:], plain[1:]):
            assert np.abs(got - want).max() <= BWD_TOL[dt] * max(
                1e-6, np.abs(want).max())
    visits = 3 if causal else 4
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert sum(o["flash_launches"][name] for o in ours) == visits
        assert sum(o["plain_launches"][name] for o in ours) == 0


# -- kernels 1-7 at a tp shard's head count -------------------------------------
#
# Under tensor parallelism each shard runs the kernels on its heads: 6 of
# GPT-2 small's and BERT-base's 12 at tp=2, 3 at tp=4. No launch may assume
# 12 heads or an even head count (the decode kernel's cluster grid is
# (C, H, B); the verify split is per (slot, head)).

TP_HEADS = pytest.mark.parametrize("h", [6, 3], ids=["h6", "h3"])


@TP_HEADS
@DTYPES
def test_flash_kernels_at_a_tp_shards_heads(dev, dtype, h):
    """Kernels 1-3 (forward, dQ, dK/dV) at 6 and 3 heads: a causal GPT-2
    shape and a key-masked BERT one, against the plain versions."""
    from sparkflow_tpu_torch.ops import (flash_attention_backward,
                                         flash_attention_backward_reference,
                                         flash_bwd_dkv, flash_bwd_dq)
    for case in (dict(b=2, s=1024, causal=True),
                 dict(b=3, s=512, causal=False, mask_rows=(400, 77, 512))):
        q, k, v, out, lse, dout, mask = _bwd_case(dev, dtype, h=h, **case)
        _check_fwd(q, k, v, case["causal"], mask)
        before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
        got = flash_attention_backward(q, k, v, out, lse, dout,
                                       case["causal"], kv_mask=mask)
        torch.cuda.synchronize()
        assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
            before[0] + 1, before[1] + 1)
        _check_bwd(got, flash_attention_backward_reference(
            q, k, v, out, lse, dout, case["causal"], kv_mask=mask), dtype)


@TP_HEADS
@pytest.mark.parametrize("pool", POOLS)
@DTYPES
def test_paged_decode_at_a_tp_shards_heads(dev, dtype, pool, h):
    """Kernels 4-5 over a pool of 6 or 3 heads: every slot kind, a second
    launch bit-identical."""
    out = _check_decode(*_decode_case(dev, dtype, pool, (0, 1, 17, 100, 255,
                                                         700, 1024), h=h,
                                      seed=40 + h))
    assert out.shape[1] == h


@TP_HEADS
@pytest.mark.parametrize("pool", POOLS)
@DTYPES
@pytest.mark.parametrize("s", [1, 5])
def test_paged_verify_at_a_tp_shards_heads(dev, dtype, pool, h, s):
    """Kernels 6-7 (the split and its combine) over a pool of 6 or 3
    heads, against the plain version."""
    from sparkflow_tpu_torch.ops import (paged_attention_verify,
                                         paged_attention_verify_reference)
    _q, kp, vp, table, lengths, scales = _decode_case(
        dev, dtype, pool, (0, 1, 17, 100, 255, 700, 1024), h=h,
        seed=50 + h)
    g = torch.Generator(device=dev).manual_seed(60 + s)
    q = torch.randn(len(lengths), h, s, 64, generator=g, device=dev).to(
        dtype)
    start = _verify_starts(lengths, s)
    counter = "launches" if pool is None else "quant_launches"
    before = getattr(paged_attention_verify, counter)
    out = paged_attention_verify(q, kp, vp, table, start, **scales)
    torch.cuda.synchronize()
    assert getattr(paged_attention_verify, counter) == before + 1
    ref = paged_attention_verify_reference(q, kp, vp, table, start, **scales)
    assert out.shape == (len(lengths), h, s, 64) and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert _max_err(out, ref) < PAGED_TOL[dtype]


def test_tp_decode_engine_on_card_matches_the_cpu_engine(dev):
    """A tp=2 decode engine on the card (both shards on card 0 on a
    one-card machine) decodes the CPU tp engine's greedy tokens, plain and
    with spec_k and int8, and its shards launched the paged kernels."""
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    from sparkflow_tpu_torch.ops import paged_attention_verify
    from sparkflow_tpu_torch.serving import DecodeEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    spec = build_registry_spec("transformer_lm", vocab_size=97, hidden=64,
                               num_layers=2, num_heads=4, mlp_dim=128,
                               max_len=128, dropout=0.0)
    cpu = model_from_json(spec, device="cpu")
    params = cpu.init(seed=5)
    card = model_from_json(spec, device="cuda")
    tp = dict(mesh={"tp": 2}, sharding=ShardingConfig(tp_axis="tp"))
    for kw in ({}, {"spec_k": 3}, {"kv_quant": "int8"}):
        want = DecodeEngine(cpu, params, num_slots=2, page_size=16, seed=0,
                            **tp, **kw)
        got = DecodeEngine(card, params, num_slots=2, page_size=16, seed=0,
                           **tp, **kw)
        before = (paged_attention.launches + paged_attention.quant_launches
                  + paged_attention_verify.launches
                  + paged_attention_verify.quant_launches)
        for prompt in ([5, 2, 8, 1], list(range(1, 40))):
            a = _engine_tokens(want, prompt)
            b = _engine_tokens(got, prompt)
            assert a == b, kw
        after = (paged_attention.launches + paged_attention.quant_launches
                 + paged_attention_verify.launches
                 + paged_attention_verify.quant_launches)
        assert after > before


def _engine_tokens(eng, prompt, n=8):
    info = eng.prefill(prompt, max_new_tokens=n)
    toks = [] if info["token"] is None else [info["token"]]
    while len(toks) < n:
        toks.extend(eng.step().get(info["slot"], []))
    eng.release(info["slot"])
    return toks[:n]


# -- pipeline parallelism on the card -----------------------------------------


def test_pp_sgd_step_on_two_ranks_matches_one_card(card_ranks):
    """One pp=2 SGD step (1f1b, 4 microbatches) on two ranks sharing the
    card, float32 with TF32 off, against one card's step on the same rows:
    loss within 1e-5 relative, params within rtol 3e-4 / atol 3e-5 (phase
    21 (d)'s pin); each rank's stage ran the flash kernels."""
    import torch_rank_tasks as tasks
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = build_registry_spec("transformer_classifier", vocab_size=97,
                               num_classes=3, hidden=128, num_layers=4,
                               num_heads=2, mlp_dim=256, max_len=64,
                               dropout=0.0)
    cpu = model_from_json(spec, device="cpu")
    p0 = {k: {kk: v.numpy() for kk, v in d.items()}
          for k, d in cpu.init(seed=3).items()}
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 97, (8, 64)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    out = card_ranks.run(tasks.pp_steps, spec, {"pp": 2}, p0, ids, y,
                         "1f1b", 4, "classifier", device="cuda")
    card = model_from_json(spec, device="cuda")
    params = card.load_params({k: {kk: torch.tensor(v, device="cuda")
                                   for kk, v in d.items()}
                               for k, d in p0.items()}, trainable=True)
    loss = card.loss_vector(params, {
        "input_ids": torch.tensor(ids, device="cuda"),
        "y": torch.tensor(y, device="cuda")}, train=False).mean()
    leaves = [p for d in params.values() for p in d.values()]
    grads = iter(torch.autograd.grad(loss, leaves))
    for o in out:
        assert abs(o["losses"][0] - float(loss)) <= 1e-5 * abs(float(loss))
    for k, d in params.items():
        for kk, p in d.items():
            want = (p.detach() - 0.1 * next(grads)).cpu().numpy()
            np.testing.assert_allclose(out[0]["params"][k][kk], want,
                                       rtol=3e-4, atol=3e-5)
    assert all(o["moved"]["pp_hop"] > 0 for o in out)


def test_pp_decode_engine_on_card_matches_the_engine_without_a_mesh(dev):
    """Float32 (TF32 off): a pp=2 decode engine on the card (both stages on
    card 0 on a one-card machine) decodes the greedy tokens of the engine
    without a mesh, with waves, single-wave and spec_k, and its stages
    launched the paged kernels."""
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import DecodeEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = build_registry_spec("transformer_lm", vocab_size=97, hidden=128,
                               num_layers=4, num_heads=2, mlp_dim=256,
                               max_len=128, dropout=0.0)
    card = model_from_json(spec, device="cuda")
    params = card.init(seed=5)
    pp = dict(mesh={"pp": 2}, sharding=ShardingConfig(pp_axis="pp"))
    for kw in ({}, {"pp_wave": False}, {"spec_k": 3, "draft_layers": 2}):
        plain = {k: v for k, v in kw.items() if k != "pp_wave"}
        want = DecodeEngine(card, params, num_slots=2, page_size=16, seed=0,
                            **plain)
        got = DecodeEngine(card, params, num_slots=2, page_size=16, seed=0,
                           **pp, **kw)
        for prompt in ([5, 2, 8, 1], list(range(1, 40))):
            reset_launch_counts()
            toks = _engine_tokens(got, prompt)
            counts = launch_counts()
            assert counts["paged_attention"] > 0, kw
            assert counts["flash_fwd"] > 0, kw
            assert toks == _engine_tokens(want, prompt), kw


def test_ep_decode_engine_on_card_matches_the_engine_without_a_mesh(dev):
    """Float32 (TF32 off): an ep=2 and a tp=2 x ep=2 decode engine of a
    small MoE LM on the card (every shard on card 0 of a one-card machine)
    decode the greedy tokens of the engine without a mesh, plain and with
    spec_k, through the flash and paged kernels. The split banks run one
    product per expert (a batched product's kernel on the card follows its
    batch count), so the reference's model runs its whole bank so too."""
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import DecodeEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = build_registry_spec("transformer_moe_lm", vocab_size=97,
                               hidden=128, num_layers=4, num_heads=2,
                               mlp_dim=256, max_len=128, dropout=0.0,
                               num_experts=4, moe_every=2)
    card = model_from_json(spec, device="cuda")
    params = card.init(seed=6)
    ref = model_from_json(spec, device="cuda")
    ref.per_expert_products = True
    meshes = [dict(mesh={"ep": 2}, sharding=ShardingConfig(ep_axis="ep")),
              dict(mesh={"tp": 2, "ep": 2},
                   sharding=ShardingConfig(tp_axis="tp", ep_axis="ep"))]
    for kw in ({}, {"spec_k": 3, "draft_layers": 2}):
        want = DecodeEngine(ref, params, num_slots=2, page_size=16, seed=0,
                            **kw)
        for mesh in meshes:
            got = DecodeEngine(card, params, num_slots=2, page_size=16,
                               seed=0, **mesh, **kw)
            for prompt in ([5, 2, 8, 1], list(range(1, 40))):
                reset_launch_counts()
                toks = _engine_tokens(got, prompt)
                counts = launch_counts()
                assert counts["paged_attention"] > 0, kw
                assert counts["flash_fwd"] > 0, kw
                assert toks == _engine_tokens(want, prompt), (kw, mesh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_vmapped_flash_launches_once_for_k_replicas(dev, dtype):
    """Under ``torch.func.vmap`` over ``torch.func.grad`` the flash
    wrapper's batching rule folds K replicas into the batch: one launch of
    each of kernels 1-3 for all K, each replica's output and gradients
    those of the plain attention."""
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    g = torch.Generator(device=dev).manual_seed(7)
    k_, b, h, s, d = 3, 2, 4, 100, 64
    q, k, v = (torch.randn(k_, b, h, s, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = torch.ones(b, s, device=dev)
    mask[1, 70:] = 0

    def loss(q, k, v):
        return flash_attention(q, k, v, causal=True,
                               kv_mask=mask).float().square().sum()

    reset_launch_counts()
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, k,
                                                                       v)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_fwd"] == 1
    assert counts["flash_bwd_dq"] == 1 and counts["flash_bwd_dkv"] == 1
    for i in range(k_):
        qi, ki, vi = (t[i].detach().float().requires_grad_(True)
                      for t in (q, k, v))
        ref = attention_reference(qi, ki, vi, causal=True, kv_mask=mask)
        want = torch.autograd.grad(ref.square().sum(), (qi, ki, vi))
        for got, w in zip(grads, want):
            top = float(w.abs().max())
            assert _max_err(got[i], w) <= BWD_TOL[dtype] * max(top, 1.0)


def test_moe_spec_decode_on_card_repeats_itself(dev):
    """Float32 (TF32 off): an MoE LM's spec decode on the card gives the
    same tokens twice — its lanes past their room read scratch page 0 and
    claim expert capacity, so the duplicate scratch writes must resolve
    the same way every time — and its ep=2 engine gives those of the
    engine without a mesh on the split banks' arithmetic (one product per
    expert)."""
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    from sparkflow_tpu_torch.serving import DecodeEngine
    from sparkflow_tpu_torch.sharding import ShardingConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = build_registry_spec("transformer_moe_lm", vocab_size=97,
                               hidden=128, num_layers=4, num_heads=2,
                               mlp_dim=256, max_len=128, dropout=0.0,
                               num_experts=4, moe_every=2,
                               capacity_factor=1.0)
    card = model_from_json(spec, device="cuda")
    params = card.init(seed=8)
    ref = model_from_json(spec, device="cuda")
    ref.per_expert_products = True
    prompts = [list(range(1, 9 + 3 * i)) for i in range(4)]

    def run(model=card, **kw):
        eng = DecodeEngine(model, params, num_slots=4, page_size=16, seed=0,
                           spec_k=3, draft_layers=2, **kw)
        infos = [eng.prefill(p, max_new_tokens=10 + i)
                 for i, p in enumerate(prompts)]
        need = {i["slot"]: 10 + n for n, i in enumerate(infos)}
        toks = {i["slot"]: [i["token"]] for i in infos}
        live = set(toks)
        while live:
            for s, t in eng.step().items():
                toks[s].extend(t)
                if len(toks[s]) >= need[s]:
                    eng.release(s)
                    live.discard(s)
        return [toks[s][:need[s]] for s in need]

    first = run()
    assert run() == first
    per_expert = run(ref)
    assert run(ref) == per_expert
    assert run(mesh={"ep": 2},
               sharding=ShardingConfig(ep_axis="ep")) == per_expert
