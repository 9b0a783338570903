"""PyTorch port, training at head_dim above 128 (up to 256, GPT-J-6B's
head): the backward kernels' plain versions against the JAX package's
Pallas backward kernels in interpret mode at head_dim 136 and 256, a
transformer_lm whose heads are 256 (and 136) wide against the JAX
package's loss and gradients and its ``Trainer``, and
``ring_flash_attention`` at head_dim 256 on two ranks against JAX's ring
under ``shard_map``.

Inputs and weights are drawn with numpy from fixed seeds and handed to
both packages; dropout is off and shuffling off. On the CPU the port's
wrappers run their plain versions (the kernels, ``csrc/flash_bwd.cu`` and
``csrc/flash_bwd_wide.cu``, run on the card: tests/test_torch_cuda.py).

Tolerances, float32 (both sides compute in float32 from the same values;
only the order of the sums differs): the plain backward against the Pallas
kernels 2e-5 absolute and relative (as tests/test_torch_wide_heads.py
holds the forward); one step's loss within 1e-5 relative and its gradients
within 1e-5 absolute; 4 ``Trainer`` steps' losses within 1e-5 relative and
the weights within 2e-4 with adam and 1e-5 with plain SGD (the bars of
tests/test_torch_train.py, whose docstring gives adam's reason: epsilon
1e-6 there and here); the ring's output and gradients within 2e-5 (as
tests/test_torch_ring.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import torch_rank_tasks as tasks
from test_torch_shared import numpy_params
from sparkflow_tpu.graphdef import params_to_list as jax_to_list
from sparkflow_tpu.jax_compat import shard_map
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.models.registry import model_from_json as jax_from_json
from sparkflow_tpu.ops import attention as jattn
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.ops import (flash_attention_backward_reference,
                                     flash_bwd_dkv, flash_bwd_dq)
from sparkflow_tpu_torch.trainer import Trainer

TOL = dict(atol=2e-5, rtol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=1e-5, rtol=0)
RING_TOL = 2e-5
WIDE = (136, 256)          # padded to 160 in the kernels; GPT-J's
S = 128


def _lm(d):
    """A 2-layer transformer_lm with 2 heads of ``d``."""
    return dict(vocab_size=97, hidden=2 * d, num_layers=2, num_heads=2,
                mlp_dim=256, max_len=S, dropout=0.0)


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


# -- the backward kernels' plain versions ------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["causal", "masked"])
@pytest.mark.parametrize("d", WIDE)
def test_backward_plain_matches_jax_pallas(d, masked):
    """dQ, dK and dV from the JAX forward's own O and logsumexp, causal, or
    non-causal over padded keys with one batch row all padding (zero
    gradient there, as in JAX)."""
    rs = np.random.RandomState(d + masked)
    q, k, v, g = (rs.randn(2, 2, S, d).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((2, S), np.float32)
        mask[0, S - 45:] = 0.0
        mask[1] = 0.0
    causal = not masked
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = jattn._flash_pallas_forward(jq, jk, jv, jm, causal, scale, S,
                                           S, True, with_lse=True)
    want = jattn._flash_pallas_backward(jq, jk, jv, jm, out, lse, jg, causal,
                                        scale, S, S, True)
    tq, tk, tv, tg, tout, tlse = (torch.from_numpy(np.array(a)) for a in
                                  (q, k, v, g, out, lse))
    tm = None if mask is None else torch.from_numpy(mask)
    delta = (tg * tout).sum(-1).contiguous()
    dq = flash_bwd_dq(tq, tk, tv, tg, tlse, delta, causal, scale, kv_mask=tm)
    dk, dv = flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, causal, scale,
                           kv_mask=tm)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    composed = flash_attention_backward_reference(tq, tk, tv, tout, tlse, tg,
                                                  causal, scale, kv_mask=tm)
    for a, b in zip(composed, (dq, dk, dv)):
        assert torch.equal(a, b)
    if masked:
        assert not dq[1].any() and not dk[1].any() and not dv[1].any()


# -- the model: one step's loss and gradients --------------------------------

def _pair(d, seed):
    cfg = _lm(d)
    spec = build_registry_spec("transformer_lm", **cfg)
    assert spec == jax_spec("transformer_lm", **cfg)
    jm = jax_from_json(spec)
    tm = model_from_json(spec, device="cpu")
    return spec, jm, tm, numpy_params(jm.param_specs(), seed=seed, std=0.08)


def _tokens(seed, b):
    return np.random.default_rng(seed).integers(0, 97, (b, S)).astype(
        np.int32)


@pytest.mark.parametrize("d", WIDE)
def test_wide_head_lm_loss_and_gradients_match_jax(d):
    """The JAX side takes its Pallas flash forward and backward (interpret
    mode) at S = 128; the port's attention runs the plain versions of
    kernels 1-3 through its autograd Function."""
    _, jm, tm, npp = _pair(d, seed=d)
    ids = _tokens(d + 1, 3)
    jl, jg = jax.value_and_grad(lambda p: jnp.mean(jm.loss_vector(
        p, {"input_ids": jnp.asarray(ids)}, train=True,
        rng=jax.random.PRNGKey(0))))(jax.tree.map(jnp.asarray, npp))
    tp = tm.load_params(params_from_jax(tm, npp), trainable=True)
    tl = tm.loss_vector(tp, {"input_ids": torch.from_numpy(ids)},
                        train=True).mean()
    names = [(ln, pn) for ln, ps in tm.param_specs().items() for pn in ps]
    tg = torch.autograd.grad(tl, [tp[ln][pn] for ln, pn in names])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    for (ln, pn), got in zip(names, tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg[ln][pn]),
                                   err_msg=f"{ln}/{pn}", **GRAD_TOL)


@pytest.mark.parametrize("optimizer,lr,options,tol", [
    ("adam", 1e-3, {"learning_rate": 1e-3, "epsilon": 1e-6}, 2e-4),
    ("gradient_descent", 0.01, None, 1e-5)], ids=["adam", "sgd"])
def test_wide_head_trainer_matches_jax_trainer(optimizer, lr, options, tol):
    """4 steps (2 epochs x 2 sweep batches) of the 256-wide-head model from
    the same initial weights: the per-epoch losses and the final weights.
    Adam steps at 1e-3: at tests/test_torch_train.py's 0.01 this 512-wide
    model overshoots (the first epoch's mean loss 7.18, against 6.17 at
    1e-3 from the same start), and each element's normalised step carries
    the packages' round-off apart: the weights end 6.8e-4 apart after 4
    steps at 0.01, 6.1e-5 at 1e-3."""
    spec, jm, _, npp = _pair(256, seed=7)
    toks = _tokens(9, 8).astype(np.float32)       # ids as the estimator sends
    kw = dict(optimizer=optimizer, learning_rate=lr, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0,
              optimizer_options=options)
    jt = JaxTrainer(spec, "input_ids", None, **kw)
    jr = jt.fit(toks, init_params=npp)
    tt = Trainer(spec, "input_ids", None, device="cpu", **kw)
    tr = tt.fit(toks, init_params=npp)
    assert tt._plan(8) == jt._plan(8) == ("sweep", 4, 2)
    np.testing.assert_allclose(tr.losses, jr.losses, **LOSS_TOL)
    for got, want in zip(tt.weights_list(), jax_to_list(jt.model, jt.params)):
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert tr.losses[-1] < tr.losses[0]


# -- ring attention at head_dim 256 ------------------------------------------

RING_SHAPE = (1, 2, 256, 256)   # B, H, S (128 a rank: JAX's ring tiles it), D


def _jax_ring(seed, causal, masked):
    """JAX's ``ring_flash_attention`` under ``shard_map`` on 2 virtual CPU
    devices, its Pallas kernels in interpret mode, with the inputs
    ``tasks.ring`` draws from the same seed: out, dq, dk, dv."""
    b, h, s, d = RING_SHAPE
    rs = np.random.RandomState(seed)
    q, k, v, do = (jnp.asarray(rs.randn(b, h, s, d).astype(np.float32))
                   for _ in range(4))
    mask = (jnp.asarray((rs.rand(b, s) > 0.3).astype(np.float32))
            if masked else None)
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("sp",))
    spec = JP(None, None, "sp", None)

    def ring(q_, k_, v_, m_=None):
        return jattn.ring_flash_attention(q_, k_, v_, "sp", causal=causal,
                                          kv_mask=m_)

    if masked:
        sm = shard_map(ring, mesh=mesh,
                       in_specs=(spec, spec, spec, JP(None, "sp")),
                       out_specs=spec, check_vma=False)
        f = lambda q_, k_, v_: sm(q_, k_, v_, mask)  # noqa: E731
    else:
        f = shard_map(ring, mesh=mesh, in_specs=(spec, spec, spec),
                      out_specs=spec, check_vma=False)
    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(t) for t in (out,) + vjp(do)]


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "kv_mask"])
def test_ring_flash_attention_at_head_dim_256_matches_jax(pool2, causal,
                                                          masked):
    """Each rank's output shard and q/k/v gradients through the kernel ring
    (on the CPU the plain versions of kernels 1-3 at every visit), its
    backward on another thread as autograd runs a CUDA backward."""
    ours = pool2.run(tasks.ring, 5, causal, masked, RING_SHAPE,
                     backward_thread=True)
    want = _jax_ring(5, causal, masked)
    sl = RING_SHAPE[2] // 2
    for r, o in enumerate(ours):
        for got, full, what in zip(o["flash"], want,
                                   ("out", "dq", "dk", "dv")):
            np.testing.assert_allclose(
                got, full[:, :, r * sl:(r + 1) * sl], atol=RING_TOL, rtol=0,
                err_msg=f"{what} rank {r}")
