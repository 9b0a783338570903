"""PyTorch port, sequence parallelism: ``ring_attention`` /
``ring_flash_attention`` (``ops/attention.py``), the sp model path
(``models/transformer.py`` with ``sp_axis``), ``parallel/sp.py`` and the
trainer's ``{"dp": a, "sp": b}`` meshes, against the JAX package's.

The JAX side runs ``ring_attention`` and ``ring_flash_attention`` under
``shard_map`` on the conftest's virtual CPU devices (the latter's Pallas
kernels in interpret mode, as its own tests run them); the port's ranks
run over gloo on the CPU, where every ring visit runs the plain versions
of kernels 1-3. Outputs and
q/k/v gradients agree within 2e-5, the sp step's loss and gradients
within 1e-5. A causal ring on 2 ranks calls the flash forward, dq and dkv
wrappers 3 times each summed over the ranks: the visit to a later shard
is skipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import torch_rank_tasks as tasks
from sparkflow_tpu.jax_compat import shard_map
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.ops.attention import ring_attention as jax_ring_plain
from sparkflow_tpu.ops.attention import ring_flash_attention as jax_ring
from sparkflow_tpu.optimizers import build_optimizer as jax_opt
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.parallel.sp import make_sp_train_step
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.parallel import distributed as D

TOL = 2e-5
STEP_TOL = 1e-5
SHAPE = (2, 2, 32, 8)          # B, H, S (16 a rank), D
FLASH_SHAPE = (1, 2, 256, 8)   # 128 a rank: JAX's Pallas ring tiles it
LM = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4, mlp_dim=64,
          max_len=64, dropout=0.0)


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tasks.rank_pool(4, timeout_s=180) as pool:
        yield pool


def _jax_ring(fn, seed, causal, masked, shape, n=2):
    """A JAX ring (``ring_attention`` or ``ring_flash_attention``) under
    shard_map: out, dq, dk, dv."""
    b, h, s, d = shape
    rs = np.random.RandomState(seed)
    q, k, v, do = (jnp.asarray(rs.randn(b, h, s, d).astype(np.float32))
                   for _ in range(4))
    mask = (jnp.asarray((rs.rand(b, s) > 0.3).astype(np.float32))
            if masked else None)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("sp",))
    spec = JP(None, None, "sp", None)
    if masked:
        sm = shard_map(lambda q_, k_, v_, m_: fn(
            q_, k_, v_, "sp", causal=causal, kv_mask=m_), mesh=mesh,
            in_specs=(spec, spec, spec, JP(None, "sp")), out_specs=spec,
            check_vma=False)
        f = lambda q_, k_, v_: sm(q_, k_, v_, mask)  # noqa: E731
    else:
        f = shard_map(lambda q_, k_, v_: fn(q_, k_, v_, "sp", causal=causal),
                      mesh=mesh, in_specs=(spec, spec, spec),
                      out_specs=spec, check_vma=False)
    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(t) for t in (out,) + vjp(do)]


@pytest.mark.parametrize("causal,masked", [(True, False), (False, False),
                                           (False, True), (True, True)],
                         ids=["causal", "full", "kv_mask", "causal_mask"])
def test_ring_attention_matches_jax(pool2, causal, masked):
    """The plain ring against JAX's jnp ``ring_attention``, at a small
    shape; the kernel ring against JAX's ``ring_flash_attention`` at a shard
    length its Pallas kernels tile (128), run in interpret mode as its own
    tests run it. The pairs differ from each other on a query row that sees
    no key at all (its keys all padded): each kernel ring skips the causal
    visit to a later shard and gates its backward's P to 0 there, the jnp
    ring averages over every block. The backward runs on another thread,
    as autograd runs a CUDA backward: the rings bind their mesh there."""
    for name, fn, shape in (("plain", jax_ring_plain, SHAPE),
                            ("flash", jax_ring, FLASH_SHAPE)):
        ours = pool2.run(tasks.ring, 0, causal, masked, shape,
                         backward_thread=True)
        want = _jax_ring(fn, 0, causal, masked, shape)
        sl = shape[2] // 2
        for r, o in enumerate(ours):
            for got, full, what in zip(o[name], want,
                                       ("out", "dq", "dk", "dv")):
                np.testing.assert_allclose(
                    got, full[:, :, r * sl:(r + 1) * sl], atol=TOL, rtol=0,
                    err_msg=f"{name} {what} rank {r}")


@pytest.mark.parametrize("causal,visits", [(True, 3), (False, 4)],
                         ids=["causal", "full"])
def test_ring_visits_skip_later_shards(pool2, causal, visits):
    """Kernel calls per ring (summed over the ranks): a causal ring skips
    the visit to a later shard, forward and backward; the plain ring calls
    none of them."""
    ours = pool2.run(tasks.ring, 1, causal, False, SHAPE,
                     count_visits=True)
    for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
        assert sum(o["flash_calls"][name] for o in ours) == visits, name
        assert sum(o["plain_calls"][name] for o in ours) == 0
    if causal:
        assert ours[0]["flash_calls"]["flash_attention"] == 1
        assert ours[1]["flash_calls"]["flash_attention"] == 2


def test_sp_model_forward_equals_the_full_sequence(pool2):
    """Positions start at the rank's shard and the ring sees every earlier
    key: each rank's logits equal the full forward's at its positions."""
    spec = build_registry_spec("transformer_lm", **LM)
    p0 = jax.tree.map(np.asarray, jax_model(jax_spec("transformer_lm", **LM))
                      .init(jax.random.PRNGKey(0)))
    ids = np.random.RandomState(2).randint(0, 64, (3, 32))
    ours = pool2.run(tasks.sp_forward, spec, p0, ids)
    model = model_from_json(spec, device="cpu")
    full = model.apply(tasks._tree_t(p0), {"input_ids": ids},
                       ["logits"])["logits"].detach().numpy()
    for r, o in enumerate(ours):
        np.testing.assert_allclose(o, full[:, r * 16:(r + 1) * 16],
                                   atol=TOL, rtol=0)


def _lm_batch(b=4, s=32, seed=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 64, (b, s))
    mask = np.ones((b, s), np.float32)
    for i, n in enumerate(rs.randint(s // 2, s + 1, b)):
        mask[i, n:] = 0.0
    return ids, mask


def _jax_sp_steps(axes, p0, ids, mask, optimizer, lr, steps):
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(axes, devices=jax.devices()[:n])
    opt = jax_opt(optimizer, lr, {"epsilon": 1e-6}
                  if optimizer == "adam" else None)
    step = make_sp_train_step(jax_model(jax_spec("transformer_lm", **LM)),
                              opt, mesh)
    p = jax.tree.map(jnp.asarray, p0)
    s = opt.init(p)
    losses = []
    for i in range(steps):
        p, s, loss = step(p, s, jnp.asarray(ids), jnp.asarray(mask),
                          jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("axes", [{"dp": 1, "sp": 2}, {"dp": 2, "sp": 2}],
                         ids=["sp2", "dp2_sp2"])
def test_sp_step_loss_and_gradients_match_jax(request, axes):
    """One SGD step at learning rate 1: the params move by minus the
    gradient, so the moved params carry the gradients."""
    pool = request.getfixturevalue("pool2" if axes["dp"] == 1 else "pool4")
    spec = build_registry_spec("transformer_lm", **LM)
    p0 = jax.tree.map(np.asarray, jax_model(jax_spec("transformer_lm", **LM))
                      .init(jax.random.PRNGKey(1)))
    ids, mask = _lm_batch()
    ours = pool.run(tasks.sp_step, spec, axes, p0, ids, mask)
    want_l, want_p = _jax_sp_steps(axes, p0, ids, mask, "gradient_descent",
                                   1.0, 1)
    for o in ours:
        np.testing.assert_allclose(o["losses"], want_l, atol=STEP_TOL,
                                   rtol=0)
        for layer in want_p:
            for k in want_p[layer]:
                np.testing.assert_allclose(
                    o["params"][layer][k] - p0[layer][k],
                    want_p[layer][k] - p0[layer][k], atol=STEP_TOL, rtol=0,
                    err_msg=f"{layer}/{k}")


def test_sp_step_with_the_plain_ring_equals_the_kernel_ring(pool2):
    spec = build_registry_spec("transformer_lm", **LM)
    p0 = jax.tree.map(np.asarray, jax_model(jax_spec("transformer_lm", **LM))
                      .init(jax.random.PRNGKey(4)))
    ids, mask = _lm_batch(seed=5)
    flash = pool2.run(tasks.sp_step, spec, {"dp": 1, "sp": 2}, p0, ids, mask,
                      1e-2, "adam", 2)
    plain = pool2.run(tasks.sp_step, spec, {"dp": 1, "sp": 2}, p0, ids, mask,
                      1e-2, "adam", 2, attention="plain")
    for a, b in zip(flash, plain):
        np.testing.assert_allclose(a["losses"], b["losses"], atol=STEP_TOL,
                                   rtol=0)


def test_trainer_sp_fit_matches_jax(pool2):
    spec = build_registry_spec("transformer_lm", **LM)
    p0 = jax.tree.map(np.asarray, jax_model(jax_spec("transformer_lm", **LM))
                      .init(jax.random.PRNGKey(5)))
    ids = np.random.RandomState(6).randint(0, 64, (16, 32)).astype(
        np.float32)
    kw = dict(optimizer="adam", learning_rate=1e-2,
              optimizer_options={"epsilon": 1e-6}, mini_batch_size=8,
              iters=2, seed=0, shuffle_per_iter=False)
    ours = pool2.run(tasks.trainer_fit, spec, {"dp": 1, "sp": 2},
                     dict(kw, inputs=("input_ids", None)), ids, None, p0)
    jt = JaxTrainer(jax_spec("transformer_lm", **LM), "input_ids", None,
                    mesh=jax_make_mesh({"dp": 1, "sp": 2},
                                       devices=jax.devices()[:2]), **kw)
    jr = jt.fit(ids, init_params=jax.tree.map(jnp.asarray, p0))
    for o in ours:
        assert o["stats"]["strategy"] == "sp"
        np.testing.assert_allclose(o["losses"], jr.losses, atol=2e-4,
                                   rtol=1e-5)
        for layer in p0:
            for k in p0[layer]:
                np.testing.assert_allclose(
                    o["params"][layer][k], np.asarray(jr.params[layer][k]),
                    atol=2e-4, rtol=1e-5, err_msg=f"{layer}/{k}")
        me = o["stats"]["ranks"][0]
        assert me["bytes_moved"]["ppermute"] > 0
    assert all(o["zero_stage"] == 0 for o in ours)


def test_sp_refusals_follow_jax():
    """An sp mesh trains causal LMs only, unsupervised, and composes with
    dp only: the JAX trainer's messages."""
    cls = build_registry_spec("transformer_classifier", vocab_size=64,
                              num_classes=2, hidden=32, num_layers=1,
                              num_heads=4, mlp_dim=64, max_len=32)
    from sparkflow_tpu_torch.trainer import Trainer
    ids = np.zeros((8, 32), np.float32)
    y = np.eye(2, dtype=np.float32)[np.zeros(8, int)]
    with pytest.raises(ValueError, match="not a TransformerLM"):
        Trainer(cls, "input_ids", "y", mesh={"sp": 2},
                device="cpu").fit(ids, y)
    lm = build_registry_spec("transformer_lm", **LM)
    with pytest.raises(ValueError, match="unsupervised"):
        Trainer(lm, "input_ids", "attention_mask", mesh={"sp": 2},
                device="cpu").fit(ids, ids)
    with pytest.raises(ValueError, match="composes with 'dp' only"):
        Trainer(lm, "input_ids", None, mesh={"dcn": 2, "sp": 2},
                device="cpu").fit(ids)
