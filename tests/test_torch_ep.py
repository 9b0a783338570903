"""PyTorch port, expert parallelism: the ``all_to_all`` and differentiable
``psum`` collectives, ``ops/moe_dispatch.py``'s ``all_to_all_moe_ffn``,
``parallel/ep.py``'s step, and the trainer's ``ep`` fits (JAX's GSPMD form:
each rank holds ``E/ep`` experts, rows shard over ``dp`` only), against
the JAX package.

The JAX side runs on the conftest's virtual CPU devices under
``shard_map`` or its GSPMD trainer; the port's ranks run over gloo on the
CPU in one module-scoped 2-rank pool and one 4-rank pool (``dp x ep`` and
``tp x ep``). Weights are drawn with numpy and handed to both packages,
dropout is off, and the MoE LM is tiny (hidden 32, 2 layers, 4 experts on
the second block, S=16), with capacity factor 1.0, where capacity drops
tokens.

Tolerances (float32): collectives within 1e-6; ``all_to_all_moe_ffn``'s
output, aux, overflow and gradients within 1e-5 (atol plus rtol); the
all_to_all step's losses within 1e-5 relative and its params within 1e-5
after SGD and 2e-4 after adam (``tests/test_torch_train.py``'s pins); the
trainer's fits within 1e-5 relative on the losses and atol 5e-5 / rtol
1e-5 on the params of JAX's fit and of one card's; checkpoints bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import torch_rank_tasks as tasks
from test_torch_shared import numpy_params
from sparkflow_tpu.jax_compat import shard_map
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.ops.moe_dispatch import all_to_all_moe_ffn as jax_ffn
from sparkflow_tpu.optimizers import build_optimizer as jax_opt
from sparkflow_tpu.parallel.ep import (
    make_moe_shardmap_train_step as jax_ep_step,
    place_moe_params as jax_place)
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.trainer import Trainer

S = 16
LM = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4, mlp_dim=64,
          max_len=S, dropout=0.0)
MOE = dict(LM, num_experts=4, moe_every=2, capacity_factor=1.0)
FIT_TOL = dict(atol=5e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tasks.rank_pool(4, timeout_s=180) as pool:
        yield pool


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(ours, theirs, msg="", **tol):
    for layer in theirs:
        for k in theirs[layer]:
            np.testing.assert_allclose(
                np.asarray(ours[layer][k]), np.asarray(theirs[layer][k]),
                err_msg=f"{msg} {layer}/{k}", **tol)


def _per_rank(fn, *stacked):
    """``fn`` on each rank's slice of the stacked arrays under JAX's
    ``shard_map`` over ``{"ep": 2}``: per-rank outputs."""
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("ep",))
    f = shard_map(lambda *a: jax.tree.map(lambda y: jnp.asarray(y)[None],
                                          fn(*[x[0] for x in a])),
                  mesh=mesh, in_specs=(JP("ep"),) * len(stacked),
                  out_specs=JP("ep"), check_vma=False)
    out = f(*[jnp.asarray(a) for a in stacked])
    return [jax.tree.map(lambda y: np.asarray(y[i]), out) for i in range(2)]


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, 61, (n, S)).astype(
        np.float32)


# -- collectives and the dispatch ------------------------------------------------


def test_all_to_all_and_psum_grad_match_jax(pool2):
    """Values and gradients of ``all_to_all`` (slab j to peer j; the
    backward the reverse exchange) and of the differentiable psum (the
    backward sums the cotangents over the axis, as JAX transposes psum
    inside ``shard_map`` with ``check_vma=False``)."""
    rs = np.random.RandomState(0)
    xs = rs.randn(2, 2, 3, 4).astype(np.float32)
    gs = rs.randn(2, 2, 3, 4).astype(np.float32)
    ours = pool2.run(tasks.ep_collectives, {"ep": 2}, xs, gs)

    def jf(x, g):
        def a2a(x):
            return jax.lax.all_to_all(x, "ep", 0, 0, tiled=False)

        def ps(x):
            return jax.lax.psum(x, "ep")
        return {"a2a": a2a(x),
                "a2a_grad": jax.grad(lambda x: jnp.sum(a2a(x) * g))(x),
                "psum": ps(x),
                "psum_grad": jax.grad(lambda x: jnp.sum(ps(x) * g))(x)}

    want = _per_rank(jf, xs, gs)
    for r in range(2):
        for k in ("a2a", "a2a_grad", "psum", "psum_grad"):
            np.testing.assert_allclose(ours[r][k], want[r][k], atol=1e-6,
                                       rtol=0, err_msg=k)
    # the psum's backward really sums: the identity would give g itself
    assert not np.allclose(ours[0]["psum_grad"], gs[0])
    assert ours[0]["stats"]["all_to_all"] == 2 * xs[0].nbytes


@pytest.mark.parametrize("top_k,cf,masked", [
    (1, 8.0, False), (1, 1.0, False), (2, 1.0, True)],
    ids=["top1-cf8", "top1-cf1", "top2-cf1-mask"])
def test_all_to_all_moe_ffn_matches_jax(pool2, top_k, cf, masked):
    """Output, aux, overflow and the gradients of x, the router and the
    rank's expert slices at ep=2, top-1 and top-2, with capacity 8.0 (no
    drops) and 1.0 (drops), with and without a token mask. The router's
    gradient reaches it through the aux loss's globally summed statistics:
    a psum with an identity backward would be off by the axis size."""
    rs = np.random.RandomState(1)
    b, h, m, e = 4, 16, 32, 4
    x = rs.randn(b, 6, h).astype(np.float32)
    mask = ((np.arange(6)[None] < rs.randint(3, 7, (b, 1))).astype(
        np.float32) if masked else None)
    params = {"router": rs.randn(h, e).astype(np.float32),
              "experts_fc1": (0.3 * rs.randn(e, h, m)).astype(np.float32),
              "experts_b1": (0.1 * rs.randn(e, m)).astype(np.float32),
              "experts_fc2": (0.3 * rs.randn(e, m, h)).astype(np.float32),
              "experts_b2": (0.1 * rs.randn(e, h)).astype(np.float32)}
    gy = rs.randn(b, 6, h).astype(np.float32)
    ours = pool2.run(tasks.moe_ffn, {"ep": 2}, x, mask, params, gy, top_k,
                     cf, 5.0)

    names = ["router", "experts_fc1", "experts_b1", "experts_fc2",
             "experts_b2"]

    def jf(xr, mr, gyr, router, f1, b1, f2, b2):
        def loss(xr, router, f1, b1, f2, b2):
            y, aux, over = jax_ffn(xr, router, f1, b1, f2, b2, "ep", e, cf,
                                   mr if masked else None, top_k=top_k,
                                   return_overflow=True)
            return jnp.sum(y * gyr) + 5.0 * aux, (y, aux, over)
        (_l, (y, aux, over)), g = jax.value_and_grad(
            loss, argnums=tuple(range(6)), has_aux=True)(
            xr, router, f1, b1, f2, b2)
        return {"y": y, "aux": aux, "overflow": over,
                "grads": dict(zip(["x"] + names, g))}

    def halves(a):
        return a.reshape((2, a.shape[0] // 2) + a.shape[1:])

    want = _per_rank(
        jf, halves(x), halves(mask if masked else np.ones((b, 6),
                                                          np.float32)),
        halves(gy), np.stack([params["router"]] * 2),
        *(halves(params[k]) for k in names[1:]))
    for r in range(2):
        np.testing.assert_allclose(ours[r]["y"], want[r]["y"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(ours[r]["aux"], want[r]["aux"],
                                   rtol=1e-5)
        np.testing.assert_allclose(ours[r]["overflow"], want[r]["overflow"],
                                   atol=1e-6)
        for k in ["x"] + names:
            np.testing.assert_allclose(ours[r]["grads"][k],
                                       want[r]["grads"][k], atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    if cf == 1.0:
        assert max(o["overflow"] for o in ours) > 0     # drops exercised


@pytest.mark.parametrize("opt,lr,options,ptol", [
    ("gradient_descent", 0.5, None, 1e-5),
    ("adam", 0.01, {"epsilon": 1e-6}, 2e-4)], ids=["sgd", "adam"])
def test_moe_shardmap_train_step_matches_jax(pool2, opt, lr, options, ptol):
    """3 steps of ``make_moe_shardmap_train_step`` (the batch and the bank
    sharded over ``ep``, all_to_all dispatch) against JAX's."""
    spec = build_registry_spec("transformer_moe_lm",
                               **dict(MOE, ep_axis="ep"))
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=4, std=0.1)
    ids = _tokens(8, 2).astype(np.int32)
    mask = (np.arange(S)[None] < np.random.RandomState(3).randint(
        10, S + 1, (8, 1))).astype(np.float32)
    ours = pool2.run(tasks.moe_shardmap_steps, spec, {"ep": 2}, p0, ids,
                     mask, opt, lr, 3, options)
    mesh = _jmesh({"ep": 2})
    jo = jax_opt(opt, lr, options)
    step = jax_ep_step(jm, jo, mesh)
    params = jax_place(jm, jax.tree.map(jnp.asarray, p0), mesh)
    state = jo.init(params)
    losses = []
    for i in range(3):
        params, state, loss = step(params, state, jnp.asarray(ids),
                                   jnp.asarray(mask), jax.random.PRNGKey(i))
        losses.append(float(loss))
    for r in ours:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        _close(r["params"], _np_tree(params), opt, atol=ptol, rtol=0)
    assert isinstance(jo, optax.GradientTransformation)


# -- the trainer's ep fits (JAX's GSPMD form) ------------------------------------


def _fit_kw(**over):
    kw = dict(optimizer="adam", learning_rate=0.01, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0,
              optimizer_options={"epsilon": 1e-4})
    kw.update(over)
    return kw


def _fit_case(pool, axes, seed=5):
    spec = build_registry_spec("transformer_moe_lm", **MOE)
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=seed, std=0.1)
    toks = _tokens(8, seed)
    kw = _fit_kw()
    jt = JaxTrainer(spec, "input_ids", None, mesh=_jmesh(axes), **kw)
    jr = jt.fit(toks, init_params=p0)
    out = pool.run(tasks.tp_trainer_fit, spec, axes,
                   dict(kw, inputs=("input_ids", None)), toks, None, p0)
    one = Trainer(spec, "input_ids", None, device="cpu", **kw).fit(
        toks, init_params=p0)
    for r in out:
        np.testing.assert_allclose(r["losses"], jr.losses, rtol=1e-5)
        _close(r["params"], _np_tree(jt.params), str(axes), **FIT_TOL)
        np.testing.assert_allclose(r["losses"], one.losses, rtol=1e-5)
        _close(r["params"], {ln: {k: v.detach().numpy() for k, v in
                                  d.items()} for ln, d in one.params.items()},
               "one card", **FIT_TOL)
        assert r["stats"]["zero_stage"] == 0
    return out, p0


@pytest.mark.parametrize("axes", [{"ep": 2}, {"dp": 2, "fsdp": 1}],
                         ids=["ep", "dp-fsdp1"])
def test_trainer_fit_on_an_ep_mesh_matches_jax_and_one_card(pool2, axes):
    """4 adam steps of the MoE LM through ``Trainer(mesh=...)`` against
    JAX's GSPMD ``Trainer`` on the same mesh and the port's one-card fit.
    At ``ep=2`` each rank holds half of each bank (its param bytes are
    fewer than one card's). ``{"dp": 2, "fsdp": 1}`` is a sharded-params
    mesh whose rows split over dp: the MoE layers route the global batch,
    as JAX's GSPMD program does (before, each dp shard routed its own rows,
    with its own capacity)."""
    out, p0 = _fit_case(pool2, axes)
    if "ep" in axes:
        whole = sum(a.nbytes for d in p0.values() for a in d.values())
        assert all(r["stats"]["ranks"][0]["param_bytes"] < whole
                   for r in out)


def test_trainer_fit_on_dp_by_ep_and_tp_by_ep_meshes(pool4):
    """The four-rank meshes: ``{"dp": 2, "ep": 2}`` (each dp pair routes
    the global batch) and ``{"tp": 2, "ep": 2}`` (Megatron attention over
    tp, the bank over ep) against JAX's and one card's fits."""
    _fit_case(pool4, {"dp": 2, "ep": 2}, seed=6)
    _fit_case(pool4, {"tp": 2, "ep": 2}, seed=7)


def test_a_dense_model_trains_replicated_over_ep(pool2):
    """A model without experts on an ``ep`` mesh: JAX's spec filter leaves
    every leaf replicated, so the ranks train the one-card fit."""
    spec = build_registry_spec("transformer_lm", **LM)
    p0 = numpy_params(jax_model(spec).param_specs(), seed=8, std=0.1)
    toks = _tokens(8, 8)
    kw = _fit_kw()
    out = pool2.run(tasks.tp_trainer_fit, spec, {"ep": 2},
                    dict(kw, inputs=("input_ids", None)), toks, None, p0)
    jt = JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"ep": 2}), **kw)
    jr = jt.fit(toks, init_params=p0)
    for r in out:
        np.testing.assert_allclose(r["losses"], jr.losses, rtol=1e-5)
        _close(r["params"], _np_tree(jt.params), "dense", **FIT_TOL)
    assert out[0]["losses"] == out[1]["losses"]


def test_tp_ep_with_fsdp_is_refused_as_jax():
    spec = build_registry_spec("transformer_moe_lm", **MOE)
    toks = _tokens(8, 1)
    axes = {"tp": 2, "ep": 2, "fsdp": 2}
    match = "combined tp/ep \\+ fsdp sharding cannot be auto-derived"
    with pytest.raises(ValueError, match=match):
        JaxTrainer(spec, "input_ids", None, mesh=_jmesh(axes),
                   **_fit_kw()).fit(toks)
    with pytest.raises(ValueError, match=match):
        Trainer(spec, "input_ids", None, mesh=axes, device="cpu",
                **_fit_kw()).fit(toks)


def test_an_ep_checkpoint_interchanges_bit_for_bit(pool2, tmp_path,
                                                   monkeypatch):
    """An ep=2 fit writes the standard layout (whole banks), as JAX's ep fit
    does: each package's ``CheckpointManager`` reads the other's ep
    checkpoint to bit-equal params and optimizer state, and the port's
    resumes on one card bit for bit (the resumed fit trains nothing)."""
    import sparkflow_tpu.checkpoint as jax_ckpt
    from sparkflow_tpu.trainer import _ckpt_state as jax_ckpt_state
    from sparkflow_tpu_torch.convert import sorted_leaves
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)
    spec = build_registry_spec("transformer_moe_lm", **MOE)
    p0 = numpy_params(jax_model(spec).param_specs(), seed=9, std=0.1)
    toks = _tokens(8, 9)
    kw = _fit_kw(checkpoint_every=1)
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    out = pool2.run(tasks.tp_trainer_fit, spec, {"ep": 2},
                    dict(kw, checkpoint_dir=d_port,
                         inputs=("input_ids", None)), toks, None, p0)
    jt = JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"ep": 2}),
                    **dict(kw, checkpoint_dir=d_jax))
    jt.fit(toks, init_params=jax.tree.map(jnp.asarray, p0))
    one = Trainer(spec, "input_ids", None, device="cpu",
                  **dict(kw, checkpoint_dir=d_port))
    r = one.fit(toks)
    assert one._resumed_from == 2 and r.losses == []
    _close({ln: {k: v.detach().numpy() for k, v in d.items()}
            for ln, d in r.params.items()}, out[0]["params"], "resumed",
           rtol=0, atol=0)
    jlike = jax.tree.map(np.asarray, jax_ckpt_state(
        jt.params, jt._last_opt_state, 0, jax.random.PRNGKey(0),
        rng_impl=None))
    tlike = one._ckpt_state(one.params, one._last_opt_state, 0,
                            one._generators())
    for d in (d_port, d_jax):
        jstate = jax_ckpt.CheckpointManager(d).restore(step=2, like=jlike)
        tstate = CheckpointManager(d).restore(step=2, like=tlike)
        for key in ("params", "opt_state"):
            want = jax.tree.leaves(jstate[key])
            got = [np.asarray(v) for _p, v in sorted_leaves(tstate[key])]
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
        assert np.shape(tstate["params"]["block_1"]["experts_fc1"]) == (
            4, 32, 64)


def test_fit_stream_on_an_ep_mesh_matches_jax(pool2):
    """``fit_stream`` in place at ``{"ep": 2}``: every step's loss and the
    final params against JAX's ``fit_stream`` on the same mesh."""
    spec = build_registry_spec("transformer_moe_lm", **MOE)
    jm = jax_model(spec)
    p0 = numpy_params(jm.param_specs(), seed=10, std=0.1)
    toks = _tokens(12, 10)
    kw = _fit_kw(iters=1)
    ours = pool2.run(tasks.tp_stream_fit, spec, {"ep": 2},
                     dict(kw, inputs=("input_ids", None)), toks, None, p0)
    jt = JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"ep": 2}), **kw)
    jr = jt.fit_stream(lambda: iter(list(toks)),
                       init_params=jax.tree.map(jnp.asarray, p0), chunk=64)
    assert len(jr.losses) == 3
    for o in ours:
        np.testing.assert_allclose(o["losses"], jr.losses, rtol=1e-5)
        _close(o["params"], _np_tree(jr.params), "stream", **FIT_TOL)
