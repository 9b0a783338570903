"""Data-parallel train steps, one factory for four zero stages — the port
of the JAX package's ``parallel/dp.py``.

:func:`make_dp_train_step` returns the per-rank body of JAX's whole-step
``shard_map``: every rank runs the unchanged model on its LOCAL rows (the
flash kernels per rank on the card), and collectives over the named mesh
axes do the rest. The zero stage of the
:class:`~sparkflow_tpu_torch.sharding.ShardingConfig` selects how much of
the update shards over the data axis (Xu et al., arXiv:2004.13336):

- stage 0 — replicated update: gradients all-reduced, the optimizer runs
  identically on every rank (the classic DP step);
- stage 1 — optimizer state sharded: gradients reduce-scatter, the update
  runs on each rank's 1/dp flat shard, UPDATES all-gather back;
- stage 2 — + sharded apply: the updated PARAM shards all-gather instead;
- stage 3 — + params sharded at rest in the flat ``[dp, s]`` layout (a
  rank holds its row), all-gathered just in time inside the loss; the
  gather's backward is the reduce-scatter, so the gradients arrive
  already reduce-scattered.

Semantics are identical across stages: the loss is the global masked mean,
and the 1/n scaling comes after the scatter-sum at stages 1-3, as
JAX's. Dropout draws from a ``torch.Generator`` per rank seeded from the
step's seed folded with the rank's index on each batch axis (JAX's
``fold_in(rng, axis_index)``), so shards draw independent masks and a run
repeats. The step must run inside ``with mesh.bind():`` on every rank.

:func:`make_param_sharded_train_step` is the step of a fit whose
parameters shard by a PartitionSpec tree — derived (``tp`` Megatron,
``ep`` expert banks, ``fsdp``) or explicit, JAX's GSPMD step with placed
params (:mod:`.tp`); zero stages stay a pure-dp matter, as in JAX.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..optimizers import apply_updates, tree_leaves, tree_map
from ..sharding import ShardingConfig, as_sharding_config
from . import collectives as C

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of their
    mix) — the counterpart of ``jax.random.fold_in`` for integer seeds."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def rank_generator(rng, axes: Sequence[str], device) -> torch.Generator:
    """The dropout generator of this rank for a step: ``rng`` itself when it
    is a ``torch.Generator``, else a generator on ``device`` seeded with
    the integer ``rng`` folded with the rank's index on each of ``axes`` in
    order."""
    if isinstance(rng, torch.Generator):
        return rng
    seed = int(rng)
    for a in axes:
        seed = fold_in(seed, C.axis_index(a))
    return torch.Generator(device=device).manual_seed(seed)


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_dp_train_step(model, optimizer, mesh, input_name,
                       label_name: Optional[str], sharding: Any = None,
                       param_template=None):
    """The per-rank data-parallel train step for zero stages 0-3:
    ``step(params, opt_state, x, y, mask, rng) -> (params, opt_state,
    loss)``, with ``x`` / ``y`` / ``mask`` this rank's rows (its block of
    the global batch over the config's batch axes) and ``loss`` the global
    masked mean, equal on every rank.

    ``params`` are the trainable tree (leaves requiring a gradient, updated
    in place) — except at stage 3, where they are this rank's ``[1, s]``
    rows of the flat ZeRO-3 tree
    (:func:`~sparkflow_tpu_torch.optimizers_sharded.shard_zero3_params`
    then ``place_zero1_state``), and ``param_template`` gives the standard
    shapes (default: the model's ``param_specs``). For stages >= 1
    ``optimizer`` is the plain transformation; the state is this rank's part
    of ``sharded_update(optimizer, dp, axis).init(params)``
    (``place_zero1_state``). ``rng`` is an integer seed (folded with the
    rank's batch-axis indices) or a ``torch.Generator``.

    ``sharding.dcn_axis`` names a second, slower batch axis (mesh ``{dcn:
    n_slices, dp: per_slice}``): rows shard over both and the gradient
    merge becomes the two-level reduction — reduce-scatter over ``dp``, a
    1/dp-sized all-reduce over ``dcn``."""
    from ..core import make_feeds_builder
    from ..optimizers_sharded import (gathered_params, sharded_apply_update,
                                      sharded_update)

    cfg = as_sharding_config(sharding)
    cfg.validate(mesh, require_data_axis=True)
    if cfg.data_axis not in mesh.axis_names:
        raise ValueError(
            f"data_axis={cfg.data_axis!r} is not a mesh axis "
            f"{list(mesh.axis_names)}")
    stage = cfg.zero_stage
    dp_axis, dcn_axis = cfg.data_axis, cfg.dcn_axis
    build_feeds = make_feeds_builder(input_name, label_name)
    n_shards = mesh.shape[dp_axis]
    two_level = dcn_axis is not None
    axes = (dcn_axis, dp_axis) if two_level else (dp_axis,)

    def sums(local_sum, mask):
        """(global loss sum, global row count) in one all-reduce."""
        tot = C.psum({"s": local_sum.detach().float(),
                      "n": mask.sum().float()}, axes)
        n = torch.clamp_min(tot["n"], 1.0)
        return tot["s"] / n, n

    def local_sum(params, x, y, mask, gen):
        lv = model.loss_vector(params, build_feeds(x, y), train=True,
                               generator=gen)
        return (lv * mask).sum()

    if stage == 0:
        def step(params, opt_state, x, y, mask, rng):
            gen = rank_generator(rng, axes, mask.device)
            s = local_sum(params, x, y, mask, gen)
            leaves = tree_leaves(params)
            grads = _unflatten(params, torch.autograd.grad(s, leaves))
            loss, n = sums(s, mask)
            with torch.no_grad():
                if two_level:
                    # sum-reduce hierarchically, then rescale mean-by-count:
                    # the helper divides by the rank count, the loss by the
                    # example count
                    total = mesh.axis_size(axes)
                    grads = tree_map(lambda g: g * (total / n),
                                     C.hierarchical_psum_mean(
                                         grads, ici_axis=dp_axis,
                                         dcn_axis=dcn_axis))
                else:
                    grads = tree_map(lambda g: g / n,
                                     C.psum(grads, dp_axis))
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                apply_updates(params, updates)
            return params, opt_state, loss

    elif stage in (1, 2):
        wrapped = (sharded_update if stage == 1 else sharded_apply_update)(
            optimizer, n_shards, dp_axis, dcn_axis)

        def step(params, opt_state, x, y, mask, rng):
            gen = rank_generator(rng, axes, mask.device)
            s = local_sum(params, x, y, mask, gen)
            leaves = tree_leaves(params)
            grads = _unflatten(params, torch.autograd.grad(s, leaves))
            loss, n = sums(s, mask)
            # the 1/n mean-normalization applies AFTER the scatter-sum
            # (inside the wrapped update), matching the replicated step's
            # psum(g) / n rounding instead of summing pre-scaled addends
            with torch.no_grad():
                out, opt_state = wrapped.update(grads, opt_state, params,
                                                scale=1.0 / n)
                if stage == 1:
                    apply_updates(params, out)
                else:
                    for p, new in zip(leaves, tree_leaves(out)):
                        p.copy_(new)
            return params, opt_state, loss

    else:  # stage 3: params sharded at rest, gathered just in time
        if param_template is None:
            param_template = {
                ln: {k: torch.empty(shape, device="meta")
                     for k, (shape, _init) in layer.items()}
                for ln, layer in model.param_specs().items()}

        def step(p_flat, opt_state, x, y, mask, rng):
            gen = rank_generator(rng, axes, mask.device)
            # the gather is the forward; its backward reduce-scatters over
            # dp — grads come back as [1, s] shards summed over the axis
            full = gathered_params(p_flat, param_template, dp_axis)
            s = local_sum(full, x, y, mask, gen)
            rows = tree_leaves(p_flat)
            g_sh = list(torch.autograd.grad(s, rows))
            loss, n = sums(s, mask)
            with torch.no_grad():
                if dcn_axis is not None:
                    # only the 1/dp shard crosses the slow hop
                    g_sh = tree_leaves(C.psum(_unflatten(p_flat, g_sh),
                                              dcn_axis))
                g_sh = [g * (1.0 / n) for g in g_sh]
                us, opt_state = optimizer.update(_unflatten(p_flat, g_sh),
                                                 opt_state, p_flat)
                apply_updates(p_flat, us)
            return p_flat, opt_state, loss

    return step


def _leaf_specs(params, specs, name=None) -> list:
    """``(name, spec)`` of every leaf of ``params``, in ``tree_leaves``
    order."""
    if isinstance(params, dict):
        return [x for k in params
                for x in _leaf_specs(params[k], specs[k], k)]
    return [(name, specs)]


def _sub_rows(a, k: int, i: int):
    """Block ``i`` of ``k`` of a dp shard's rows, the rows zero-padded to a
    multiple of ``k`` first (their mask rows are 0: no loss, no
    gradient)."""
    if isinstance(a, tuple):
        return tuple(_sub_rows(p, k, i) for p in a)
    n = a.shape[0]
    c = -(-n // k)
    if c * k > n:
        a = torch.cat([a, a.new_zeros((c * k - n,) + tuple(a.shape[1:]))])
    return a[i * c:(i + 1) * c]


def make_param_sharded_train_step(model, optimizer, mesh, input_name,
                                  label_name: Optional[str], pspecs,
                                  full_shapes, sharding: Any = None):
    """The per-rank step of a fit whose parameters shard by a spec tree
    (the counterpart of JAX's GSPMD step with placed params): ``step(params,
    opt_state, x, y, mask, rng) -> (params, opt_state, loss)``, ``params``
    this rank's slices (:class:`~..parallel.tp.ParamPlacement`),
    ``opt_state`` built on them, ``x`` / ``y`` / ``mask`` this rank's rows
    over the config's batch axes, ``loss`` the global masked mean.
    ``full_shapes`` is a tree of the standard shapes.

    Each leaf's split is a compute split or at rest
    (:class:`~..parallel.tp.PlacementPlan`):

    - ``tp`` computing: the model runs the Megatron forward over the tp
      axis (a copy with ``tp_axis`` set); every tp rank of a dp group sees
      the same rows and draws the same dropout masks (the generator folds
      the batch axes' indices only), so the replicated leaves stay equal
      across them.
    - ``ep`` computing (the expert leaves of an MoE model on ``P("ep",
      ...)``, JAX's GSPMD form): a rank holds ``E/ep`` experts and, like a
      tp rank, its dp group's rows; each MoE layer serves its experts'
      slots and sums over ``ep`` (a copy of the model with
      ``expert_axis`` set, ``models/moe.py``). It composes with ``tp``.
    - at rest (every ``fsdp`` or ``dp`` split, and a ``tp`` / ``ep`` split
      the forward does not compute on): the leaf is gathered just in time
      into its compute-local shape (:func:`~..parallel.tp.gathered_params`);
      its gradient comes back reduce-scattered over an at-rest batch axis
      and sliced over any other, where every rank holds the same whole
      gradient.

    A dp shard's rows split again over ``fsdp`` (padded with zero-mask
    rows to a multiple of it). After the backward each leaf's gradient
    all-reduces over the batch axes its spec does not name, so every leaf
    ends summed over every batch axis once. The loss is the masked mean
    over the global batch, as on one card; the 1/n comes after the sums.
    An MoE model routes the global batch when its rows shard
    (``route_axes``, ``models/moe.py``): capacity, slot order and the
    load-balance term are those of JAX's GSPMD program. ``clip_norm``
    measures the global norm: each leaf's squares summed over the axes its
    spec names (its local gradient is its own block of the whole one), a
    replicated leaf's counted once."""
    import copy
    from ..core import make_feeds_builder
    from ..optimizers import global_norm_sq
    from .tp import PlacementPlan, gathered_params, spec_axes

    cfg = as_sharding_config(sharding)
    plan = PlacementPlan(model, mesh, pspecs, full_shapes)
    dp_axes = cfg.batch_axes(mesh)
    f = mesh.shape.get("fsdp", 1)
    batch_axes = dp_axes + (("fsdp",) if "fsdp" in mesh.axis_names else ())
    leaf_axes = [spec_axes(plan.specs[ln][pn]) for ln, pn in plan.names]
    # the batch axes each leaf's gradient still sums over after the
    # backward, and the leaves by those axes
    sum_groups: dict = {}
    for i, axes in enumerate(leaf_axes):
        rest = tuple(a for a in batch_axes if a not in axes)
        if rest and mesh.axis_size(rest) > 1:
            sum_groups.setdefault(rest, []).append(i)
    gathers = plan.gathers()
    build_feeds = make_feeds_builder(input_name, label_name)
    all_n = mesh.axis_size(batch_axes) if batch_axes else 1
    moe = hasattr(model, "route_axes")
    if plan.tp_axis or plan.ep_axis or (moe and all_n > 1):
        model = copy.copy(model)
        if plan.tp_axis is not None:
            model.tp_axis = plan.tp_axis
        if plan.ep_axis is not None:
            model.expert_axis = plan.ep_axis
        if moe and all_n > 1:
            # JAX's GSPMD step routes the global batch
            model.route_axes = batch_axes

    def norm_sq(leaves):
        rep = [u for u, a in zip(leaves, leaf_axes) if not a]
        total = sum((u.float() * u.float()).sum() for u in rep)
        groups: dict = {}          # the sharded leaves, by their axes
        for u, a in zip(leaves, leaf_axes):
            if a:
                groups.setdefault(a, []).append(u)
        for axes, shd in groups.items():
            part = sum((u.float() * u.float()).sum() for u in shd)
            total = total + C.psum({"s": part}, axes)["s"]
        return total

    def step(params, opt_state, x, y, mask, rng):
        if f > 1:
            i = C.axis_index("fsdp")
            x, y, mask = _sub_rows(x, f, i), _sub_rows(y, f, i), \
                _sub_rows(mask, f, i)
        gen = rank_generator(rng, batch_axes, mask.device)
        full = (gathered_params(params, plan, batch_axes) if gathers
                else params)
        lv = model.loss_vector(full, build_feeds(x, y), train=True,
                               generator=gen)
        s = (lv * mask).sum()
        leaves = tree_leaves(params)
        grads = list(torch.autograd.grad(s, leaves))
        tot = {"s": s.detach().float(), "n": mask.sum().float()}
        if all_n > 1:
            tot = C.psum(tot, batch_axes)
        n = torch.clamp_min(tot["n"], 1.0)
        loss = tot["s"] / n
        with torch.no_grad():
            for axes in sorted(sum_groups):
                idx = sum_groups[axes]
                out = C.psum({str(i): grads[i] for i in idx}, axes)
                for i in idx:
                    grads[i] = out[str(i)]
            grads = [g / n for g in grads]
            with global_norm_sq(norm_sq):
                updates, opt_state = optimizer.update(
                    _unflatten(params, grads), opt_state, params)
            apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_dp_shardmap_train_step(model, optimizer, mesh, input_name,
                                label_name: Optional[str],
                                dp_axis: str = "dp",
                                dcn_axis: Optional[str] = None):
    """Stage-0 shim over :func:`make_dp_train_step`: gradients all-reduced,
    the optimizer runs identically on every rank."""
    cfg = ShardingConfig(data_axis=dp_axis, dcn_axis=dcn_axis, zero_stage=0)
    return make_dp_train_step(model, optimizer, mesh, input_name, label_name,
                              sharding=cfg)


def make_dp_zero1_train_step(model, optimizer, mesh, input_name,
                             label_name: Optional[str],
                             dp_axis: str = "dp",
                             dcn_axis: Optional[str] = None):
    """Stage-1 shim over :func:`make_dp_train_step`: gradients
    reduce-scatter over ``dp_axis``, the update runs on each rank's 1/dp
    shard with the state sharded the same way, and the updates all-gather
    back."""
    cfg = ShardingConfig(data_axis=dp_axis, dcn_axis=dcn_axis, zero_stage=1)
    return make_dp_train_step(model, optimizer, mesh, input_name, label_name,
                              sharding=cfg)


__all__ = ["fold_in", "make_dp_shardmap_train_step", "make_dp_train_step",
           "make_dp_zero1_train_step", "make_param_sharded_train_step",
           "rank_generator"]
