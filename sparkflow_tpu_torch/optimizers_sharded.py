"""ZeRO weight-update sharding: optimizer state, gradients and parameters
split over ``dp`` — the port of the JAX package's ``optimizers_sharded.py``,
over this package's optax-like :mod:`.optimizers`.

Layout (the JAX package's, bit for bit, so checkpoints interchange). The
zero GLOBAL optimizer state is ``inner.init`` applied to a flattened view
of the params where every leaf is reshaped ``[n_shards,
ceil(size/n_shards)]`` (flat, zero-padded). Per-param state leaves carry
that ``[n_shards, s]`` shape; scalar leaves (adam's count, ...) stay
whole. A rank holds ONE row of each ``[n_shards, s]`` leaf, ``[1, s]``,
its row being its index on the data axis (:func:`place_zero1_state`) —
what a device holds inside ``shard_map`` in JAX. Zero padding is inert:
every registry optimizer is elementwise, so pad lanes never contaminate
real ones and are trimmed by the final all-gather.

Stages (driven by :class:`~sparkflow_tpu_torch.sharding.ShardingConfig`):

- ZeRO-1 (:func:`sharded_update`): gradients reduce-scatter, the inner
  update runs on the ``[1, s]`` shards, UPDATES all-gather back;
- ZeRO-2 (:func:`sharded_apply_update`): the same transport, the apply
  also runs on the shards and the updated PARAM shards all-gather back;
- ZeRO-3 (:func:`shard_zero3_params`, :func:`gathered_params`): the params
  live at rest in the flat layout, a rank holding its row; the forward
  all-gathers them just in time through an ``autograd.Function`` whose
  backward reduce-scatters the gradient — JAX's ``all_gather`` transpose.

Per dtype, every leaf's flat ``[n_shards, s_i]`` view is laid side by side
in one ``[n_shards, sum(s_i)]`` buffer, so a step moves its gradients in
ONE reduce-scatter and its results in ONE all-gather; row ``r`` of that
buffer is the concatenation of every leaf's row ``r``, so each rank's
shard is exactly JAX's per-leaf shard.

Checkpoint interop: :func:`gather_zero1_state` / :func:`shard_zero1_state`
convert between the global zero layout and the standard (param-shaped)
state ``inner.init(params)`` builds; :func:`gather_rows` turns a rank's
rows back into the global layout. The trainer checkpoints the STANDARD
form, so directories interchange between stages, dp sizes and the JAX
package.

Caveat (as in JAX): the wrapped update runs shard-locally, so a chained
``clip_by_global_norm`` inside it would measure only its shard's norm; the
trainer's ``auto`` mode declines to shard with ``clip_norm`` or
``ema_decay`` configured.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .optimizers import GradientTransformation, tree_leaves, tree_map
from .sharding import at_rest_leaf_spec


# ---------------------------------------------------------------------------
# Generic state trees (dicts, tuples, named tuples, lists, None, scalars)
# ---------------------------------------------------------------------------


def state_leaves(tree) -> list:
    """Every non-container leaf of an optimizer state (tensors, Python
    counters), depth first."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in state_leaves(v)]
    return [tree]


def _state_rebuild(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _state_rebuild(v, it) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_state_rebuild(v, it) for v in like]
        return (type(like)(*vals) if hasattr(like, "_fields")
                else type(like)(vals))
    return next(it)


def state_map(fn: Callable, tree):
    """``fn`` over every non-container leaf of ``tree``, in a tree of the
    same structure."""
    return _state_rebuild(tree, iter([fn(x) for x in state_leaves(tree)]))


def _meta(tree):
    """A tree of ``meta`` tensors shaped like ``tree`` (tensors, or
    objects with ``shape`` and ``dtype``)."""
    def one(x):
        dt = x.dtype if isinstance(x.dtype, torch.dtype) else torch.float32
        return torch.empty(tuple(x.shape), dtype=dt, device="meta")
    return tree_map(one, tree)


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _numel(x) -> int:
    return int(np.prod(_shape(x), dtype=np.int64))


def _nbytes(x) -> int:
    """Bytes of a state leaf as a device holds it: a tensor's, and 4 for a
    Python counter (optax keeps them as int32 / float32 scalars)."""
    if torch.is_tensor(x):
        return _numel(x) * x.element_size()
    return 4


# ---------------------------------------------------------------------------
# The flat layout
# ---------------------------------------------------------------------------


def _flat_pad(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Ravel + zero-pad a leaf so its size divides ``n_shards``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n_shards
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def _flat2d(params, n_shards: int):
    """The flattened params view the zero state is initialised over: every
    leaf ``[n_shards, ceil(size/n_shards)]``."""
    return tree_map(lambda p: _flat_pad(p, n_shards).view(n_shards, -1),
                    params)


def _is_row(x, n_shards: Optional[int] = None) -> bool:
    """A leaf in the flat layout: ``[n_shards, s]`` (global) or, with
    ``n_shards`` None, ``[1, s]`` (one rank's row)."""
    s = _shape(x)
    return torch.is_tensor(x) and len(s) >= 2 and (
        s[0] == n_shards if n_shards is not None else s[0] == 1)


def _columns(tensors: Sequence[torch.Tensor], n: int) -> Tuple[
        torch.Tensor, List[int]]:
    """Lay each tensor's flat ``[n, s_i]`` view side by side: ``([n * sum
    s_i] buffer, widths)``."""
    cols = [_flat_pad(t, n).view(n, -1) for t in tensors]
    return (torch.cat(cols, dim=1).reshape(-1) if len(cols) > 1
            else cols[0].reshape(-1)), [c.shape[1] for c in cols]


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return list(groups.values())


def _scatter_shards(grads: Sequence[torch.Tensor], n: int, axis_name: str,
                    dcn_axis: Optional[str]) -> List[torch.Tensor]:
    """Each gradient's summed ``[1, s_i]`` shard over ``axis_name`` (and
    ``dcn_axis``): one reduce-scatter per dtype."""
    from .parallel.collectives import _group, _reduce_scatter_flat, psum
    group, _ = _group(axis_name)
    out: List[torch.Tensor] = [None] * len(grads)
    for idx in _by_dtype(grads):
        buf, widths = _columns([grads[i] for i in idx], n)
        shard = _reduce_scatter_flat(buf, n, group)
        if dcn_axis is not None:
            # 1/n_shards of the bytes on the slow cross-slice hop
            shard = psum({"s": shard}, dcn_axis)["s"]
        off = 0
        for i, w in zip(idx, widths):
            out[i] = shard[off:off + w].view(1, w)
            off += w
    return out


def _gather_rows(rows: Sequence[torch.Tensor], n: int,
                 axis_name: str) -> List[torch.Tensor]:
    """Every rank's ``[1, s_i]`` rows -> the ``[n, s_i]`` globals: one
    all-gather per dtype."""
    from .parallel.collectives import _all_gather_flat, _group
    group, _ = _group(axis_name)
    out: List[torch.Tensor] = [None] * len(rows)
    for idx in _by_dtype(rows):
        widths = [rows[i].shape[-1] for i in idx]
        buf = torch.cat([rows[i].reshape(-1) for i in idx])
        full = _all_gather_flat(buf, n, group).view(n, -1)
        off = 0
        for i, w in zip(idx, widths):
            out[i] = full[:, off:off + w]
            off += w
    return out


def _unshard(full: torch.Tensor, like) -> torch.Tensor:
    return full.reshape(-1)[:_numel(like)].view(_shape(like)).to(like.dtype)


def _row_of(p: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    flat = _flat_pad(p, n)
    s = flat.numel() // n
    return flat[idx * s:(idx + 1) * s].view(1, s)


# ---------------------------------------------------------------------------
# ZeRO-1 / ZeRO-2 transformations
# ---------------------------------------------------------------------------


def _wrap(inner: GradientTransformation, n_shards: int, axis_name: str,
          dcn_axis: Optional[str], apply: bool) -> GradientTransformation:
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    name = "sharded_apply_update" if apply else "sharded_update"

    def init_fn(params):
        return inner.init(_flat2d(params, n_shards))

    def update_fn(grads, state, params=None, *, scale=None):
        if params is None:
            raise ValueError(f"{name} requires params at update time")
        from .parallel.collectives import axis_index
        idx = axis_index(axis_name)
        g_leaves, p_leaves = tree_leaves(grads), tree_leaves(params)
        gs = _scatter_shards(g_leaves, n_shards, axis_name, dcn_axis)
        if scale is not None:
            # scaling the summed shard (not each addend) keeps the same
            # rounding as the replicated psum(g) * scale path
            gs = [g * scale for g in gs]
        it = iter(gs)
        g_tree = tree_map(lambda _: next(it), grads)
        p_tree = tree_map(lambda p: _row_of(p.detach(), n_shards, idx),
                          params)
        us, state = inner.update(g_tree, state, p_tree)
        rows = tree_leaves(us)
        if apply:
            rows = [p + u.to(p.dtype)
                    for p, u in zip(tree_leaves(p_tree), rows)]
        fulls = _gather_rows(rows, n_shards, axis_name)
        it = iter(_unshard(f, p) for f, p in zip(fulls, p_leaves))
        return tree_map(lambda _: next(it), params), state

    return GradientTransformation(init_fn, update_fn)


def sharded_update(inner: GradientTransformation, n_shards: int,
                   axis_name: str = "dp",
                   dcn_axis: Optional[str] = None) -> GradientTransformation:
    """Wrap ``inner`` with ZeRO-1 flatten -> pad -> shard-local update ->
    gather semantics.

    - ``init(params)`` builds the GLOBAL zero state (per-param leaves
      ``[n_shards, s]``); a rank keeps its row (:func:`place_zero1_state`).
    - ``update(grads, state, params, scale=None)`` runs on every rank of the
      bound mesh with this rank's ``[1, s]`` state: it reduce-scatters the
      local gradients over ``axis_name`` (a SUM, scaled by ``scale`` after
      the sum), slices the matching param rows, applies ``inner`` to the
      ``[1, s]`` views, and all-gathers the updates back to the param
      shapes. With ``dcn_axis`` the scattered shard is also summed across
      that axis, so the slow hop carries ``1/n_shards`` of the bytes.
    """
    return _wrap(inner, n_shards, axis_name, dcn_axis, apply=False)


def sharded_apply_update(inner: GradientTransformation, n_shards: int,
                         axis_name: str = "dp",
                         dcn_axis: Optional[str] = None
                         ) -> GradientTransformation:
    """ZeRO-2 companion of :func:`sharded_update`: the same state layout and
    gradient transport, but ``update(...)`` returns ``(new_params, state)``
    — the apply ``p + u`` runs on the shards and the updated param shards
    all-gather back, so no full-size update tree exists. The caller copies
    ``new_params`` into its parameters."""
    return _wrap(inner, n_shards, axis_name, dcn_axis, apply=True)


# ---------------------------------------------------------------------------
# ZeRO-3 parameters
# ---------------------------------------------------------------------------


def shard_zero3_params(params, n_shards: int):
    """Params -> the ZeRO-3 at-rest layout: every leaf flat-padded to
    ``[n_shards, ceil(size/n_shards)]`` (the view the zero state is
    initialised over). A rank keeps its row (:func:`place_zero1_state`)."""
    return _flat2d(params, n_shards)


def gather_zero3_params(flat_params, template):
    """ZeRO-3 global flat layout -> standard param tree shaped like
    ``template`` (tensors, or objects with ``shape`` and ``dtype``)."""
    return tree_map(
        lambda f, t: torch.as_tensor(f).reshape(-1)[:_numel(t)].reshape(
            _shape(t)).to(t.dtype if isinstance(t.dtype, torch.dtype)
                          else torch.float32),
        flat_params, template)


def zero3_param_specs(flat_params, n_shards: int, axis_name: str = "dp"):
    """Spec tree for ZeRO-3 at-rest params (row-sharded like the state)."""
    return zero1_state_specs(flat_params, n_shards, axis_name)


class _Zero3Gather(torch.autograd.Function):
    """All rows -> full params in the forward; in the backward the full
    gradients reduce-scatter back to this rank's rows (summed over the
    axis) — the ZeRO-2 scatter fused into the backward."""

    @staticmethod
    def forward(ctx, axis_name, n, likes, *rows):
        from .parallel.mesh import bound_mesh
        ctx.axis_name, ctx.n, ctx.mesh = axis_name, n, bound_mesh()
        fulls = _gather_rows([r.detach() for r in rows], n, axis_name)
        return tuple(_unshard(f, like) for f, like in zip(fulls, likes))

    @staticmethod
    def backward(ctx, *grads):
        # autograd runs a CUDA backward on its own thread: bind the mesh
        with ctx.mesh.bind():
            shards = _scatter_shards([g.contiguous() for g in grads], ctx.n,
                                     ctx.axis_name, None)
        return (None, None, None) + tuple(shards)


def gathered_params(p_local, template, axis_name: str = "dp"):
    """Inside a bound mesh: the full params from every rank's ``[1, s]``
    rows (``p_local``, leaves requiring a gradient), shaped like
    ``template``. Differentiating a loss of the result gives ``p_local``
    gradients that arrive already reduce-scattered (summed over
    ``axis_name``) — JAX's ``gathered_param_view`` over the whole tree, in
    one all-gather and one reduce-scatter per dtype."""
    from .parallel.collectives import axis_size
    n = axis_size(axis_name)
    pairs: list = []       # (template leaf, row), matched by key
    tree_map(lambda t, r: pairs.append((t, r)), template, p_local)
    likes = [torch.empty(_shape(t), dtype=(t.dtype if isinstance(
        t.dtype, torch.dtype) else torch.float32), device="meta")
        for t, _ in pairs]
    fulls = _Zero3Gather.apply(axis_name, n, likes, *(r for _, r in pairs))
    it = iter((fulls,) if torch.is_tensor(fulls) else fulls)
    return tree_map(lambda _: next(it), template)


# ---------------------------------------------------------------------------
# Rows, specs, placement
# ---------------------------------------------------------------------------


def zero1_state_specs(state, n_shards: int, axis_name: str = "dp"):
    """Spec tree for a zero state: ``[n_shards, ...]`` leaves shard
    row-wise over ``axis_name``, everything else is whole — the rule of
    :func:`~sparkflow_tpu_torch.sharding.at_rest_leaf_spec`
    (``layout='flat'``)."""
    return state_map(lambda x: at_rest_leaf_spec(
        _shape(x), axis_name, layout="flat", n_shards=n_shards), state)


def place_zero1_state(state, mesh, n_shards: int, axis_name: str = "dp"):
    """A global zero-layout tree (state or ZeRO-3 params) -> this rank's
    part: the row of every ``[n_shards, s]`` leaf at the rank's index on
    ``axis_name`` of ``mesh`` (a copy, ``[1, s]``), other leaves as they
    are."""
    idx = mesh.axis_index(axis_name)

    def one(x):
        if _is_row(x, n_shards):
            return x[idx:idx + 1].clone()
        return x
    return state_map(one, state)


def gather_rows(state, n_shards: int, axis_name: str = "dp"):
    """Inside a bound mesh: every rank's ``[1, s]`` rows -> the global
    ``[n_shards, s]`` leaves (other leaves as they are) — the inverse of
    :func:`place_zero1_state`, one all-gather per dtype."""
    leaves = state_leaves(state)
    idx = [i for i, x in enumerate(leaves) if _is_row(x)]
    if idx:
        fulls = _gather_rows([leaves[i] for i in idx], n_shards, axis_name)
        leaves = list(leaves)
        for i, f in zip(idx, fulls):
            leaves[i] = f
    return _state_rebuild(state, iter(leaves))


def _paired_leaves(inner, params, state):
    std = inner.init(_meta(params))
    return state_leaves(std), state_leaves(state), std


def gather_zero1_state(inner: GradientTransformation, params, state,
                       n_shards: int):
    """Global zero-layout state -> the standard (param-shaped) state
    ``inner.init(params)`` would build — what the trainer checkpoints.
    Leaves whose shape already matches the standard template are kept
    (scalars, counters); the others are flat-padded views and are trimmed
    and reshaped back."""
    std_leaves, z_leaves, std = _paired_leaves(inner, params, state)
    out = []
    for tmpl, z in zip(std_leaves, z_leaves):
        if not torch.is_tensor(tmpl) or _shape(z) == _shape(tmpl):
            out.append(z)
        else:
            out.append(torch.as_tensor(z).reshape(-1)[:_numel(tmpl)].reshape(
                _shape(tmpl)))
    return _state_rebuild(std, iter(out))


def shard_zero1_state(inner: GradientTransformation, params, state,
                      n_shards: int):
    """Standard (param-shaped) state -> the global zero layout for
    ``n_shards`` shards: the inverse of :func:`gather_zero1_state`. The pad
    width is recomputed here, so a checkpoint written under one dp size
    re-shards onto another."""
    std_leaves, s_leaves, std = _paired_leaves(inner, params, state)
    z_leaves = state_leaves(inner.init(_flat2d(_meta(params), n_shards)))
    out = []
    for tmpl, zt, s in zip(std_leaves, z_leaves, s_leaves):
        if not torch.is_tensor(zt) or _shape(zt) == _shape(s):
            out.append(s)
        else:
            out.append(_flat_pad(torch.as_tensor(s), n_shards).view(
                _shape(zt)))
    return _state_rebuild(std, iter(out))


def has_per_param_state(optimizer: GradientTransformation, params) -> bool:
    """True when ``optimizer.init(params)`` carries array (per-param) state
    — the states zero sharding actually shrinks. sgd / proximal_gd carry
    none, so ``auto`` mode leaves them replicated."""
    return any(torch.is_tensor(x) and x.dim() >= 1
               for x in state_leaves(optimizer.init(_meta(params))))


def state_bytes_per_device(state) -> int:
    """Bytes ONE rank holds for a state tree: each tensor leaf its local
    size (a zero-placed state counts its rows), each counter 4."""
    return sum(_nbytes(x) for x in state_leaves(state))


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in state_leaves(tree))


def _row_shard_bytes(tree, n_shards: int) -> int:
    """Per-rank bytes of a global zero-layout tree: ``[n_shards, s]`` leaves
    contribute one row, everything else its full size."""
    total = 0
    for x in state_leaves(tree):
        if _is_row(x, n_shards):
            total += _nbytes(x) // n_shards
        else:
            total += _nbytes(x)
    return total


def zero_memory_report(inner: GradientTransformation, params,
                       n_shards: int, zero_stage: int) -> dict:
    """Structural per-rank byte accounting for one zero stage (layouts, not
    allocator watermarks; computed on ``meta`` tensors).

    - ``params_at_rest`` — param bytes resident per rank between steps;
    - ``grads_at_update`` — the gradient entering the optimizer update (full
      tree at stage 0; the post-scatter ``[1, s]`` shards at stages 1-3);
    - ``opt_state_at_rest`` — optimizer state per rank;
    - ``apply_temps`` — the apply step's transient: the all-gathered full
      update tree at stages 0-1, shard-sized at 2-3;
    - ``ideal_grad_opt`` — the 1/n_shards share of (full grads + full opt
      state).
    """
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage!r}")
    meta = _meta(params)
    params_b = _tree_bytes(meta)
    opt_std_b = _tree_bytes(inner.init(meta))
    if zero_stage == 0:
        report = dict(params_at_rest=params_b, grads_at_update=params_b,
                      opt_state_at_rest=opt_std_b, apply_temps=params_b)
    else:
        flat = _flat2d(meta, n_shards)
        shard_b = _row_shard_bytes(flat, n_shards)
        report = dict(
            params_at_rest=(shard_b if zero_stage >= 3 else params_b),
            grads_at_update=shard_b,
            opt_state_at_rest=_row_shard_bytes(inner.init(flat), n_shards),
            apply_temps=(params_b if zero_stage == 1 else shard_b))
    report["grad_opt_at_update"] = (report["grads_at_update"]
                                    + report["opt_state_at_rest"])
    report["ideal_grad_opt"] = (params_b + opt_std_b) / max(n_shards, 1)
    report["full_params"] = params_b
    report["full_opt_state"] = opt_std_b
    report["n_shards"] = n_shards
    report["zero_stage"] = zero_stage
    return report


__all__ = ["gather_rows", "gather_zero1_state", "gather_zero3_params",
           "gathered_params", "has_per_param_state",
           "place_zero1_state", "shard_zero1_state", "shard_zero3_params",
           "sharded_apply_update", "sharded_update", "state_bytes_per_device",
           "state_leaves", "state_map", "zero1_state_specs", "zero3_param_specs", "zero_memory_report"]
