"""Tensor-parallel (Megatron) and fsdp parameter sharding — the port of the
JAX package's ``parallel/tp.py``.

The JAX package places each parameter with a ``NamedSharding`` and lets
GSPMD partition one jitted step over the mesh. The port has no
``NamedSharding``: a rank holds plain local tensors. So the spec rules are
the same (:func:`derive_param_pspecs`, :func:`fsdp_pspecs`, the models'
``param_pspecs()``), and placing a tree means taking this rank's slice of
each leaf by its spec (:func:`shard_params`); :func:`gather_params` is the
collective that returns the standard layout. The optimizer state is built
on the local leaves, so it inherits their placement as JAX's does.

JAX's ``make_sharded_train_step`` (a jitted GSPMD step) is
:func:`make_sharded_train_step` here: the per-rank step of
:func:`~sparkflow_tpu_torch.parallel.dp.make_param_sharded_train_step` on
the model's own spec tree. A ``tp`` model runs the Megatron forward
(column-parallel qkv and fc1, row-parallel o and fc2, one all-reduce after
each, :func:`~sparkflow_tpu_torch.parallel.collectives.tp_enter` /
:func:`~sparkflow_tpu_torch.parallel.collectives.tp_exit`); an fsdp model
gathers each sharded leaf just in time (:func:`gathered_params`, whose
backward reduce-scatters).

Layouts. A ``tp`` rank takes a contiguous block of ``qkv_kernel``'s
columns, so it must hold them in :func:`tp_pack_params`'s ``(tp, 3, H/tp,
d)`` order; :func:`gather_params` undoes that order exactly, so a
checkpoint, ``params_to_list``, a weight-store publish or a fitted model's
weights always carry the standard layout. Row-parallel biases (``o_bias``,
``fc2_bias``): every path of the port adds them once after the sum (GSPMD's
arithmetic), so its packing only permutes the columns
(``divide_biases=False``). JAX's decode plane instead adds ``bias / tp`` on
every shard before its psum; :func:`tp_pack_params` keeps that form, bit
for bit, as the JAX package's counterpart.

Serving is one process (:class:`TPShards`): each block's leaves are split
into per-shard trees on the shards' devices, every block half runs on each
shard, and the partials are summed in float32 on shard 0's device in shard
order, rounded to the compute dtype once. Under ``ep`` an MoE block's
expert bank is split the same way into an :class:`EPShards`, each shard
serving its experts' slots.

Expert parallelism in training is the same machinery: the MoE models'
rules put the expert leaves on ``P("ep", ...)``, so a rank's slice of a
bank is its ``E/ep`` experts along dim 0 (:func:`shard_params`) and
:func:`gather_params` returns the whole bank; an ``ep`` rank's copy of the
model sets ``expert_axis`` (:func:`~.dp.make_param_sharded_train_step`).

Any tree. A fit may be given an explicit spec tree (JAX places any
PartitionSpec pytree), ``tp`` with ``fsdp`` included.
:class:`PlacementPlan` decides leaf by leaf: a leaf's ``tp`` / ``ep``
split that matches the model's own rules is a compute split (the forward
runs on the local block, the qkv columns packed), every other split is at
rest, stored sharded and gathered just in time into the compute-local
leaf (:func:`gathered_params`, one stage per axis, minor axis first). A
tree that misses one of the rules' ``tp`` splits computes on no ``tp``:
the plain forward runs on every rank. :func:`check_pspec_tree` refuses a
tree of another structure, and a split its axes do not divide, as JAX's
placement does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..sharding import P, PartitionSpec, at_rest_leaf_spec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _spec_map(fn, pspecs):
    """``fn`` over every PartitionSpec leaf of a nested dict."""
    if _is_spec(pspecs):
        return fn(pspecs)
    return {k: _spec_map(fn, v) for k, v in pspecs.items()}


def filter_pspec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop axes the mesh doesn't have (so e.g. megatron 'tp' rules place
    cleanly on an {'ep'}-only or {'dp'}-only mesh as replicated)."""
    return _keep_axes(spec, mesh.axis_names)


def _keep_axes(spec: PartitionSpec, names) -> PartitionSpec:
    def keep(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in names)
            # one axis left reads as its bare name, as jax's P has it
            return (kept[0] if len(kept) == 1 else kept) if kept else None
        return a if a in names else None

    return P(*(keep(a) for a in spec))


def rename_pspec_axes(pspecs, mapping: dict):
    """Rename axis names inside a PartitionSpec pytree — e.g. the megatron
    rules' literal ``'tp'``/``'ep'`` onto a ShardingConfig's configured
    ``tp_axis``/``ep_axis``. Axes not in ``mapping`` pass through."""
    def rename_entry(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            return tuple(mapping.get(x, x) for x in a)
        return mapping.get(a, a)

    return _spec_map(lambda s: P(*(rename_entry(a) for a in s)), pspecs)


def fsdp_pspecs(param_specs, axis: str = "fsdp", min_size: int = 2 ** 16):
    """ZeRO-style specs from a model's ``param_specs()``: big tensors shard
    their largest dim over ``axis``; small ones replicate. The per-leaf rule
    is :func:`~sparkflow_tpu_torch.sharding.at_rest_leaf_spec`
    (``layout='gspmd'``) — the SAME decision the flat ZeRO-3 layout applies
    to its ``[n, s]`` leaves, expressed on tensors kept in model shape."""
    return {
        lname: {
            pname: at_rest_leaf_spec(shape, axis, layout="gspmd",
                                     min_size=min_size)
            for pname, (shape, _init) in pspec.items()}
        for lname, pspec in param_specs.items()}


def derive_param_pspecs(model, mesh, sharding=None):
    """Parameter PartitionSpecs for running ``model`` on ``mesh``.

    - mesh has ``tp``/``ep`` (or the axes a ``sharding`` config names for
      them) and the model publishes megatron-style rules (``param_pspecs``,
      transformer/resnet/moe families) -> those rules, renamed to the
      configured axes (axes absent from the mesh degrade to replication via
      :func:`filter_pspec` inside :func:`shard_params`);
    - mesh has ``fsdp`` -> ZeRO-style :func:`fsdp_pspecs` derived from the
      model's ``param_specs()`` — works for ANY model incl. the ``nn``-DSL
      graphs (largest dim of every big tensor shards, small ones replicate);
    - otherwise (pure dp) -> ``None``: replicate params, shard the batch.

    The trainer and both serving engines call this one entry point.
    """
    names = {"tp": "tp", "ep": "ep"}
    if sharding is not None:
        if getattr(sharding, "tp_axis", None):
            names["tp"] = sharding.tp_axis
        if getattr(sharding, "ep_axis", None):
            names["ep"] = sharding.ep_axis
    has_tp = any(a in mesh.axis_names for a in (names["tp"], names["ep"]))
    has_fsdp = "fsdp" in mesh.axis_names
    if has_tp and has_fsdp:
        # auto-composing megatron rules WITH ZeRO sharding needs per-tensor
        # axis assignments no heuristic can guess; refusing beats silently
        # replicating one of the two requested shardings
        raise ValueError(
            "combined tp/ep + fsdp sharding cannot be auto-derived; pass an "
            "explicit PartitionSpec pytree (Trainer(param_sharding=...)) or "
            "drop one of the axes")
    if has_tp and hasattr(model, "param_pspecs"):
        specs = model.param_pspecs()
        if names["tp"] != "tp" or names["ep"] != "ep":
            specs = rename_pspec_axes(specs, {"tp": names["tp"],
                                              "ep": names["ep"]})
        return specs
    if has_fsdp and hasattr(model, "param_specs"):
        return fsdp_pspecs(model.param_specs(), axis="fsdp")
    return None


# ---------------------------------------------------------------------------
# The tp column layout
# ---------------------------------------------------------------------------


def qkv_permutation(num_heads: int, head_dim: int, tp: int) -> torch.Tensor:
    """Column order of a packed ``qkv_kernel``: the ``(3, H, d)`` columns
    regrouped as ``(tp, 3, H/tp, d)``, so rank ``r``'s contiguous block is
    ``[q_r | k_r | v_r]`` of its own heads."""
    H, d = int(num_heads), int(head_dim)
    if H % tp:
        raise ValueError(f"num_heads={H} is not divisible by tp={tp}")
    return (torch.arange(3 * H * d).reshape(3, tp, H // tp, d)
            .permute(1, 0, 2, 3).reshape(-1))


def _is_attention_block(sub) -> bool:
    return isinstance(sub, dict) and "qkv_kernel" in sub


def make_sharded_train_step(model, optimizer, mesh, input_name: str,
                            label_name: Optional[str], dp_axis: str = "dp"):
    """The per-rank train step of a fit whose parameters shard by the
    model's own spec tree (:func:`derive_param_pspecs`: Megatron rules on a
    ``tp`` / ``ep`` mesh, :func:`fsdp_pspecs` on an ``fsdp`` one, replicated
    otherwise), the batch over ``dp_axis``. Inside the bound mesh:

        step = make_sharded_train_step(model, optimizer, mesh, 'input_ids', 'y')
        params = step.placement.place(model.init(seed=0))   # this rank's slices
        opt_state = optimizer.init(params)                  # inherits placement
        params, opt_state, loss = step(params, opt_state, x, y, mask, seed)

    ``x`` / ``y`` / ``mask`` are this rank's rows over ``dp_axis``, ``seed``
    an int for dropout, ``loss`` the global masked mean;
    ``step.placement.gather(params)`` (a collective) returns the standard
    layout."""
    from ..sharding import ShardingConfig
    from .dp import make_param_sharded_train_step
    template = {ln: {pn: torch.empty(shape, device="meta")
                     for pn, (shape, _init) in layer.items()}
                for ln, layer in model.param_specs().items()}
    pspecs = derive_param_pspecs(model, mesh) or {
        ln: {pn: P() for pn in layer} for ln, layer in template.items()}
    step = make_param_sharded_train_step(
        model, optimizer, mesh, input_name, label_name, pspecs, template,
        sharding=ShardingConfig(data_axis=dp_axis))
    step.placement = ParamPlacement(model, mesh, pspecs, template)
    return step


def tp_pack_params(model, params, tp: int, *, divide_biases: bool = True):
    """Relayout a transformer params tree for tensor parallelism (the JAX
    package's decode-plane form, bit for bit with ``divide_biases``).

    ``qkv_kernel``'s columns (and ``qkv_bias``) permute to ``(tp, 3, H/tp,
    d)`` order (:func:`qkv_permutation`); with ``divide_biases`` the
    row-parallel biases (``o_bias``, ``fc2_bias``) divide by ``tp`` so a sum
    of the shards restores them exactly once — exact in floating point for
    power-of-two ``tp``. Training and predict pack with
    ``divide_biases=False`` and add those biases once after the sum. Expert
    banks, router, norms and embeddings pass through untouched. An int8
    tree is refused."""
    if tp <= 1:
        return params
    perm = qkv_permutation(model.num_heads, model.head_dim, tp)

    def pack_block(bp):
        if any(k.endswith("kernel_q8") for k in bp):
            raise ValueError(
                "tensor-parallel serving does not compose with int8-"
                "quantized params; quantize or shard the model, not both")
        bp = dict(bp)
        p = perm.to(bp["qkv_kernel"].device)
        bp["qkv_kernel"] = bp["qkv_kernel"][:, p]
        if "qkv_bias" in bp:
            bp["qkv_bias"] = bp["qkv_bias"][p]
        if divide_biases:
            if "o_bias" in bp:
                bp["o_bias"] = bp["o_bias"] / tp
            if "fc2_bias" in bp:
                bp["fc2_bias"] = bp["fc2_bias"] / tp
        return bp

    return {name: (pack_block(sub) if _is_attention_block(sub) else sub)
            for name, sub in params.items()}


def tp_unpack_params(model, params, tp: int):
    """The inverse of ``tp_pack_params(..., divide_biases=False)``: packed
    ``qkv`` columns back to the standard ``(3, H, d)`` order."""
    if tp <= 1:
        return params
    inv = torch.argsort(qkv_permutation(model.num_heads, model.head_dim, tp))

    def unpack_block(bp):
        bp = dict(bp)
        p = inv.to(bp["qkv_kernel"].device)
        bp["qkv_kernel"] = bp["qkv_kernel"][:, p]
        if "qkv_bias" in bp:
            bp["qkv_bias"] = bp["qkv_bias"][p]
        return bp

    return {name: (unpack_block(sub) if _is_attention_block(sub) else sub)
            for name, sub in params.items()}


# ---------------------------------------------------------------------------
# A rank's slice of a leaf, and the gather back
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def sharded_dims(spec: PartitionSpec) -> List[tuple]:
    """``[(dim, axes)]`` of the dimensions a spec shards."""
    return [(d, _entry_axes(a)) for d, a in enumerate(spec) if a is not None]


def spec_axes(spec: PartitionSpec) -> tuple:
    """Every mesh axis a spec shards over."""
    return tuple(a for _d, axes in sharded_dims(spec) for a in axes)


def _chunk(n: int, k: int) -> int:
    return -(-int(n) // int(k))


def _bounds(n: int, k: int, i: int):
    c = _chunk(n, k)
    lo = min(n, i * c)
    return lo, min(n, lo + c)


def leaf_slice(t: torch.Tensor, spec: PartitionSpec, mesh,
               rank: Optional[int] = None,
               index: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """``t``'s block on a rank: each sharded dimension cut into ``k`` chunks
    of ``ceil(n / k)`` (the last one shorter when ``k`` does not divide
    ``n``), ``k`` the size of its axes, the chunk at the rank's row-major
    index along them. ``index`` gives the coordinates directly (one-process
    serving) instead of ``rank``'s."""
    for dim, axes in sharded_dims(spec):
        k, i = 1, 0
        for a in axes:
            pos = (index[a] if index is not None
                   else mesh.coords(mesh_rank(rank))[a])
            k, i = k * mesh.shape[a], i * mesh.shape[a] + pos
        lo, hi = _bounds(t.shape[dim], k, i)
        t = t.narrow(dim, lo, hi - lo)
    return t


def mesh_rank(rank: Optional[int]) -> int:
    if rank is not None:
        return int(rank)
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _zip(fn, tree, *others):
    """``fn(leaf, *other leaves)`` over a params tree and trees of its
    structure (specs, shapes)."""
    if isinstance(tree, dict):
        return {k: _zip(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def filtered_pspecs(pspecs, mesh):
    """A spec tree with the axes ``mesh`` lacks (or has at size 1 only)
    dropped."""
    live = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    return _spec_map(lambda s: _keep_axes(s, live), pspecs)


def shard_params(params, mesh, pspecs, rank: Optional[int] = None):
    """This rank's slice of every leaf of a standard-layout tree (after
    :func:`tp_pack_params` for a ``tp`` model), as fresh contiguous
    tensors. Spec axes the mesh lacks replicate."""
    specs = filtered_pspecs(pspecs, mesh)
    return _zip(lambda t, s: leaf_slice(t, s, mesh, rank).contiguous().clone()
                if spec_axes(s) else t, params, specs)


def _gather_leaf(local: torch.Tensor, spec: PartitionSpec, full_shape):
    """Inside a bound mesh: the whole leaf from every rank's block (padded
    to whole chunks for the gather, trimmed after). A dimension split over
    several axes gathers over its minor axis first, so the blocks line up
    in the spec's row-major order whatever the mesh's axis order."""
    from .collectives import all_gather, axis_size
    out = local
    for dim, axes in reversed(sharded_dims(spec)):
        n = int(full_shape[dim])
        c = _chunk(n, axis_size(axes))
        have = out.shape[dim]
        if have < c:
            pad = list(out.shape)
            pad[dim] = c - have
            out = torch.cat([out, out.new_zeros(pad)], dim)
        for a in reversed(axes):
            out = all_gather(out.contiguous(), a, axis=dim)
        out = out.narrow(dim, 0, n)
    return out


def gather_params(local, mesh, pspecs, full_shapes):
    """Inside a bound mesh (a collective on every rank): the standard
    layout of a rank-local tree, ``full_shapes`` a tree of the standard
    shapes (tensors or anything with ``shape``). A ``tp`` tree still needs
    :func:`tp_unpack_params` after."""
    return _zip(lambda t, s, like: _gather_leaf(t, s, tuple(like.shape))
                if spec_axes(s) else t,
                local, filtered_pspecs(pspecs, mesh), full_shapes)


# ---------------------------------------------------------------------------
# Explicit trees: which split the forward computes on, which is storage
# ---------------------------------------------------------------------------


# the axes of the models' own tables (``param_pspecs()``) a forward can
# compute on: Megatron's column / row splits, and the expert banks
COMPUTE_AXES = ("tp", "ep")


def _leading(spec: PartitionSpec, axis: str) -> tuple:
    """The dimensions whose entry in ``spec`` starts with ``axis``."""
    return tuple(d for d, axes in sharded_dims(spec) if axes[0] == axis)


def _mismatch(path: str, what: str):
    return ValueError(f"param_sharding tree differs from the params at "
                      f"{path or '<root>'}: {what}")


def check_pspec_tree(pspecs, shapes, mesh) -> None:
    """Refuse an explicit PartitionSpec tree that cannot place ``shapes``
    (a tree of the params' shapes: tuples, tensors or anything with
    ``shape``) on ``mesh``, naming the first leaf at fault: a structure
    that differs from the params', a leaf that is not a
    :class:`PartitionSpec`, a spec longer than its leaf's rank or naming an
    axis twice, and a dimension that its live axes do not divide (JAX's
    ``device_put`` refuses that too; the port's ceil-sized blocks are for
    the derived fsdp specs only)."""
    live = {a: mesh.shape[a] for a in mesh.axis_names if mesh.shape[a] > 1}

    def walk(spec, shape, path):
        if isinstance(shape, dict):
            if not isinstance(spec, dict):
                raise _mismatch(path, f"the params have a dict of "
                                      f"{sorted(shape)}, the tree {spec!r}")
            for k in shape:
                at = f"{path}/{k}" if path else k
                if k not in spec:
                    raise _mismatch(at, "the params have it, the tree lacks "
                                        "it")
                walk(spec[k], shape[k], at)
            for k in spec:
                if k not in shape:
                    raise _mismatch(f"{path}/{k}" if path else k,
                                    "the tree has it, the params lack it")
            return
        dims = tuple(int(d) for d in getattr(shape, "shape", shape))
        if not isinstance(spec, PartitionSpec):
            raise _mismatch(path, f"a leaf of shape {dims} needs a "
                                  f"PartitionSpec, got {spec!r}")
        if len(spec) > len(dims):
            raise ValueError(
                f"param_sharding leaf {path}: {spec} has {len(spec)} "
                f"entries for a leaf of rank {len(dims)} (shape {dims})")
        axes = spec_axes(spec)
        if len(set(axes)) != len(axes):
            raise ValueError(f"param_sharding leaf {path}: {spec} names a "
                             f"mesh axis more than once")
        for d, entry in sharded_dims(_keep_axes(spec, live)):
            k = 1
            for a in entry:
                k *= live[a]
            if dims[d] % k:
                raise ValueError(
                    f"param_sharding leaf {path}: {spec} implies that the "
                    f"global size of its dimension {d} should be divisible "
                    f"by {k}, but it is equal to {dims[d]} (full shape: "
                    f"{dims})")

    walk(pspecs, shapes, "")


class PlacementPlan:
    """How a fit uses a spec tree, leaf by leaf; every rank computes the
    same plan from the same arguments.

    ``specs`` is the tree with the axes ``mesh`` lacks (or has at size 1)
    dropped. An axis of :data:`COMPUTE_AXES` is a *compute* axis when the
    model's own table (``param_pspecs()``) splits some leaf over it and the
    tree leads every dimension the table splits that way with it: the
    forward then computes on the local block (the Megatron forward over
    ``tp``, the local experts over ``ep``), and ``tp`` packs the qkv
    columns. Every other split of a leaf is *at rest*: stored sharded and
    gathered just in time into the compute-local leaf
    (:func:`gathered_params`). A tree that misses one of the table's
    splits over an axis computes on none of that axis: the plain forward
    runs on every rank of it, and each of the tree's splits over it is at
    rest. ``template`` is a tree of the standard shapes."""

    def __init__(self, model, mesh, pspecs, template):
        self.mesh = mesh
        self.specs = filtered_pspecs(pspecs, mesh)
        self.template = template
        self.names = [(ln, pn) for ln, layer in template.items()
                      for pn in layer]
        table = (filtered_pspecs(model.param_pspecs(), mesh)
                 if hasattr(model, "param_pspecs") else {})
        want = {n: table.get(n[0], {}).get(n[1], P()) for n in self.names}
        spec = {n: self.specs[n[0]][n[1]] for n in self.names}
        on = []
        for axis in COMPUTE_AXES:
            need = {n: _leading(want[n], axis) for n in self.names}
            need = {n: d for n, d in need.items() if d}
            if need and all(_leading(spec[n], axis) == d
                            for n, d in need.items()):
                on.append(axis)
        self.tp_axis = "tp" if "tp" in on else None
        self.ep_axis = "ep" if "ep" in on else None
        # per leaf: {dim: compute axis} and [(dim, at-rest axes)]
        self.compute: Dict[tuple, Dict[int, str]] = {}
        self.rest: Dict[tuple, List[tuple]] = {}
        for n in self.names:
            comp, rest = {}, []
            for d, axes in sharded_dims(spec[n]):
                if axes[0] in on and d in _leading(want[n], axes[0]):
                    comp[d] = axes[0]
                    axes = axes[1:]
                if axes:
                    rest.append((d, axes))
            self.compute[n], self.rest[n] = comp, rest

    def describe(self) -> dict:
        """The decision for ``last_mesh_stats``: the compute axes and how
        many leaves compute on a split, keep one at rest, both, or
        neither."""
        kinds = {"compute": 0, "at_rest": 0, "compute_and_at_rest": 0,
                 "replicated": 0}
        for n in self.names:
            c, r = bool(self.compute[n]), bool(self.rest[n])
            kinds["compute_and_at_rest" if c and r else "compute" if c
                  else "at_rest" if r else "replicated"] += 1
        return {"compute_axes": [a for a in (self.tp_axis, self.ep_axis)
                                 if a], "leaves": kinds}

    def gathers(self) -> bool:
        """Whether any leaf is stored at rest."""
        return any(self.rest[n] for n in self.names)

    def stages(self, n) -> List[tuple]:
        """Leaf ``n``'s just-in-time gather as single-axis stages ``(axis,
        dim, block, out)``: for each at-rest dimension, its axes from the
        minor one up, each gathering blocks of ``block`` entries along
        ``dim`` into ``out`` (the compute-local length after the last)."""
        shape = tuple(self.template[n[0]][n[1]].shape)
        comp, out = self.compute[n], []
        for d, axes in self.rest[n]:
            length = int(shape[d])
            if d in comp:
                a = comp[d]
                lo, hi = _bounds(length, self.mesh.shape[a],
                                 self.mesh.axis_index(a))
                length = hi - lo
            k_all = 1
            for a in axes:
                k_all *= self.mesh.shape[a]
            block = _chunk(length, k_all)
            for j, a in enumerate(reversed(axes)):
                k = self.mesh.shape[a]
                last = j == len(axes) - 1
                out.append((a, d, block, length if last else k * block))
                block *= k
        return out


# ---------------------------------------------------------------------------
# The just-in-time gather inside the loss
# ---------------------------------------------------------------------------


def _row(local: torch.Tensor, dim: int, c: int) -> torch.Tensor:
    """A rank's block as one flat row: ``dim`` moved first, padded to ``c``
    entries along it."""
    x = local.movedim(dim, 0)
    if x.shape[0] < c:
        x = torch.cat([x, x.new_zeros((c - x.shape[0],) + tuple(x.shape[1:]))])
    return x.reshape(1, -1)


def _moved(shape, dim: int) -> list:
    out = list(shape)
    out.insert(0, out.pop(dim))
    return out


class _AtRestGather(torch.autograd.Function):
    """One stage of the just-in-time gather, over one axis: every rank's
    blocks -> the leaves gathered along their dimension in the forward
    (one all-gather per dtype). In the backward, over a batch axis
    (``reduce``) the gathered gradients reduce-scatter back to the blocks,
    summed over the axis (one per dtype); over any other axis every rank
    holds the same whole gradient and takes its own block. ``metas`` are
    ``(dim, block, out)`` per leaf (:meth:`PlacementPlan.stages`). The
    mesh is kept in ``ctx``: autograd runs a CUDA backward on its own
    thread, where the bound mesh is not seen."""

    @staticmethod
    def forward(ctx, axis, reduce, metas, *locals_):
        from ..optimizers_sharded import _gather_rows
        from .mesh import bound_mesh
        mesh = bound_mesh()
        k = mesh.axis_size(axis)
        ctx.axis, ctx.reduce, ctx.k, ctx.metas = axis, reduce, k, metas
        ctx.mesh, ctx.index = mesh, mesh.axis_index(axis)
        ctx.local_shapes = [tuple(t.shape) for t in locals_]
        rows = [_row(t.detach(), dim, c)
                for t, (dim, c, _n) in zip(locals_, metas)]
        fulls = _gather_rows(rows, k, axis)
        out = []
        for f, shape, (dim, c, n) in zip(fulls, ctx.local_shapes, metas):
            x = f.reshape([k * c] + _moved(shape, dim)[1:])[:n]
            out.append(x.movedim(0, dim).contiguous())
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from ..optimizers_sharded import _scatter_shards
        k = ctx.k
        rows = []
        for g, (dim, c, _n) in zip(grads, ctx.metas):
            x = g.movedim(dim, 0)
            if x.shape[0] < k * c:
                x = torch.cat([x, x.new_zeros((k * c - x.shape[0],)
                                              + tuple(x.shape[1:]))])
            rows.append(x.reshape(k, -1))
        if ctx.reduce:
            with ctx.mesh.bind():
                shards = _scatter_shards(rows, k, ctx.axis, None)
        else:
            shards = [r[ctx.index] for r in rows]
        out = []
        for s, shape, (dim, c, _n) in zip(shards, ctx.local_shapes,
                                          ctx.metas):
            x = s.reshape([c] + _moved(shape, dim)[1:])[:shape[dim]]
            out.append(x.movedim(0, dim).contiguous())
        return (None, None, None) + tuple(out)


def gathered_params(local, plan: PlacementPlan, batch_axes=()):
    """Inside a bound mesh: the compute-local params from every rank's
    blocks (``local``, leaves requiring a gradient) under ``plan``: each
    at-rest split gathered, stage by stage, one collective per stage and
    axis; leaves with none pass as they are. Differentiating a loss of the
    result gives ``local`` gradients summed over the at-rest axes among
    ``batch_axes`` (reduce-scattered) and sliced over the others."""
    stages = {n: plan.stages(n) for n in plan.names}
    cur = {n: local[n[0]][n[1]] for n in plan.names}
    depth = max((len(s) for s in stages.values()), default=0)
    for t in range(depth):
        by_axis: Dict[str, list] = {}
        for n in plan.names:
            if t < len(stages[n]):
                by_axis.setdefault(stages[n][t][0], []).append(n)
        for axis in sorted(by_axis):     # one order on every rank
            names = by_axis[axis]
            outs = _AtRestGather.apply(
                axis, axis in batch_axes, [stages[n][t][1:] for n in names],
                *(cur[n] for n in names))
            for n, o in zip(names, (outs,) if torch.is_tensor(outs)
                            else outs):
                cur[n] = o
    return {ln: {pn: cur[(ln, pn)] for pn in layer}
            for ln, layer in local.items()}


# ---------------------------------------------------------------------------
# A fit's placement: standard <-> this rank's slices
# ---------------------------------------------------------------------------


_QKV = ("qkv_kernel", "qkv_bias")


class ParamPlacement:
    """A sharded-parameter fit's placement on one rank: the standard
    layout of the params and of the optimizer state on one side, this
    rank's slices on the other (a ``tp``-computing model's ``qkv`` columns
    packed, biases whole). :attr:`plan` is the spec tree's
    :class:`PlacementPlan`; ``template`` a tree of the standard shapes.
    :meth:`gather` and :meth:`gather_state` are collectives (inside the
    bound mesh)."""

    def __init__(self, model, mesh, pspecs, template):
        self.model, self.mesh = model, mesh
        self.plan = PlacementPlan(model, mesh, pspecs, template)
        self.specs = self.plan.specs
        self.template = template
        # the qkv columns pack only where tp is a compute split
        self.tp_axis = self.plan.tp_axis
        self.tp = mesh.shape[self.tp_axis] if self.tp_axis else 1
        # (layer, name) of each param leaf, in tree_leaves order
        self._names = self.plan.names
        self._state_owner = None

    # -- params --------------------------------------------------------------

    def place(self, params):
        """Standard params -> this rank's slices (fresh tensors)."""
        packed = tp_pack_params(self.model, params, self.tp,
                                divide_biases=False)
        return shard_params(packed, self.mesh, self.specs)

    def gather(self, local):
        """This rank's slices -> the standard params (a collective)."""
        full = gather_params(local, self.mesh, self.specs, self.template)
        return tp_unpack_params(self.model, full, self.tp)

    # -- optimizer state -----------------------------------------------------

    def _owners(self, optimizer) -> list:
        """For each leaf of ``optimizer.init(params)``, the index of the
        param it belongs to (a param-shaped leaf), or None: the state is
        initialised over meta params tagged by their index."""
        if self._state_owner is None:
            from ..optimizers_sharded import state_leaves
            tagged, i = {}, 0
            for ln, layer in self.template.items():
                tagged[ln] = {}
                for pn in layer:
                    tagged[ln][pn] = torch.empty((i + 1,), device="meta")
                    i += 1
            own = []
            for x in state_leaves(optimizer.init(tagged)):
                ok = (torch.is_tensor(x) and x.dim() == 1
                      and 1 <= x.shape[0] <= i)
                own.append(x.shape[0] - 1 if ok else None)
            self._state_owner = own
        return self._state_owner

    def _relayout(self, j: int, t, forward: bool):
        """A param-shaped state leaf of param ``j`` packed (``forward``) or
        unpacked: the qkv column permutation only."""
        ln, pn = self._names[j]
        if self.tp <= 1 or pn not in _QKV:
            return t
        perm = qkv_permutation(self.model.num_heads, self.model.head_dim,
                               self.tp)
        if not forward:
            perm = torch.argsort(perm)
        return t.index_select(t.dim() - 1, perm.to(t.device))

    def _spec(self, j: int):
        ln, pn = self._names[j]
        return self.specs[ln][pn]

    def place_state(self, optimizer, state):
        """A standard optimizer state -> this rank's slices."""
        from ..optimizers_sharded import _state_rebuild, state_leaves
        out = []
        for x, j in zip(state_leaves(state), self._owners(optimizer)):
            if j is None or not torch.is_tensor(x):
                out.append(x)
                continue
            t = self._relayout(j, x, forward=True)
            out.append(leaf_slice(t, self._spec(j), self.mesh)
                       .contiguous().clone())
        return _state_rebuild(state, iter(out))

    def gather_state(self, optimizer, state):
        """This rank's optimizer state -> the standard one (a
        collective)."""
        from ..optimizers_sharded import _state_rebuild, state_leaves
        ln_pn = self._names
        out = []
        for x, j in zip(state_leaves(state), self._owners(optimizer)):
            if j is None or not torch.is_tensor(x):
                out.append(x)
                continue
            sp = self._spec(j)
            if spec_axes(sp):
                ln, pn = ln_pn[j]
                x = _gather_leaf(x, sp, tuple(self.template[ln][pn].shape))
            out.append(self._relayout(j, x, forward=False))
        return _state_rebuild(state, iter(out))


# ---------------------------------------------------------------------------
# One-process serving: per-shard trees
# ---------------------------------------------------------------------------


class TPShards(list):
    """One block's parameters split over ``tp`` shards for serving in one
    process: entry ``s`` is shard ``s``'s tree on its device (the
    row-parallel biases whole: the sum of the shards' partials is followed
    by shard 0's bias, once). A block's K/V (prefill) and a decode engine's
    pools travel the same way, one entry per shard."""


def shards_of(x) -> Optional[TPShards]:
    """``x`` when it is a one-process tp split, else None."""
    return x if isinstance(x, TPShards) else None


def shard_of(x, s: int):
    """Shard ``s``'s entry of a :class:`TPShards` (a cache, a prefill's K
    or V), or ``x`` itself."""
    return x[s] if isinstance(x, TPShards) else x


class EPShards(list):
    """An MoE block's expert bank split over ``ep`` shards for serving in
    one process: entry ``e`` is shard ``e``'s ``{experts_fc1, experts_b1,
    experts_fc2, experts_b2}`` slice (experts ``[e * E/ep, (e + 1) *
    E/ep)``) on its device, held in the block's tree under ``"experts"``.
    The router and every other leaf stay whole; each shard serves its
    experts' slots and the outputs are summed (``models/moe.py``)."""


EXPERT_LEAVES = ("experts_fc1", "experts_b1", "experts_fc2", "experts_b2")


def serving_pspecs(model, mesh, tp_axis: Optional[str],
                   ep_axis: Optional[str] = None):
    """The specs a one-process serving path splits ``model`` by over
    ``tp_axis`` and ``ep_axis`` (its megatron and expert rules renamed to
    the axes), or None for a model that publishes none."""
    if not hasattr(model, "param_pspecs"):
        return None
    from ..sharding import ShardingConfig
    return derive_param_pspecs(model, mesh, ShardingConfig(tp_axis=tp_axis,
                                                           ep_axis=ep_axis))


def serving_tree(model, params, pspecs, tp_axis: Optional[str],
                 devices: Sequence, ep_axis: Optional[str] = None,
                 ep_devices: Sequence = ()):
    """A standard tree -> the one-process serving tree of one copy: the
    replicated non-block leaves (embeddings, final norm, heads) on
    ``devices[0]``; under ``tp`` each block a :class:`TPShards` of its
    ``len(devices)`` slices (qkv columns packed first, biases whole), shard
    ``t`` on ``devices[t]``; under ``ep`` (``len(ep_devices)`` shards) each
    MoE block's expert leaves an :class:`EPShards` under ``"experts"``,
    shard ``e`` on ``ep_devices[e]`` (the same object in every tp shard's
    tree)."""
    from .mesh import Mesh
    tp = len(devices) if tp_axis is not None else 1
    ep = len(ep_devices) if ep_axis is not None else 1
    packed = tp_pack_params(model, params, tp, divide_biases=False)
    axes = {}
    if tp > 1:
        axes[tp_axis] = tp
    if ep > 1:
        axes[ep_axis] = ep
    mesh = Mesh(axes or {"_": 1})
    specs = filtered_pspecs(pspecs, mesh)
    out = {}
    for name, sub in packed.items():
        sp = specs[name]
        experts = None
        if ep > 1 and any(ep_axis in spec_axes(sp[k]) for k in sub
                          if k in EXPERT_LEAVES):
            experts = EPShards(
                [{k: leaf_slice(sub[k], sp[k], mesh, index={ep_axis: e})
                  .to(ep_devices[e], copy=True).contiguous()
                  for k in EXPERT_LEAVES} for e in range(ep)])
            sub = {k: v for k, v in sub.items() if k not in EXPERT_LEAVES}
        if tp <= 1 or not any(tp_axis in spec_axes(sp[k]) for k in sub):
            part = {k: v.to(devices[0]) for k, v in sub.items()}
            if experts is not None:
                part["experts"] = experts
            out[name] = part
            continue
        shards = TPShards()
        for t in range(tp):
            part = {k: leaf_slice(v, sp[k], mesh, index={tp_axis: t}).to(
                devices[t], copy=True).contiguous() for k, v in sub.items()}
            if experts is not None:
                part["experts"] = experts
            shards.append(part)
        out[name] = shards
    return out


def shard_bytes(tree) -> int:
    """Device bytes of shard 0 of a serving tree (what one device holds:
    its tp slice of each block and expert shard 0 of each bank)."""
    total = 0
    for sub in tree.values():
        part = sub[0] if isinstance(sub, TPShards) else sub
        for v in part.values():
            if isinstance(v, EPShards):
                v = v[0]
                total += sum(t.numel() * t.element_size() for t in v.values())
            else:
                total += v.numel() * v.element_size()
    return total


__all__ = ["COMPUTE_AXES", "EPShards", "ParamPlacement", "PlacementPlan",
           "TPShards", "check_pspec_tree", "derive_param_pspecs",
           "filter_pspec", "filtered_pspecs", "fsdp_pspecs", "gather_params",
           "gathered_params", "leaf_slice", "make_sharded_train_step",
           "qkv_permutation",
           "rename_pspec_axes", "serving_pspecs", "serving_tree",
           "shard_bytes",
           "shard_of", "shard_params", "shards_of", "sharded_dims",
           "spec_axes",
           "tp_pack_params", "tp_unpack_params"]
