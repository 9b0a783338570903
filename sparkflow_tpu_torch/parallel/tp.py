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

There is no counterpart of JAX's ``make_sharded_train_step`` (a jitted
GSPMD step). Its counterpart is the per-rank step of
:func:`~sparkflow_tpu_torch.parallel.dp.make_param_sharded_train_step`: a
``tp`` model runs the Megatron forward (column-parallel qkv and fc1,
row-parallel o and fc2, one all-reduce after each,
:func:`~sparkflow_tpu_torch.parallel.collectives.tp_enter` /
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
    to whole chunks for the gather, trimmed after)."""
    from .collectives import all_gather, axis_size
    out = local
    for dim, axes in reversed(sharded_dims(spec)):
        k = axis_size(axes)
        n = int(full_shape[dim])
        c = _chunk(n, k)
        have = out.shape[dim]
        if have < c:
            pad = list(out.shape)
            pad[dim] = c - have
            out = torch.cat([out, out.new_zeros(pad)], dim)
        out = all_gather(out.contiguous(), axes, axis=dim)
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
# fsdp: the just-in-time gather inside the loss
# ---------------------------------------------------------------------------


def _row(local: torch.Tensor, dim: int, c: int) -> torch.Tensor:
    """A rank's block as one flat row: ``dim`` moved first, padded to ``c``
    entries along it."""
    x = local.movedim(dim, 0)
    if x.shape[0] < c:
        x = torch.cat([x, x.new_zeros((c - x.shape[0],) + tuple(x.shape[1:]))])
    return x.reshape(1, -1)


class _FsdpGather(torch.autograd.Function):
    """Every rank's block -> the whole leaves in the forward (one
    all-gather per dtype); the whole leaves' gradients reduce-scatter back
    to the blocks in the backward (one per dtype), summed over the axis.
    The mesh is kept in ``ctx``: autograd runs a CUDA backward on its own
    thread, where the bound mesh is not seen."""

    @staticmethod
    def forward(ctx, axis, k, metas, *locals_):
        from ..optimizers_sharded import _gather_rows
        from .mesh import bound_mesh
        ctx.axis, ctx.k, ctx.metas = axis, k, metas
        ctx.mesh = bound_mesh()
        ctx.local_sizes = [t.shape for t in locals_]
        rows = [_row(t.detach(), dim, _chunk(shape[dim], k))
                for t, (dim, shape) in zip(locals_, metas)]
        fulls = _gather_rows(rows, k, axis)
        out = []
        for f, (dim, shape) in zip(fulls, metas):
            c = _chunk(shape[dim], k)
            moved = list(shape)
            moved.insert(0, moved.pop(dim))
            x = f.reshape([k * c] + moved[1:])[:shape[dim]]
            out.append(x.movedim(0, dim).contiguous())
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from ..optimizers_sharded import _scatter_shards
        k = ctx.k
        rows = []
        for g, (dim, shape) in zip(grads, ctx.metas):
            c = _chunk(shape[dim], k)
            x = g.movedim(dim, 0)
            if x.shape[0] < k * c:
                x = torch.cat([x, x.new_zeros((k * c - x.shape[0],)
                                              + tuple(x.shape[1:]))])
            rows.append(x.reshape(k, -1))
        with ctx.mesh.bind():
            shards = _scatter_shards(rows, k, ctx.axis, None)
        out = []
        for s, (dim, shape), have in zip(shards, ctx.metas,
                                         ctx.local_sizes):
            c = _chunk(shape[dim], k)
            moved = list(shape)
            moved.insert(0, moved.pop(dim))
            x = s.reshape([c] + moved[1:])[:have[dim]]
            out.append(x.movedim(0, dim).contiguous())
        return (None, None, None) + tuple(out)


def gathered_params(local, pspecs, full_shapes, axis: str = "fsdp"):
    """Inside a bound mesh: the whole params from every rank's fsdp blocks
    (``local``, leaves requiring a gradient); replicated leaves pass as
    they are. Differentiating a loss of the result gives ``local``
    gradients that arrive reduce-scattered (summed over ``axis``)."""
    from .collectives import axis_size
    k = axis_size(axis)
    pairs: list = []

    def collect(t, s, like):
        dims = sharded_dims(s)
        if dims:
            if len(dims) != 1 or dims[0][1] != (axis,):
                raise ValueError(f"fsdp gathers one dimension over {axis!r}; "
                                 f"got spec {s}")
            pairs.append((t, dims[0][0], tuple(like.shape)))

    _zip(collect, local, pspecs, full_shapes)
    if not pairs:
        return local
    metas = [(d, shape) for _t, d, shape in pairs]
    fulls = _FsdpGather.apply(axis, k, metas,
                              *(t for t, _d, _s in pairs))
    it = iter((fulls,) if torch.is_tensor(fulls) else fulls)
    return _zip(lambda t, s: next(it) if sharded_dims(s) else t, local,
                pspecs)


# ---------------------------------------------------------------------------
# A fit's placement: standard <-> this rank's slices
# ---------------------------------------------------------------------------


_QKV = ("qkv_kernel", "qkv_bias")


class ParamPlacement:
    """A tp or fsdp fit's placement on one rank: the standard layout of the
    params and of the optimizer state on one side, this rank's slices on
    the other (a ``tp`` model's ``qkv`` columns packed, biases whole).
    ``template`` is a tree of the standard shapes. :meth:`gather` and
    :meth:`gather_state` are collectives (inside the bound mesh)."""

    def __init__(self, model, mesh, pspecs, template):
        self.model, self.mesh = model, mesh
        self.specs = filtered_pspecs(pspecs, mesh)
        self.template = template
        # the tp axis is the one the qkv columns shard over (an ep axis
        # shards whole experts and needs no relayout)
        axes = {a for layer in self.specs.values()
                for pn, sp in layer.items() if pn in _QKV
                for a in spec_axes(sp) if a != "fsdp"}
        self.tp_axis = next(iter(sorted(axes)), None)
        self.tp = mesh.shape[self.tp_axis] if self.tp_axis else 1
        # (layer, name) of each param leaf, in tree_leaves order
        self._names = [(ln, pn) for ln, layer in template.items()
                       for pn in layer]
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


__all__ = ["EPShards", "ParamPlacement", "TPShards", "derive_param_pspecs", "filter_pspec",
           "filtered_pspecs", "fsdp_pspecs", "gather_params",
           "gathered_params", "leaf_slice", "qkv_permutation",
           "rename_pspec_axes", "serving_pspecs", "serving_tree",
           "shard_bytes",
           "shard_of", "shard_params", "shards_of", "sharded_dims",
           "spec_axes",
           "tp_pack_params", "tp_unpack_params"]
