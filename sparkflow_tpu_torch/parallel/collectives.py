"""Collectives over named mesh axes — the port of the JAX package's
``parallel/collectives.py``, on ``torch.distributed``.

Each function runs on every rank of the bound mesh (:meth:`.mesh.Mesh.bind`,
the counterpart of running inside ``shard_map``) and names its axes as the
JAX one does; the mapping is one to one:

- ``psum`` -> ``all_reduce``;
- ``psum_scatter`` (:func:`reduce_scatter`) -> ``reduce_scatter_tensor``;
- ``all_gather`` -> ``all_gather_into_tensor``;
- ``ppermute`` (:func:`ppermute_ring`) -> ``batch_isend_irecv`` to rank
  +/- ``shift`` along the axis; the pipeline's stage-to-stage hop
  (:func:`send_recv`) -> the same, to named neighbours only;
- ``all_to_all(x, axis, 0, 0, tiled=False)`` (:func:`all_to_all`) ->
  ``all_to_all_single``: slab ``j`` goes to peer ``j``; differentiable,
  its backward the reverse exchange (expert parallelism's token buffers);
- ``axis_index`` -> the rank's coordinate on the axis;
- :func:`psum_grad`, a ``psum`` inside autograd whose backward sums the
  cotangents over the axis, as JAX transposes ``psum`` inside a
  ``shard_map`` with ``check_vma=False`` (the routing statistics of
  :func:`~..ops.moe_dispatch.all_to_all_moe_ffn`);
- Megatron's *f* and *g* (:func:`tp_enter`, :func:`tp_exit`) — an
  all-reduce in the backward or the forward of a tensor-parallel block,
  inside autograd.

Backends (chosen up front by :mod:`.distributed`, never swapped here): with
NCCL the tensors go to the collective as they are. With gloo, a CUDA tensor
is staged through pinned host memory for EVERY op, by design — gloo takes
CPU tensors for all of them, so one rule holds whatever the torch version
refuses on the card — and gloo's reduce-scatter is an ``all_to_all`` of the
shards followed by a sum in rank order (the same bytes on the wire as a
reduce-scatter, a fixed summation order on every rank). :func:`stats`
counts the payload bytes of each op and the bytes staged through the host.

A tree is a dict of tensors (nested); a tree-level op flattens every leaf
of one dtype into one buffer and runs ONE collective for it — per element
the same arithmetic as JAX's leaf-by-leaf ``tree.map``, in fewer calls.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import bound_mesh

Axes = Union[str, Sequence[str]]

_LOCK = threading.Lock()
_STATS: Dict[str, int] = {}
# pinned staging buffers, one per (size, dtype, slot), kept for the life of
# the rank process: a training run stages the same sizes every step
_HOST: Dict[tuple, torch.Tensor] = {}


def reset_stats() -> None:
    """Zero the byte counters of :func:`stats`."""
    with _LOCK:
        _STATS.clear()


def stats() -> Dict[str, int]:
    """Payload bytes each op sent from this rank since
    :func:`reset_stats` (``all_reduce``, ``reduce_scatter``, ``all_gather``,
    ``all_to_all``, ``ppermute``, ``pp_hop``), their call counts (``calls``), and the bytes
    copied between a card and pinned host memory for gloo (``host_staged``,
    both directions)."""
    with _LOCK:
        return dict(_STATS)


def _add(key: str, nbytes: int) -> None:
    with _LOCK:
        _STATS[key] = _STATS.get(key, 0) + int(nbytes)


def _backend(group) -> str:
    return str(dist.get_backend(group)).lower()


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group goes through pinned host memory."""
    return t.is_cuda and _backend(group) == "gloo"


def _gloo(group) -> bool:
    return _backend(group) == "gloo"


def _host(like: torch.Tensor, slot: int = 0) -> torch.Tensor:
    """A pinned host buffer of ``like``'s size and dtype, kept across calls
    (one per ``slot``: an op that stages several tensors at once asks for
    several)."""
    key = (like.numel(), like.dtype, slot)
    buf = _HOST.get(key)
    if buf is None:
        buf = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
        _HOST[key] = buf
    return buf


def _to_host(t: torch.Tensor, slot: int = 0) -> torch.Tensor:
    h = _host(t, slot)
    h.copy_(t.reshape(-1))
    _add("host_staged", t.numel() * t.element_size())
    return h


def _from_host(h: torch.Tensor, device, shape) -> torch.Tensor:
    """A copy of the pinned ``h`` on ``device``, shaped ``shape`` (the
    pinned buffer is reused by the next op, so the copy waits for its
    transfer)."""
    _add("host_staged", h.numel() * h.element_size())
    return h.to(device).view(shape)


# ---------------------------------------------------------------------------
# Axis lookups (inside a bound mesh)
# ---------------------------------------------------------------------------


def axis_index(axis_name: Axes) -> int:
    """This rank's coordinate along ``axis_name`` (row-major over a tuple)."""
    return bound_mesh().axis_index(axis_name)


def axis_size(axis_name: Axes) -> int:
    return bound_mesh().axis_size(axis_name)


def _group(axis_name: Axes):
    mesh = bound_mesh()
    return mesh.group(axis_name), mesh.axis_size(axis_name)


def barrier() -> None:
    """Wait until every rank of the process group gets here (e.g. until
    rank 0's checkpoint is committed, before any rank may read it)."""
    group = dist.group.WORLD
    if _backend(group) == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# Flat-buffer primitives
# ---------------------------------------------------------------------------


def _all_reduce_(buf: torch.Tensor, group) -> torch.Tensor:
    """Sum ``buf`` over ``group`` in place (a flat contiguous tensor)."""
    _add("all_reduce", buf.numel() * buf.element_size())
    _add("calls", 1)
    if _staged(buf, group):
        h = _to_host(buf)
        dist.all_reduce(h, group=group)
        _add("host_staged", h.numel() * h.element_size())
        buf.copy_(h.view(buf.shape))
    else:
        dist.all_reduce(buf, group=group)
    return buf


def _reduce_scatter_flat(inp: torch.Tensor, n: int, group) -> torch.Tensor:
    """``inp`` [n * s] -> this rank's summed shard [s]."""
    _add("reduce_scatter", inp.numel() * inp.element_size())
    _add("calls", 1)
    if n == 1:
        return inp.clone()
    s = inp.numel() // n
    if not _gloo(group):
        out = torch.empty(s, dtype=inp.dtype, device=inp.device)
        dist.reduce_scatter_tensor(out, inp.contiguous(), group=group)
        return out
    src = _to_host(inp, 0) if inp.is_cuda else inp.contiguous()
    got = (_host(inp, 1) if inp.is_cuda
           else torch.empty_like(src))
    dist.all_to_all_single(got, src, group=group)
    parts = got.view(n, s)
    acc = _host(parts[0], 2) if inp.is_cuda else torch.empty_like(parts[0])
    acc.copy_(parts[0])
    for i in range(1, n):          # rank order, the same on every rank
        acc += parts[i]
    return _from_host(acc, inp.device, (s,)) if inp.is_cuda else acc


def _all_gather_flat(inp: torch.Tensor, n: int, group) -> torch.Tensor:
    """``inp`` [s] from every rank -> [n * s] in rank order along the
    axis."""
    _add("all_gather", inp.numel() * inp.element_size())
    _add("calls", 1)
    if n == 1:
        return inp.clone()
    if not _gloo(group):
        out = torch.empty(n * inp.numel(), dtype=inp.dtype, device=inp.device)
        dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
        return out
    src = _to_host(inp, 0) if inp.is_cuda else inp.contiguous()
    out = (_host(torch.empty(n * inp.numel(), dtype=inp.dtype, device="meta"),
                 1) if inp.is_cuda
           else torch.empty(n * inp.numel(), dtype=inp.dtype))
    dist.all_gather(list(out.view(n, -1).unbind(0)), src, group=group)
    return (_from_host(out, inp.device, (out.numel(),)) if inp.is_cuda
            else out)


# ---------------------------------------------------------------------------
# The named collectives
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def psum(tree, axis_name: Axes):
    """Sum a tree over mesh ``axis_name`` (one axis or a tuple); a new
    tree, the inputs untouched."""
    group, n = _group(axis_name)
    leaves = _leaves(tree)
    if n == 1:
        return _rebuild(tree, iter([x.clone() for x in leaves]))
    out: List[torch.Tensor] = [None] * len(leaves)
    by_dtype: Dict[tuple, List[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault((x.dtype, x.device), []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        _all_reduce_(flat, group)
        off = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = flat[off:off + k].view(leaves[i].shape)
            off += k
    return _rebuild(tree, iter(out))


def psum_mean(tree, axis_name: Axes):
    """All-reduce-mean a tree over a mesh axis (gradient averaging)."""
    n = axis_size(axis_name)
    s = psum(tree, axis_name)
    return _rebuild(s, iter([x / n for x in _leaves(s)]))


def all_gather(x: torch.Tensor, axis_name: Axes, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Concatenate (``tiled``) or stack every rank's ``x`` along ``axis``,
    in rank order along the mesh axis."""
    group, n = _group(axis_name)
    moved = x.movedim(axis, 0).contiguous()
    flat = _all_gather_flat(moved.reshape(-1), n, group)
    out = flat.view((n,) + tuple(moved.shape))
    if tiled:
        out = out.reshape((n * moved.shape[0],) + tuple(moved.shape[1:]))
        return out.movedim(0, axis)
    return out.movedim(0, axis)


def reduce_scatter(x: torch.Tensor, axis_name: Axes,
                   axis: int = 0) -> torch.Tensor:
    """Sum ``x`` over the axis and keep this rank's block of dimension
    ``axis`` (JAX ``psum_scatter(..., tiled=True)``)."""
    group, n = _group(axis_name)
    moved = x.movedim(axis, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"reduce_scatter: dimension {axis} of size "
                         f"{moved.shape[0]} does not divide over {n} ranks")
    shard = _reduce_scatter_flat(moved.reshape(-1), n, group)
    out = shard.view((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    return out.movedim(0, axis)


def _all_to_all_raw(x: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """``x`` [n, ...] over the axis's n ranks: slab ``j`` goes to peer
    ``j``, and slab ``j`` of the result came from peer ``j``."""
    group, n = _group(axis_name)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: dimension 0 of size {x.shape[0]} is "
                         f"not the axis size {n}")
    _add("all_to_all", x.numel() * x.element_size())
    _add("calls", 1)
    if n == 1:
        return x.clone()
    if _staged(x, group):
        src = _to_host(x, 24)
        got = _host(x, 25)
        dist.all_to_all_single(got, src, group=group)
        return _from_host(got, x.device, x.shape)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """JAX ``all_to_all(x, axis, 0, 0, tiled=False)`` inside autograd: its
    transpose is the same exchange of the cotangents. The mesh is kept in
    ``ctx`` for autograd's CUDA backward thread."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.mesh = axis, bound_mesh()
        return _all_to_all_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        with ctx.mesh.bind():
            return _all_to_all_raw(g.contiguous(), ctx.axis), None


def all_to_all(x: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """Exchange slabs over mesh ``axis_name``: ``x`` [n, ...] (n the axis
    size), slab ``j`` to the rank at index ``j`` on the axis; returns the n
    slabs received, slab ``j`` from index ``j``. Differentiable (the
    backward is the reverse exchange). Counted under ``"all_to_all"``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, axis_name)
    return _all_to_all_raw(x, axis_name)


class _PsumGrad(torch.autograd.Function):
    """``psum`` whose backward sums the cotangents over the axis too."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.mesh = axis, bound_mesh()
        return psum({"x": x.contiguous()}, axis)["x"]

    @staticmethod
    def backward(ctx, g):
        with ctx.mesh.bind():
            return psum({"g": g.contiguous()}, ctx.axis)["g"], None


def psum_grad(x: torch.Tensor, axis_name: Axes) -> torch.Tensor:
    """Sum ``x`` over mesh ``axis_name``, differentiably: the backward
    sums the cotangents over the axis — JAX's transpose of ``psum`` inside
    a ``shard_map`` with ``check_vma=False``. A statistic every rank then
    uses in a replicated loss (the MoE load-balance term) gets the
    gradient of the global loss this way; an identity backward would be
    off by the axis size."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _PsumGrad.apply(x, axis_name)
    return psum({"x": x}, axis_name)["x"]


def ppermute_ring(x, axis_name: Axes, shift: int = 1):
    """Rotate shards around the mesh-axis ring: rank i's ``x`` goes to rank
    ``(i + shift) % n`` of the axis (the building block of ring attention).
    ``x`` is a tensor or a tuple of tensors, all sent in one batch."""
    single = torch.is_tensor(x)
    xs: Tuple[torch.Tensor, ...] = (x,) if single else tuple(x)
    mesh = bound_mesh()
    group, n = _group(axis_name)
    if n == 1:
        return x
    line = mesh.line(axis_name)
    i = mesh.axis_index(axis_name)
    dst, src = line[(i + shift) % n], line[(i - shift) % n]
    staged = any(_staged(t, group) for t in xs)
    sends = [(_to_host(t, 2 * j) if staged else t.contiguous())
             for j, t in enumerate(xs)]
    recvs = [(_host(t, 2 * j + 1) if staged else torch.empty_like(s))
             for j, (t, s) in enumerate(zip(xs, sends))]
    ops = ([dist.P2POp(dist.isend, s, dst, group) for s in sends]
           + [dist.P2POp(dist.irecv, r, src, group) for r in recvs])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for s in sends:
        _add("ppermute", s.numel() * s.element_size())
    _add("calls", 1)
    out = tuple((_from_host(r, t.device, t.shape) if staged
                 else r.view(t.shape))
                for r, t in zip(recvs, xs))
    return out[0] if single else out


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[tuple, torch.dtype, int]],
              axis_name: Axes, device=None) -> List[torch.Tensor]:
    """Point-to-point hops along the mesh axis, in one
    ``batch_isend_irecv``: each ``(tensor, to)`` of ``sends`` goes to the
    rank at index ``to`` on this rank's line along ``axis_name``, and each
    ``(shape, dtype, frm)`` of ``recvs`` is received from index ``frm``
    (onto ``device``). The pipeline's stage-to-stage hop — an activation
    forward, a cotangent back; both ends must post the pair in the same
    exchange. Counted under ``"pp_hop"`` (bytes sent) and ``calls``."""
    mesh = bound_mesh()
    group, _n = _group(axis_name)
    line = mesh.line(axis_name)
    if not sends and not recvs:
        return []
    staged = (any(_staged(t, group) for t, _ in sends)
              or (bool(recvs) and device is not None
                  and torch.device(device).type == "cuda"
                  and _gloo(group)))
    # pinned slots of their own, apart from the other ops' (0-7)
    bufs = [(_to_host(t, 8 + j) if staged else t.contiguous())
            for j, (t, _to) in enumerate(sends)]
    outs = []
    for j, (shape, dtype, _frm) in enumerate(recvs):
        like = torch.empty(shape, dtype=dtype, device="meta")
        outs.append(_host(like, 16 + j) if staged
                    else torch.empty(shape, dtype=dtype, device=device))
    ops = ([dist.P2POp(dist.isend, b, line[to], group)
            for b, (_t, to) in zip(bufs, sends)]
           + [dist.P2POp(dist.irecv, o, line[frm], group)
              for o, (_s, _d, frm) in zip(outs, recvs)])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for b in bufs:
        _add("pp_hop", b.numel() * b.element_size())
    _add("calls", 1)
    return [(_from_host(o, device, shape) if staged else o.view(shape))
            for o, (shape, _d, _f) in zip(outs, recvs)]


# ---------------------------------------------------------------------------
# Megatron's two operators (tensor parallelism inside autograd)
# ---------------------------------------------------------------------------


class _TPEnter(torch.autograd.Function):
    """*f*: identity forward, gradient all-reduced over ``axis`` backward.
    The mesh is kept in ``ctx``: autograd runs a CUDA backward on its own
    thread, where the bound mesh is not seen."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.mesh = axis, bound_mesh()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with ctx.mesh.bind():
            return psum({"g": g.contiguous()}, ctx.axis)["g"], None


class _TPExit(torch.autograd.Function):
    """*g*: all-reduce over ``axis`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return psum({"x": x.contiguous()}, axis)["x"]

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enter(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's *f*, before a column-parallel projection (qkv, fc1): the
    replicated activation passes as it is, and its gradient — one rank's
    heads' part — is summed over ``axis_name`` in the backward."""
    return _TPEnter.apply(x, axis_name)


def tp_exit(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's *g*, after a row-parallel projection (o, fc2): the ranks'
    partial sums are summed over ``axis_name``; the gradient passes as it
    is (every rank holds the whole activation's gradient)."""
    return _TPExit.apply(x, axis_name)


def _flat_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Ravel + zero-pad so the size divides ``n`` (JAX's flat-pad rule)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def hierarchical_psum_mean(tree, ici_axis: str, dcn_axis: str):
    """Two-level gradient mean for multi-slice meshes (axes ordered
    [dcn, ici]): per leaf, reduce-scatter over the fast ``ici_axis``,
    all-reduce the 1/n_ici-sized shard over the slow ``dcn_axis``, then
    all-gather back over ICI, divided by the total rank count.

    The same sum as a flat all-reduce over both axes, in another order;
    the point is the wire layout — the DCN hop carries ``1/n_ici`` of the
    gradient bytes. Leaves whose size does not divide ``n_ici`` are
    flat-padded for the scatter and trimmed after the gather (the padding
    sums to zeros). All leaves of one dtype travel as one buffer: each leaf
    keeps its own ``[n_ici, s]`` layout, the buffer is their column
    concatenation, so every rank's shard is the concatenation of its
    per-leaf shards."""
    g_ici, n_ici = _group(ici_axis)
    total = n_ici * axis_size(dcn_axis)
    leaves = _leaves(tree)
    out: List[torch.Tensor] = [None] * len(leaves)
    by_dtype: Dict[tuple, List[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault((x.dtype, x.device), []).append(i)
    for idx in by_dtype.values():
        cols = [_flat_pad(leaves[i], n_ici).view(n_ici, -1) for i in idx]
        widths = [c.shape[1] for c in cols]
        block = torch.cat(cols, dim=1).reshape(-1)
        shard = _reduce_scatter_flat(block, n_ici, g_ici)
        shard = psum({"s": shard}, dcn_axis)["s"]   # 1/n_ici of the bytes
        full = _all_gather_flat(shard, n_ici, g_ici).view(n_ici, -1)
        off = 0
        for i, w in zip(idx, widths):
            x = leaves[i]
            part = full[:, off:off + w].reshape(-1)[:x.numel()]
            out[i] = (part / total).view(x.shape).to(x.dtype)
            off += w
    return _rebuild(tree, iter(out))


__all__ = ["all_gather", "all_to_all", "axis_index", "axis_size", "barrier",
           "hierarchical_psum_mean",
           "ppermute_ring", "psum", "psum_grad", "psum_mean", "reduce_scatter",
           "reset_stats", "send_recv", "stats", "tp_enter", "tp_exit"]
