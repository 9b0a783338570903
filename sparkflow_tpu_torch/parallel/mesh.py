"""Named meshes over ranks — the port of the JAX package's
``parallel/mesh.py``.

A JAX mesh arranges devices on named axes; here a :class:`Mesh` arranges
the RANKS of a ``torch.distributed`` process group the same way (row-major,
as ``np.reshape`` lays devices out), and hands out one process group per
axis line. A rank is one process on one device: the card
``rank % torch.cuda.device_count()``, or the CPU. Several ranks may share a
card (their collectives then go through gloo, :mod:`.distributed`).

Outside an initialised process group a mesh is only a shape: a trainer
given one launches that many local ranks (:func:`.distributed.launch`).
Inside one, :meth:`Mesh.bind` makes it the mesh that named collectives
(:mod:`.collectives`) and ring attention resolve their axis names against —
the counterpart of running inside ``shard_map``.

Serving over a mesh (``Trainer.predict_fn(mesh=)``, ``core.make_predict_fn``,
``SparkAsyncDLModel(meshShape="dp=N")``, ``InferenceEngine(mesh=)``,
``DecodeEngine(mesh=)``) runs in ONE process — JAX's jitted program with
the batch sharded over the batch axes:

- the process holds one parameter copy per dp shard (:func:`dp_copies`:
  shard 0 the tree it was given);
- shard ``r`` lives on card ``r % device_count``, or on the CPU with
  ``device="cpu"`` — the rule the ranks use, so ``dp=2`` on a one-card
  machine puts both copies on that card (:func:`serving_grid`);
- a batch pads up to a dp multiple and splits into dp contiguous row
  blocks (block ``r`` is what ``P('dp')`` hands device ``r``);
- each block runs the unchanged forward on its copy, and the outputs are
  concatenated (:func:`dp_apply`) and trimmed.

Under ``tp`` (the config's ``tp_axis``, or a mesh axis named ``tp``) each
dp copy is split into ``tp`` shards (:func:`serving_layout`,
:class:`~.tp.TPShards`): shard ``t`` of copy ``d`` lives on card ``(d * tp +
t) % device_count`` (:func:`serving_grid`); every block half runs on each
shard and the partials are summed on the copy's shard 0. Under ``ep`` (the
config's ``ep_axis``, or a mesh axis named ``ep``) each MoE block's expert
bank is split into ``ep`` shards (:class:`~.tp.EPShards`): the copy spans
an ``ep x tp`` grid of cards, position ``(e, t)`` on card ``((d * ep + e)
* tp + t) % device_count``; the tp shards are row ``e = 0`` and expert
shard ``e`` sits at ``(e, 0)`` (:func:`expert_grid`), each serving its
experts' slots, the outputs summed in float32 on the copy's first card.
An ``fsdp`` or ``sp`` axis holds full copies: one process has no ranks to
shard against. JAX refuses a serving mesh that needs more devices than it
sees; the rank rule lets one card hold every copy. A ``pp`` axis is a
decode axis (``DecodeEngine`` puts stage ``s``'s shard ``t`` on card ``(s
* tp + t) % device_count``), refused for predict as in JAX
(:func:`serving_layout`).
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

_BOUND: ContextVar = ContextVar("sparkflow_torch_bound_mesh", default=None)


class Mesh:
    """Axis names and sizes over ``size`` ranks. ``shape`` is a dict (axis ->
    size, in axis order), as ``jax.sharding.Mesh.shape``."""

    def __init__(self, axes: Dict[str, int]):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other.shape == self.shape

    def __hash__(self) -> int:
        return hash(tuple(self.shape.items()))

    # -- coordinates --------------------------------------------------------

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank -> its index on every axis (row-major)."""
        idx = np.unravel_index(int(rank), tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def rank_of(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names),
            tuple(self.shape.values())))

    def _axes(self, axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not a mesh axis "
                                 f"{list(self.axis_names)}")
        # mesh order, so ('dp', 'dcn') and ('dcn', 'dp') share one group
        return tuple(a for a in self.axis_names if a in names)

    def axis_index(self, axes: Union[str, Sequence[str]],
                   rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) position along ``axes`` — several axes
        count row-major, as ``jax.lax.axis_index`` over a tuple does."""
        names = self._axes(axes)
        c = self.coords(_world_rank() if rank is None else rank)
        out = 0
        for a in names:
            out = out * self.shape[a] + c[a]
        return out

    def axis_size(self, axes: Union[str, Sequence[str]]) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)],
                           dtype=np.int64))

    def line(self, axes: Union[str, Sequence[str]],
             rank: Optional[int] = None) -> list:
        """The ranks that share every coordinate with ``rank`` except those
        on ``axes``, ordered by their index along ``axes``."""
        names = self._axes(axes)
        c = self.coords(_world_rank() if rank is None else rank)
        out = []
        for idx in np.ndindex(*(self.shape[a] for a in names)):
            cc = dict(c)
            cc.update(zip(names, (int(i) for i in idx)))
            out.append(self.rank_of(cc))
        return out

    # -- process groups -----------------------------------------------------

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of this rank's line along ``axes``. Every rank
        of the world must ask for the same axes at the same point (the
        groups are created collectively, in one order, the first time)."""
        import torch.distributed as dist
        names = self._axes(axes)
        if names not in self._groups:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"mesh axis group {names} needs an initialised "
                    f"torch.distributed process group (run inside "
                    f"distributed.launch / RankPool, or call "
                    f"distributed.initialize())")
            if dist.get_world_size() != self.size:
                raise ValueError(
                    f"mesh {self.shape} needs {self.size} ranks, the process "
                    f"group has {dist.get_world_size()}")
            if len(names) == len(self.axis_names):
                self._groups[names] = dist.group.WORLD
            else:
                mine = None
                seen = set()
                backend = dist.get_backend()
                for r in range(self.size):
                    ranks = tuple(self.line(names, r))
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    g = dist.new_group(list(ranks), backend=backend)
                    if dist.get_rank() in ranks:
                        mine = g
                self._groups[names] = mine
        return self._groups[names]

    @contextlib.contextmanager
    def bind(self):
        """Make this mesh the one named collectives resolve axis names
        against, for the body of a per-rank step (JAX: inside
        ``shard_map``)."""
        tok = _BOUND.set(self)
        try:
            yield self
        finally:
            _BOUND.reset(tok)


def _world_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def current_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :meth:`Mesh.bind`, or None."""
    return _BOUND.get()


def bound_mesh() -> Mesh:
    """The mesh of the enclosing :meth:`Mesh.bind`; raises outside one, as
    a collective over an unbound axis name does in JAX."""
    m = _BOUND.get()
    if m is None:
        raise RuntimeError("no mesh is bound: named collectives and ring "
                           "attention run inside `with mesh.bind():` on "
                           "every rank of an initialised process group")
    return m


def _default_count() -> int:
    """Ranks a mesh spans when none are named: the initialised process
    group's world, else one per local card, else one."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh({"dp": 2, "sp": 2})``.

    ``devices`` is how many ranks the mesh spans (an int, or a sequence of
    one entry per rank); by default the initialised process group's world
    size, else one rank per local card. Axis sizes must multiply to it;
    ``-1`` for one axis means "use the remaining ranks" (like a reshape
    wildcard). Outside a process group a mesh may ask for more ranks than
    there are cards: pass ``devices`` = its size, or build it from a dict
    through the trainer, and ranks then share cards."""
    n = (_default_count() if devices is None
         else int(devices) if isinstance(devices, (int, np.integer))
         else len(devices))
    sizes = list(axes.values())
    n_unknown = sum(1 for s in sizes if s == -1)
    if n_unknown > 1:
        raise ValueError("at most one axis size may be -1")
    if n_unknown == 1:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes = [s if s != -1 else n // known for s in sizes]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs "
                         f"{int(np.prod(sizes))} devices, have {n}")
    return Mesh(dict(zip(axes, sizes)))


def as_mesh(mesh) -> Optional[Mesh]:
    """``None``, a :class:`Mesh`, or a dict of axis sizes (no ``-1``: a dict
    names its own rank count) -> a Mesh."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, dict):
        if any(int(v) < 1 for v in mesh.values()):
            raise ValueError(f"mesh axis sizes must be >= 1, got {mesh}; use "
                             f"make_mesh for a -1 wildcard")
        return Mesh(mesh)
    raise TypeError(f"mesh must be a parallel.mesh.Mesh, a dict of axis "
                    f"sizes, or None; got {type(mesh).__name__}")


def default_mesh(axis: str = "dp", device=None) -> Optional[Mesh]:
    """All local cards on one data-parallel axis, for a fit on ``device``
    (``None`` or ``"cuda"``: every card); None on a single card or none (one
    process is faster than a one-rank mesh), and when ``device`` is the CPU
    or names one card, since the fit then uses no other."""
    import torch
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu" or device.index is not None:
            return None
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    return Mesh({axis: n})


def mesh_axis_size(mesh: Optional[Mesh], axis: str) -> int:
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


def parse_mesh_shape(s: str) -> Dict[str, int]:
    """Parse a mesh-shape string Param like ``"dp=2,tp=4"`` into axis sizes.

    Accepted axes: dp, tp, fsdp, sp, pp, ep. One axis may be ``-1``
    (remaining devices, like :func:`make_mesh`). This is the estimator-facing
    config format — a plain string so it persists like every reference Param.
    """
    known = ("dp", "tp", "fsdp", "sp", "pp", "ep")
    axes: Dict[str, int] = {}
    for part in (p.strip() for p in s.split(",") if p.strip()):
        if "=" not in part:
            raise ValueError(
                f"meshShape entry {part!r} is not 'axis=size' (got {s!r})")
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in known:
            raise ValueError(
                f"unknown mesh axis {name!r} in meshShape {s!r}; "
                f"known axes: {', '.join(known)}")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r} in {s!r}")
        try:
            axes[name] = int(size)
        except ValueError:
            raise ValueError(
                f"mesh axis size {size!r} for {name!r} is not an integer")
    if not axes:
        raise ValueError(f"empty meshShape {s!r}")
    return axes


# ---------------------------------------------------------------------------
# Serving over a dp mesh, in one process (the rule of the module docstring)
# ---------------------------------------------------------------------------


def serving_layout(mesh, sharding=None
                   ) -> Tuple[int, Optional[str], int, Optional[str], int]:
    """``(dp, tp_axis, tp, ep_axis, ep)`` of a one-process serving mesh (a
    :class:`Mesh` or a dict of sizes): ``dp`` the product of the sharding
    config's batch axes (the row blocks a batch splits into), ``tp_axis``
    the config's ``tp_axis`` or the mesh's ``tp`` axis (None without one)
    and ``tp`` its size, ``ep_axis`` / ``ep`` the same for ``ep``. An
    ``fsdp`` or ``sp`` axis holds full copies (JAX's predict program
    replicates the params over it); a ``pp`` axis is refused with the JAX
    predict engine's message (depth-sharded models serve through
    ``DecodeEngine``)."""
    from ..sharding import as_sharding_config
    mesh = as_mesh(mesh)
    cfg = as_sharding_config(sharding)
    axes = cfg.batch_axes(mesh)
    tp_axis = cfg.tp_axis or ("tp" if "tp" in mesh.axis_names else None)
    ep_axis = cfg.ep_axis or ("ep" if "ep" in mesh.axis_names else None)
    pp_axis = cfg.pp_axis or "pp"
    if mesh.shape.get(pp_axis, 1) > 1 and pp_axis not in axes:
        raise ValueError(
            "pp_axis is a decode-plane axis: the single-shot predict engine "
            "has no token cadence to hide pipeline bubbles behind. Serve "
            "depth-sharded models through DecodeEngine (serving/decode.py), "
            "or drop pp_axis from this engine's sharding config.")
    tp = mesh.shape[tp_axis] if tp_axis in mesh.shape else 1
    ep = mesh.shape[ep_axis] if ep_axis in mesh.shape else 1
    return ((mesh.axis_size(axes) if axes else 1), tp_axis, tp, ep_axis,
            ep)


def serving_grid(dp: int, tp: int, device, stage: int = 0,
                 ep: int = 1) -> list:
    """The devices of ``dp`` serving copies of ``tp`` shards each: shard
    ``t`` of copy ``d`` on card ``(d * ep * tp + t) % device_count``, or
    all on the CPU. A pipeline stage ``s`` of a ``pp x tp`` decode engine
    (one copy) puts its shard ``t`` on card ``(s * tp + t) % device_count``.
    Under ``ep`` (:func:`expert_grid`) copy ``d`` spans ``ep * tp`` cards
    and its tp shards are the first ``tp``."""
    import torch
    from .distributed import rank_device
    kind = torch.device(device).type
    return [[torch.device(rank_device(((d + stage) * ep) * tp + t, kind))
             for t in range(tp)] for d in range(dp)]


def expert_grid(dp: int, tp: int, ep: int, device) -> list:
    """The devices of each copy's ``ep`` expert shards: shard ``e`` of copy
    ``d`` on card ``((d * ep + e) * tp) % device_count`` — position ``(e,
    t=0)`` of the copy's ``ep x tp`` grid, whose row ``e = 0`` holds the tp
    shards (:func:`serving_grid`), so expert shard 0 shares tp shard 0's
    card — or all on the CPU."""
    import torch
    from .distributed import rank_device
    kind = torch.device(device).type
    return [[torch.device(rank_device((d * ep + e) * tp, kind))
             for e in range(ep)] for d in range(dp)]


def model_on(model, device):
    """``model`` computing on ``device``: itself when it is there, else a
    shallow copy whose ``device`` is ``device`` (the copies share the
    model's structure; parameters come with each call)."""
    import copy
    import torch
    device = torch.device(device)
    if model.device == device:
        return model
    other = copy.copy(model)
    other.device = device
    return other


def dp_copies(tree, devices) -> list:
    """The parameters of each serving shard (see :func:`serving_grid`):
    shard 0 serves ``tree`` itself, which lives on ``devices[0]`` (the
    model's device), shard ``r`` a copy on ``devices[r]``."""
    import torch
    from ..optimizers_sharded import state_map
    return [tree] + [state_map(lambda t: t.detach().to(d, copy=True)
                               if torch.is_tensor(t) else t, tree)
                     for d in devices[1:]]


def dp_apply(apply, copies, xs):
    """The serving rule's forward: ``xs`` (a tuple of inputs whose rows
    divide over the copies) split into one contiguous row block per copy,
    ``apply(r, copies[r], block)`` on each, and the outputs concatenated on
    copy 0's device."""
    import torch
    b = xs[0].shape[0] // len(copies)
    outs = [apply(r, p, tuple(a[r * b:(r + 1) * b] for a in xs))
            for r, p in enumerate(copies)]
    return torch.cat([o.to(outs[0].device) for o in outs])


__all__ = ["Mesh", "as_mesh", "bound_mesh", "current_mesh", "default_mesh",
           "dp_apply", "dp_copies", "expert_grid", "make_mesh", "mesh_axis_size",
           "model_on", "parse_mesh_shape", "serving_grid", "serving_layout"]
