"""One declarative sharding config for training — the port of the JAX
package's ``sharding.py``.

:class:`ShardingConfig` describes a mesh fit's placement:

- ``data_axis`` / ``dcn_axis`` — where batch rows go (the fast axis, plus an
  optional slow cross-host axis for the two-level reduction);
- ``zero_stage`` — how much of the update shards over ``data_axis`` (Xu et
  al., arXiv:2004.13336):

  ===== ==========================================================
  stage  sharded over dp
  ===== ==========================================================
  0      nothing (replicated update; grads all-reduce)
  1      optimizer state (grads reduce-scatter, updates all-gather)
  2      + gradient/update application (params all-gather, no
         full-size update temporaries)
  3      + parameters at rest (all-gathered just in time in the
         forward; the gather's backward IS the reduce-scatter)
  ===== ==========================================================

- ``offload_opt_state`` — a host mirror of a mesh fit's optimizer state,
  refreshed behind each step (the trainer's ``_OffloadMirror``);
- ``tp_axis`` — the tensor-parallel axis of the serving engines (the
  trainer's tp axis is the mesh's ``tp``, as in JAX);
- ``pp_axis`` — the pipeline axis of the decode engine (the trainer's pp
  axis is the mesh's ``pp``, as in JAX; the predict engine refuses an
  active one with JAX's message);
- ``ep_axis`` — the expert-parallel axis of the serving engines (each MoE
  bank split into ep shards in one process; the trainer's ep axis is the
  mesh's ``ep``, as in JAX);
- ``param_axes`` — per-parameter placement of a mesh fit: ``'auto'``
  defers to the trainer's ``param_sharding``, ``None`` replicates, or an
  explicit PartitionSpec pytree of the params' structure (JAX's rules and
  messages). Each leaf's split is either the one the Megatron / expert
  forward computes on or storage, gathered just in time
  (:class:`~.parallel.tp.PlacementPlan`); ZeRO stages decline on sharded
  params.

In the port a rank holds plain local tensors, so there are no
``NamedSharding`` objects: :meth:`ShardingConfig.data_spec` and
:func:`at_rest_leaf_spec` return a :class:`PartitionSpec` (a tuple of axis
names per dimension, as JAX's) that says the same thing, and
:func:`per_device_bytes` is the bytes of the local tensor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

ZERO_STAGES = (0, 1, 2, 3)


class PartitionSpec(tuple):
    """Per-dimension mesh axes (None: replicated), JAX's ``P``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        # pickle rebuilds a tuple subclass through ``__new__(cls, *args)``
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingConfig:
    """Declarative placement for a train program. Frozen; derive variants
    with :meth:`replace`."""

    data_axis: str = "dp"
    dcn_axis: Optional[str] = None
    zero_stage: int = 0
    param_axes: Any = "auto"
    offload_opt_state: bool = False
    tp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    pp_axis: Optional[str] = None

    def __post_init__(self):
        if self.zero_stage not in ZERO_STAGES:
            raise ValueError(
                f"zero_stage must be one of {ZERO_STAGES}, got "
                f"{self.zero_stage!r}")
        if not self.data_axis or not isinstance(self.data_axis, str):
            raise ValueError(
                f"data_axis must be a non-empty mesh axis name, got "
                f"{self.data_axis!r}")
        if self.dcn_axis == self.data_axis:
            raise ValueError(
                f"dcn_axis={self.dcn_axis!r} must name a DIFFERENT mesh axis "
                f"than data_axis={self.data_axis!r}: the two-level reduction "
                f"needs a distinct slow (cross-slice) axis next to the fast "
                f"ICI one")
        for field in ("tp_axis", "ep_axis", "pp_axis"):
            ax = getattr(self, field)
            if ax is None:
                continue
            if not ax or not isinstance(ax, str):
                raise ValueError(
                    f"{field} must be a non-empty mesh axis name or None, "
                    f"got {ax!r}")
            if ax in (self.data_axis, self.dcn_axis):
                raise ValueError(
                    f"{field}={ax!r} must name a DIFFERENT mesh axis than "
                    f"data_axis/dcn_axis: model-parallel shards live "
                    f"orthogonal to the batch axes")
        model_axes = [("tp_axis", self.tp_axis), ("ep_axis", self.ep_axis),
                      ("pp_axis", self.pp_axis)]
        for i, (fa, va) in enumerate(model_axes):
            for fb, vb in model_axes[i + 1:]:
                if va is not None and va == vb:
                    raise ValueError(
                        f"{fa} and {fb} both name {va!r}: tp/ep/pp need "
                        f"distinct mesh axes")

    # -- validation ---------------------------------------------------------

    def validate(self, mesh, require_data_axis: Optional[bool] = None
                 ) -> "ShardingConfig":
        """Check this config against a mesh (anything with ``axis_names``);
        raise an actionable ``ValueError`` instead of failing later on an
        unknown axis. ``require_data_axis`` defaults to ``zero_stage >= 1``
        (a dp-less mesh cannot host a sharded update)."""
        if require_data_axis is None:
            require_data_axis = self.zero_stage >= 1
        if require_data_axis and self.data_axis not in mesh.axis_names:
            raise ValueError(
                f"zero_stage={self.zero_stage} shards the update over mesh "
                f"axis {self.data_axis!r}, but the mesh only has axes "
                f"{list(mesh.axis_names)}. Build the mesh with a "
                f"'{self.data_axis}' axis (e.g. make_mesh({{'"
                f"{self.data_axis}': N}})) or set zero_stage=0.")
        if self.dcn_axis is not None and self.dcn_axis not in mesh.axis_names:
            raise ValueError(
                f"dcn_axis={self.dcn_axis!r} is not a mesh axis "
                f"{list(mesh.axis_names)}")
        for field in ("tp_axis", "ep_axis", "pp_axis"):
            ax = getattr(self, field)
            if ax is not None and ax not in mesh.axis_names:
                raise ValueError(
                    f"{field}={ax!r} is not a mesh axis "
                    f"{list(mesh.axis_names)}. Build the mesh with a "
                    f"'{ax}' axis (e.g. make_mesh({{'{ax}': N}})) or drop "
                    f"{field}.")
        return self

    # -- derived placements -------------------------------------------------

    def batch_axes(self, mesh=None) -> tuple:
        """The (slow, fast) batch axes this config shards rows over,
        restricted to axes the mesh actually has when one is given."""
        axes = ((self.dcn_axis,) if self.dcn_axis else ()) + (self.data_axis,)
        if mesh is not None:
            axes = tuple(a for a in axes if a in mesh.axis_names)
        return axes

    def data_spec(self, mesh) -> PartitionSpec:
        """Batch-row spec: over the batch axes present in the mesh,
        replicated when none are."""
        axes = self.batch_axes(mesh)
        if not axes:
            return P()
        return P(axes if len(axes) > 1 else axes[0])

    def dp_size(self, mesh) -> int:
        """Number of update shards = size of ``data_axis`` (1 on a dp-less
        mesh)."""
        return int(mesh.shape.get(self.data_axis, 1))

    def shards_opt_state(self) -> bool:
        return self.zero_stage >= 1

    def shards_params(self) -> bool:
        return self.zero_stage >= 3

    def tp_size(self, mesh) -> int:
        if self.tp_axis is None:
            return 1
        return int(mesh.shape.get(self.tp_axis, 1))

    def ep_size(self, mesh) -> int:
        if self.ep_axis is None:
            return 1
        return int(mesh.shape.get(self.ep_axis, 1))

    def pp_size(self, mesh) -> int:
        if self.pp_axis is None:
            return 1
        return int(mesh.shape.get(self.pp_axis, 1))

    def model_parallel(self) -> bool:
        """True when this config asks for any model-parallel axis."""
        return (self.tp_axis is not None or self.ep_axis is not None
                or self.pp_axis is not None)

    def describe(self) -> dict:
        """Flat dict for logs and ``stats()``."""
        return {
            "data_axis": self.data_axis,
            "dcn_axis": self.dcn_axis,
            "zero_stage": self.zero_stage,
            "param_axes": (self.param_axes if isinstance(
                self.param_axes, (str, type(None))) else "explicit"),
            "offload_opt_state": self.offload_opt_state,
            "tp_axis": self.tp_axis,
            "ep_axis": self.ep_axis,
            "pp_axis": self.pp_axis,
        }

    def replace(self, **kw) -> "ShardingConfig":
        return dataclasses.replace(self, **kw)

    # -- construction shims -------------------------------------------------

    @classmethod
    def from_legacy(cls, weight_update_sharding: str = "auto",
                    dp_axis: str = "dp", dcn_axis: Optional[str] = None,
                    param_axes: Any = "auto",
                    tp_axis: Optional[str] = None,
                    ep_axis: Optional[str] = None) -> "ShardingConfig":
        """Map the trainer's pre-config knobs onto a ShardingConfig.
        ``'auto'``/``'on'`` request stage 1 (the trainer's eligibility gate
        may still decline 'auto'); ``'off'`` is stage 0."""
        if weight_update_sharding not in ("auto", "on", "off"):
            raise ValueError(
                f"weight_update_sharding must be 'auto', 'on' or 'off', got "
                f"{weight_update_sharding!r}")
        stage = 0 if weight_update_sharding == "off" else 1
        return cls(data_axis=dp_axis, dcn_axis=dcn_axis, zero_stage=stage,
                   param_axes=param_axes, tp_axis=tp_axis, ep_axis=ep_axis)


def at_rest_leaf_spec(shape, axis: str, *, layout: str,
                      n_shards: Optional[int] = None,
                      min_size: int = 2 ** 16) -> PartitionSpec:
    """THE at-rest sharding decision, shared by every derivation path:
    "shard the leaf's shard-bearing dimension over ``axis``; replicate what
    cannot shard".

    - ``layout='gspmd'``: the shard-bearing dimension of a tensor kept in
      model shape is its LARGEST dim; leaves smaller than ``min_size``
      elements replicate.
    - ``layout='flat'`` (the ZeRO-1/3 flat layout): every leaf was already
      flattened/padded to ``[n_shards, ceil(size/n)]``, so dim 0 shards;
      leaves NOT in the flat layout (scalar counts) replicate.
    """
    if layout == "flat":
        if len(shape) >= 2 and (n_shards is None or shape[0] == n_shards):
            return P(axis)
        return P()
    if layout == "gspmd":
        size = 1
        for d in shape:
            size *= int(d)
        if shape and size >= min_size:
            big = max(range(len(shape)), key=lambda i: shape[i])
            spec = [None] * len(shape)
            spec[big] = axis
            return P(*spec)
        return P()
    raise ValueError(
        f"layout must be 'gspmd' or 'flat', got {layout!r}")


def per_device_bytes(a) -> int:
    """Bytes ONE rank holds for ``a``: a rank's tensors are local, so its
    size (a zero-layout shard counts its one row); numpy and scalars count
    their full size."""
    import numpy as np
    if hasattr(a, "element_size") and hasattr(a, "numel"):
        return int(a.numel() * a.element_size())
    return int(np.asarray(a).nbytes)


def as_sharding_config(value) -> ShardingConfig:
    """Coerce user input (None | ShardingConfig | dict) to a ShardingConfig."""
    if value is None:
        return ShardingConfig()
    if isinstance(value, ShardingConfig):
        return value
    if isinstance(value, dict):
        return ShardingConfig(**value)
    raise TypeError(
        f"sharding must be a ShardingConfig, a dict of its fields, or None; "
        f"got {type(value).__name__}")


__all__ = ["P", "PartitionSpec", "ShardingConfig", "ZERO_STAGES",
           "as_sharding_config", "at_rest_leaf_spec", "per_device_bytes"]
