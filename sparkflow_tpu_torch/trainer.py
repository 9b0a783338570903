"""Synchronous single-card trainer — the port of the JAX package's
``trainer.py`` (its one-device loop path, and ``fit_stream``).

The reference estimator's training knobs (``iters``, ``mini_batch_size``,
``mini_stochastic_iters``, ``shuffle_per_iter``, ``partition_shuffles``,
``verbose``, ``loss_callback``) keep their meaning:

- ``iters`` -> epochs over the dataset, repeated ``partition_shuffles``
  times;
- ``mini_batch_size`` -> the batch of one optimizer step (``_plan`` picks
  sweep, stochastic or full-batch mode exactly as the JAX trainer does);
- ``mini_stochastic_iters`` -> random batches per epoch, each drawn without
  replacement.

The dataset is staged on the card once, padded to whole batches with a 0/1
row mask; every step runs the model's loss forward and backward (the flash
attention kernels on the card) and the optimizer update in place.
:meth:`Trainer.fit_stream` trains from a row iterator instead, through the
native batch ring of :mod:`~sparkflow_tpu_torch.utils.data`.

Checkpoints and resume (``checkpoint_dir``, ``checkpoint_every``,
``resume_retries``): ``fit`` saves every ``checkpoint_every``-th epoch and
the last one (``fit_stream``: every ``checkpoint_every``-th step) through
:class:`~sparkflow_tpu_torch.checkpoint.CheckpointManager`, in the JAX
package's npz layout and state schema (``params``, ``opt_state``, ``epoch``,
``rng``, ``rng_impl``). A fit on a directory that holds a checkpoint resumes
from the newest valid one and lands on the weights an uninterrupted fit
reaches, bit for bit; an exception mid-fit restores the last checkpoint
and carries on, up to ``resume_retries`` times; SIGTERM (preemption) saves
and returns ``stop_reason="preempted"``. ``rng`` holds this package's
``torch.Generator`` states, ``rng_impl`` the stream's name, ``"torch"``:
parameters, optimizer state and epoch interchange with the JAX package's
checkpoints, its ``jax.random`` stream does not, so each trainer refuses
to continue the other's.

Live weight publication: ``publish_to`` (a
:class:`~.serving.weightstore.WeightStore` or its directory) receives the
weights after every ``publish_every``-th epoch and after the last, or once
at the end of the fit with ``publish_every=0`` (never after a NaN halt).
Publication is best-effort: a failure is logged and never fails training.

``strategy="elastic_dp"`` (tuned by ``elastic={"replicas", "max_staleness",
"dampening", "density_threshold", "lease_ttl_s"}``) trains through
:class:`~.parallel.elastic.ElasticDPEngine`: replica threads over
round-robin shards exchange gradients through the bounded-staleness
versioned store instead of a synchronous step; ``last_elastic_stats`` holds
its push and membership accounting. As in the JAX package it takes
single-input models only, ignores ``checkpoint_dir`` (with a warning) and
needs ``replicas >= 1``.

Synchronous mesh training (``mesh=``, a :class:`~.parallel.mesh.Mesh` or
a dict of axis sizes; ``sharding=`` / ``weight_update_sharding=``): each
rank of a ``torch.distributed`` process group runs the unchanged model on
its shard, collectives do the rest (:mod:`.parallel`). A mesh of ``dp``
(and ``sharding.dcn_axis``) axes trains through
:func:`~.parallel.dp.make_dp_train_step` at the resolved zero stage (0-3,
the JAX trainer's ``_resolve_zero_stage`` rule; stage 0 too, where JAX
uses its GSPMD program — the same semantics), in ``fit`` and in
``fit_stream``; a mesh with an ``sp`` axis trains a ``transformer_lm``
through :func:`~.parallel.sp.make_sp_train_step` (ring attention, ``fit``
only, as in JAX). Called inside an initialised process group the fit runs
in place on this rank (SPMD, JAX's multi-host form: a streaming fit then
reads the same stream on every rank and keeps its own rows of each global
batch); called outside one it launches ``mesh.size`` local ranks
(:mod:`.parallel.distributed`), each rebuilding the model from the spec
and the seed, and returns rank 0's result. A launched fit keeps a line to
its ranks: rank 0 posts each epoch's loss (each step's in ``fit_stream``)
and this process runs ``verbose``, the ``train/loss`` metric and
``loss_callback`` live, then sends every rank its verdict — go on, restore
the last checkpoint, or stop (a SIGTERM here, with a ``checkpoint_dir``)
— when it has a callback or a ``checkpoint_dir``. ``fit_stream`` reads the
stream here, assembles each global batch as one process would and sends
each rank its rows; a "stop" goes ahead of the batches still queued. A
launched rank waits for this process without a limit (a hung collective
still times out) and exits when this process is gone. ``last_mesh_stats`` holds every rank's accounting (the
backend, bytes moved, peak memory, kernel launches). Shuffles are the same
on every rank; dropout draws from a generator per rank and step seeded
from the fit's dropout stream folded with the rank's mesh indices.
Parameters come back, and checkpoints are written, in the standard layout
at every stage, so a fit saved at one stage resumes at any other.

In-fit resume on a mesh (``fit``, with a ``checkpoint_dir``, up to
``resume_retries`` times as on one card): a callback that raises here
sends every rank "restore", and every rank restores the last checkpoint
together; a rank that raises or dies stops its pool, and this process
starts new ranks that resume from the directory. In place (``torchrun``) a
failing rank fails the fit: restarting it is the launcher's job.

``sharding.offload_opt_state`` (on a mesh; inert without one, as in JAX):
the working optimizer state stays on the card and a mirror in pinned host
memory is refreshed behind each step (each epoch in ``fit``) on a side
stream; checkpoint saves, preemption and ``_last_opt_state`` read the
mirror. Losses are bit-equal to the same fit without it.

Sharded parameters (a mesh with a ``tp``, ``ep`` or ``fsdp`` axis, in
``fit`` and ``fit_stream``, launched or in place): the JAX trainer's
``_resolve_pspecs`` decides the specs (``param_sharding="auto"``: the
model's megatron rules on ``tp`` and its expert rules on ``ep``, fsdp's
ZeRO specs from ``param_specs()`` on ``fsdp``, refusing a ``tp`` / ``ep``
model without rules and ``tp`` / ``ep`` with ``fsdp``); each rank takes
its slices before the optimizer's init (:class:`~.parallel.tp.ParamPlacement`) and trains through
:func:`~.parallel.dp.make_param_sharded_train_step`. A tp rank runs the
Megatron forward and sees its dp group's rows; an fsdp rank splits its dp
group's rows again (zero-mask padded), so the batch rule stays JAX's. The
ZeRO stage declines on sharded params (an explicit ``zero_stage`` raises
JAX's message). Checkpoints, ``TrainResult.params``, ``weights_list()``
and ``publish_to`` always carry the standard, gathered, unpacked layout, so
a tp or fsdp checkpoint resumes a dp fit, a one-card fit and a JAX fit, and
the other way round.

Explicit placement (``param_sharding=<PartitionSpec pytree>`` or
``sharding=ShardingConfig(param_axes=<pytree>)``, on any mesh of the
default strategy: dp, tp, fsdp, ep and their mixes, ``tp`` with ``fsdp``
included, which the auto derivation refuses): the tree is checked against
the params at fit time (structure, rank, divisibility, each refusal naming
the leaf) and placed as it is; a pp / sp mesh refuses an explicit
``param_sharding`` tree with JAX's message. Each leaf's split is either a
compute split (its ``tp`` / ``ep`` split where it matches the model's own
table, so the Megatron / expert forward runs on the local block) or at
rest, gathered just in time (:class:`~.parallel.tp.PlacementPlan`;
``last_mesh_stats["placement"]`` names the decision). A tree that misses
one of the table's ``tp`` splits runs the plain forward on every rank.

Pipeline parallelism (a mesh with a ``pp`` axis, composed with ``dp``
only, in ``fit``, launched or in place; ``fit_stream`` refuses it, as in
JAX): the JAX trainer's rules and messages decide the task (``lm``
without labels, ``classifier`` with one input) and the microbatches
(``pp_microbatches``, default the first of 8, 4, 2, 1 that divides a dp
replica's rows); the dataset is trimmed to whole batches. Each rank keeps
its stage's blocks and the shared leaves (:class:`~.parallel.pp.
StagePlacement`) before the optimizer's init and trains through
:func:`~.parallel.pp.make_pp_train_step` under ``pp_schedule``
(``"gpipe"``, ``"1f1b"`` or ``"sequential"``). Checkpoints hold the
stacked stage layout, as the JAX pp fit writes them; a fit reading a
checkpoint of the other layout (a pp fit's on one card, one card's in a pp
fit) relays it out. ``TrainResult.params``, ``weights_list()``,
``publish_to`` and ``ema_weights()`` carry the standard layout.

On an ``ep`` axis (JAX's GSPMD form: rows shard over ``dp`` only) an MoE
rank holds ``E/ep`` experts of each bank and serves its experts' slots,
the outputs summed over ``ep``; a dense model trains replicated over the
axis, as JAX's spec filter makes it. ``ep`` composes with ``dp`` and
``tp``; checkpoints and published weights hold whole banks.

``debug_recompiles=True`` runs each fit under
:func:`~.analysis.runtime_guards.track_recompiles`: PyTorch traces nothing,
so what it counts is each new argument signature of the epoch and train
step (``recompile_report`` / ``recompile_findings``, JAX's report).
``graph`` is a registry spec, an ``nn`` graph-DSL spec, a TF1
``MetaGraphDef`` JSON (the reference's wire format), a
:class:`~.graphdef.GraphDef` or a model object. ``jax.random`` streams
cannot be repeated in PyTorch: shuffles and dropout come from
``torch.Generator`` s seeded from ``seed``, so a fit repeats within the
port, not across the two packages.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .convert import params_to_list
from .core import (make_epoch_fn, make_loss_fn, make_predict_fn,
                   make_train_step, pad_to_batches)
from .graphdef import GraphDef, GraphModel
from .models.base import RegistryModel
from .tf1_compat import TF1GraphModel
from .optimizers import (GradientTransformation, build_optimizer,
                         extract_ema_params, tree_leaves, tree_map)
from .optimizers_sharded import state_map
from .sharding import ShardingConfig, as_sharding_config
from .utils.metrics import default_metrics
from .utils.preempt import NullGuard, PreemptionGuard

logger = logging.getLogger("sparkflow_tpu_torch")

# the name of this package's random stream in a checkpoint's ``rng_impl``
# (the JAX package writes its jax.random implementation's, e.g. "threefry")
RNG_IMPL = "torch"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _launch_counts() -> Dict[str, int]:
    from .ops import launch_counts
    return launch_counts()


def _draw_seed(gen: torch.Generator) -> int:
    """A step's dropout seed from the fit's dropout stream (the same draw
    on every rank of a mesh)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))


class _EpochTimer:
    """Per-epoch milliseconds of a mesh fit: CUDA events on the card (read
    once at the end), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self._spans: list = []

    def start(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans.append([ev, None])
        else:
            self._spans.append([time.perf_counter(), None])

    def stop(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans[-1][1] = ev
        else:
            self._spans[-1][1] = time.perf_counter()

    def ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self._spans]
        return [(b - a) * 1e3 for a, b in self._spans]


class _RestoreVerdict(Exception):
    """A launched rank's order from its caller: restore the last checkpoint
    and carry on (the caller's callback raised)."""


def _rank_trainer(recipe: Dict[str, Any]) -> "Trainer":
    """The trainer a launched rank rebuilds from ``recipe``, on this rank's
    device, holding the line to its caller."""
    import torch.distributed as dist
    from .parallel.distributed import channel, rank_device
    kw = dict(recipe)
    device = rank_device(dist.get_rank(), "cpu" if kw.pop("device_kind")
                         == "cpu" else "cuda")
    verdicts = kw.pop("verdicts")
    tr = Trainer(kw.pop("graph"), kw.pop("input_name"), kw.pop("label_name"),
                 device=device, **kw)
    tr._channel = channel()
    tr._await_verdict = verdicts
    return tr


def _rank_result(tr: "Trainer", result: "TrainResult") -> Dict[str, Any]:
    """What a launched rank returns: its accounting; rank 0 also the
    standard-layout params (numpy), the EMA weights and its step stats."""
    import torch.distributed as dist
    out = {"mesh_stats": tr.last_mesh_stats, "losses": result.losses,
           "epochs": tr._epoch_keys, "resumed_from": tr._resumed_from,
           "examples_per_sec": result.examples_per_sec,
           "stop_reason": result.stop_reason, "zero_stage": tr._zero_stage}
    if dist.get_rank() == 0:
        to_np = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
        ema = tr.ema_weights() if tr._zero_stage == 0 else None
        out.update(params=tree_map(to_np, result.params),
                   ema=tree_map(to_np, ema) if ema is not None else None,
                   step_stats=tr.last_step_stats)
    return out


def _mesh_fit_rank(recipe: Dict[str, Any], features, labels, init_params,
                   trace: bool) -> Dict[str, Any]:
    """One launched rank of a mesh fit: rebuild the trainer from
    ``recipe`` on this rank's device and fit in place."""
    tr = _rank_trainer(recipe)
    return _rank_result(tr, tr.fit(features, labels, init_params,
                                   trace_spans=trace))


def _mesh_stream_rank(recipe: Dict[str, Any], init_params,
                      batch: int) -> Dict[str, Any]:
    """One launched rank of a streaming mesh fit: this rank's rows of each
    global batch come from the caller until it sends the end. A "stop"
    goes ahead of the batches queued before it."""
    tr = _rank_trainer(recipe)
    chan = tr._channel

    def events():
        while True:
            msg = chan.take("stop") or chan.recv()
            if msg[0] == "end":
                return
            yield msg

    with tr.mesh.bind():
        result = tr._stream_loop(events(), init_params, batch, rows=None)
    return _rank_result(tr, result)


class _OffloadMirror:
    """``offload_opt_state``: the optimizer state's home is host memory,
    refreshed behind the compute. The working state stays on the card;
    after each step (each epoch in ``fit``) an event is recorded on the
    compute stream and ``non_blocking`` copies of every state leaf into
    pinned host buffers are enqueued on a side stream behind it, so the
    transfer runs under the next step. Readers (checkpoint saves,
    preemption, the fit's ``_last_opt_state``) wait on the copy's event and
    read the mirror. No value goes through the host on its way to the next
    step, so the numerics are those of the fit without it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.done = None
        self.host = None
        self._bufs: Dict[int, torch.Tensor] = {}

    def refresh(self, opt_state) -> None:
        if self.cuda:
            step_done = torch.cuda.Event()
            step_done.record()
            self.stream.wait_event(step_done)
        slot = itertools.count()

        def copy(leaf):
            if not torch.is_tensor(leaf):
                return leaf
            k = next(slot)
            buf = self._bufs.get(k)
            if (buf is None or buf.shape != leaf.shape
                    or buf.dtype != leaf.dtype):
                buf = torch.empty(leaf.shape, dtype=leaf.dtype,
                                  pin_memory=self.cuda)
                self._bufs[k] = buf
            if self.cuda:
                # the allocator keeps the leaf's block until the copy ends
                leaf.record_stream(self.stream)
            buf.copy_(leaf, non_blocking=self.cuda)
            return buf

        with (torch.cuda.stream(self.stream) if self.cuda
              else contextlib.nullcontext()):
            self.host = state_map(copy, opt_state)
        if self.cuda:
            self.done = torch.cuda.Event()
            self.done.record(self.stream)

    def read(self):
        """The host mirror once its copies have landed (None before the
        first refresh)."""
        if self.done is not None:
            self.done.synchronize()
        return self.host

    def wrap(self, fn: Callable) -> Callable:
        """``fn(params, opt_state, ...) -> (params, opt_state, out)`` with a
        refresh enqueued after each call."""

        def refreshed(params, opt_state, *rest):
            params, opt_state, out = fn(params, opt_state, *rest)
            self.refresh(opt_state)
            return params, opt_state, out

        return refreshed


class _FitState:
    """What a fit carries between steps: params and optimizer state in this
    rank's layout (the ZeRO rows on a mesh), the ``(shuffle, dropout)``
    generators, the checkpoint manager and, with ``offload_opt_state``, the
    host mirror. Saves and restores go through the standard layout, so a
    checkpoint restores at any stage. Every rank of a mesh calls
    :meth:`save` and :meth:`restore_latest` at the same points: both run
    collectives."""

    def __init__(self, tr: "Trainer", init_params, strategy: str):
        self.tr = tr
        mesh = tr.mesh
        params = tr._initial_params(init_params)
        tr._placement = None
        tr._stages = None
        if strategy == "pp":
            # this rank's stage BEFORE the optimizer's init, so its state
            # tracks the stage layout
            from .parallel.pp import StagePlacement, split_stage_params
            tr._stages = StagePlacement(tr.model, mesh, params)
            with torch.no_grad():
                params = tr._params_from_ckpt(split_stage_params(
                    tr.model, tree_map(lambda p: p.detach(), params),
                    mesh.shape["pp"]))
            for p in tree_leaves(tr.model.params()):
                p.data = p.data.new_empty(0)
        if tr._pspecs is not None:
            # sharded params: this rank's slices BEFORE the optimizer's
            # init, so its state inherits the placement
            from .parallel.tp import ParamPlacement
            template = tree_map(lambda p: torch.empty(
                p.shape, dtype=p.dtype, device="meta"), params)
            tr._placement = ParamPlacement(tr.model, mesh, tr._pspecs,
                                           template)
            params = tr._params_from_ckpt(params)
        tr._zero_stage = tr._resolve_zero_stage(strategy, params)
        tr._zero1_active = tr._zero_stage >= 1
        tr._zero3_template = None
        with torch.no_grad():
            if tr._zero1_active:
                # the global zero state (init over the flat [dp, s] view),
                # of which this rank keeps its row
                from .optimizers_sharded import (place_zero1_state,
                                                 sharded_update)
                dp_n, dp_ax = tr._dp_size(), tr._data_axis()
                opt_state = place_zero1_state(
                    sharded_update(tr.optimizer, dp_n, dp_ax).init(params),
                    mesh, dp_n, dp_ax)
            else:
                opt_state = tr.optimizer.init(params)
            if tr._zero_stage >= 3:
                tr._zero3_template = tree_map(
                    lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
                params = tr._params_from_ckpt(params)
        self.params, self.opt_state = params, opt_state
        self.gens = tr._generators()
        tr._offload_active = bool(tr.sharding is not None
                                  and tr.sharding.offload_opt_state
                                  and mesh is not None)
        self.mirror = (_OffloadMirror(tr.device) if tr._offload_active
                       else None)
        self.start = 0
        self.mgr, self.like, restored = (
            tr._open_checkpoints(*self.std(), self.gens)
            if tr.checkpoint_dir else (None, None, None))
        if restored is not None:
            self._install(restored)

    def _opt_at_rest(self):
        """The optimizer state a reader takes: the host mirror under
        offload when the standard-layout gather can run on host tensors (no
        gather, or gloo), else the working state."""
        if self.mirror is not None:
            from .parallel.distributed import current_backend
            host = self.mirror.read()
            gathers = (self.tr._zero1_active or self.tr._placement is not None
                       or self.tr._stages is not None)
            if host is not None and (not gathers
                                     or current_backend() == "gloo"):
                return host
        return self.opt_state

    def std(self):
        """``(params, opt_state)`` in the standard layout (a collective on a
        zero mesh)."""
        std_p = self.tr._params_to_ckpt(self.params)
        return std_p, self.tr._opt_to_ckpt(std_p, self._opt_at_rest())

    def save(self, at: int) -> None:
        std_p, std_o = self.std()
        if self.tr._chief():
            self.mgr.save(at, self.tr._ckpt_state(std_p, std_o, at,
                                                  self.gens))
        if self.tr.mesh is not None:
            # no rank reads the directory before the save is committed
            from .parallel.collectives import barrier
            barrier()

    def _install(self, restored) -> None:
        params, opt_state, self.start = restored
        if self.tr.mesh is not None:
            with torch.no_grad():
                opt_state = self.tr._opt_from_ckpt(params, opt_state)
                params = self.tr._params_from_ckpt(params)
        self.params, self.opt_state = params, opt_state

    def restore_latest(self) -> Optional[int]:
        """Restore the newest valid checkpoint (every rank together, after
        a barrier: rank 0 wrote it) and return its epoch; None without
        one."""
        if self.tr.mesh is not None and _in_group():
            from .parallel.collectives import barrier
            barrier()
        state = self.mgr.restore(like=self.like)
        if state is None:
            return None
        self._install(self.tr._restore(state, self.like, self.gens))
        return self.start

    def finish(self):
        """``(params, opt_state)`` to keep after the fit: params in the
        standard layout (installed on the model), the optimizer state read
        from the host mirror under offload."""
        tr = self.tr
        params = self.params
        host = self.mirror.read() if self.mirror is not None else None
        opt_state = self.opt_state if host is None else host
        if tr._stages is not None:
            # pp: the standard layout of both (collectives)
            from .parallel.pp import merge_stage_state
            stacked = tr._opt_to_ckpt(None, self._opt_at_rest())
            opt_state = merge_stage_state(tr.optimizer, tr.model,
                                          tr._stages.ckpt_template, stacked)
            params = tr.model.load_params(
                tree_map(lambda p: p.clone(), tr._std_params(params)),
                trainable=True)
        elif tr._placement is not None:
            # tp / fsdp: the standard layout of both (collectives)
            params = tr._params_to_ckpt(params)
            opt_state = tr._opt_to_ckpt(params, self._opt_at_rest())
            params = tr.model.load_params(params, trainable=True)
        elif tr._zero_stage >= 3:
            params = tr.model.load_params(tr._params_to_ckpt(params),
                                          trainable=True)
        return tree_map(lambda p: p.detach(), params), opt_state


def _ckpt_stages(mgr) -> Optional[int]:
    """The layout of the newest checkpoint under ``mgr``: its number of
    pipeline stages (a pp fit's stacked layout), 0 for the standard layout,
    None when there is none or its manifest lists no leaf paths (a JAX npz
    checkpoint, read in this fit's own layout)."""
    step = mgr.latest_step()
    paths = (mgr._manifest(step) or {}).get("leaves") if step is not None \
        else None
    if not paths:
        return None
    for i, p in enumerate(paths):
        if list(p[:2]) == ["params", "stages"]:
            from .checkpoint import STATE_NAME
            with np.load(os.path.join(mgr._step_dir(step), STATE_NAME)) as z:
                return int(z[f"l_{i}"].shape[0])
    return 0


def _host_tree(tree):
    """A params tree as numpy, for a launched rank (None stays None)."""
    if tree is None:
        return None
    return tree_map(lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)
                               else np.asarray(a)), tree)


def _state_to_ckpt(leaf):
    """An optimizer-state leaf as the checkpoint stores it: Python counters
    as int32 / float32 scalars, as optax holds them."""
    if isinstance(leaf, int):
        return np.int32(leaf)
    if isinstance(leaf, float):
        return np.float32(leaf)
    return leaf


def _tree_zip(fn: Callable, like, saved):
    """``fn(like_leaf, saved_leaf)`` over two trees of ``like``'s structure
    (dicts, tuples, named tuples, lists, None)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _tree_zip(fn, like[k], saved[k]) for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_tree_zip(fn, a, b) for a, b in zip(like, saved)]
        return (type(like)(*vals) if hasattr(like, "_fields")
                else type(like)(vals))
    return fn(like, saved)


def _state_from_ckpt(like, saved):
    """Inverse of :func:`_state_to_ckpt` on ``like``'s leaf: a tensor of its
    dtype and device, or a Python scalar of its type."""
    if torch.is_tensor(like):
        return torch.as_tensor(np.asarray(saved)).to(like.device, like.dtype,
                                                     copy=True)
    if isinstance(like, int):
        return int(saved)
    if isinstance(like, float):
        return float(saved)
    return saved


class TrainResult:
    """Outcome of a fit: final params + per-epoch mean losses.

    ``stop_reason`` says how the fit ended — ``'completed'`` (ran every
    planned epoch), ``'preempted'`` (SIGTERM checkpoint-and-return; resuming
    on the same checkpoint_dir finishes the run), or ``'nan'``
    (``halt_on_nan`` tripped). ``resilience.run_resilient_fit`` keys its
    restart decision off this field."""

    __slots__ = ("params", "losses", "examples_per_sec", "wall_time_s",
                 "stop_reason")

    def __init__(self, params, losses, examples_per_sec, wall_time_s,
                 stop_reason: str = "completed"):
        self.params = params
        self.losses = losses
        self.examples_per_sec = examples_per_sec
        self.wall_time_s = wall_time_s
        self.stop_reason = stop_reason

    @property
    def completed(self) -> bool:
        return self.stop_reason == "completed"


class Trainer:
    """Synchronous trainer on one CUDA card (or the CPU with
    ``device="cpu"``). ``graph`` is a spec JSON string (registry or ``nn``
    graph DSL), a :class:`GraphDef`, or a model object (registry model or
    :class:`GraphModel`); the other parameters mirror the JAX ``Trainer``
    (see the module docstring for those not ported)."""

    def __init__(self,
                 graph: Union[str, GraphDef, GraphModel, RegistryModel],
                 input_name,
                 label_name: Optional[str] = None,
                 optimizer: Union[str, GradientTransformation] = "adam",
                 learning_rate: float = 0.01,
                 optimizer_options: Optional[Dict[str, Any]] = None,
                 iters: int = 1000,
                 mini_batch_size: int = 128,
                 mini_stochastic_iters: int = -1,
                 shuffle_per_iter: bool = True,
                 partition_shuffles: int = 1,
                 verbose: int = 0,
                 loss_callback: Optional[Callable] = None,
                 dropout_name: Optional[str] = None,
                 acquire_lock: bool = False,  # accepted for API parity; no-op
                 mesh=None,
                 seed: int = 0,
                 compute_dtype=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 publish_to=None,
                 publish_every: int = 0,
                 resume_retries: int = 2,
                 straggler_factor: Optional[float] = None,
                 straggler_callback: Optional[Callable] = None,
                 metrics=None,
                 param_sharding: Union[str, None, dict] = "auto",
                 rng_impl: Optional[str] = None,
                 halt_on_nan: bool = False,
                 pp_microbatches: Optional[int] = None,
                 pp_schedule: str = "gpipe",
                 weight_update_sharding: str = "auto",
                 debug_recompiles: bool = False,
                 strategy: Optional[str] = None,
                 elastic: Optional[Dict[str, Any]] = None,
                 sharding=None,
                 device=None,
                 backend: Optional[str] = None):
        from .parallel.mesh import as_mesh
        self.mesh = as_mesh(mesh)
        # pipeline-parallel fits ('pp' mesh axis): microbatches per batch
        # (None: the deepest of 8, 4, 2, 1 dividing a dp replica's rows) and
        # the schedule ('gpipe' | '1f1b' | 'sequential', parallel/pp.py)
        self.pp_microbatches = pp_microbatches
        self.pp_schedule = pp_schedule
        if weight_update_sharding not in ("auto", "on", "off"):
            raise ValueError(
                f"weight_update_sharding must be 'auto', 'on', or 'off'; "
                f"got {weight_update_sharding!r}")
        self.weight_update_sharding = weight_update_sharding
        # sharded-parameter training: "auto" derives PartitionSpecs from
        # the model when the mesh has axes beyond 'dp' (megatron rules, or
        # fsdp's ZeRO specs), an explicit pspec pytree is used as it is,
        # None keeps params replicated; resolved at fit time
        # (_resolve_pspecs), as in JAX
        self.param_sharding = param_sharding
        # the declarative config supersedes the legacy knob when given: its
        # zero_stage is an explicit request (ineligible fits raise), its
        # param_axes the per-param placement
        self.sharding = (as_sharding_config(sharding)
                         if sharding is not None else None)
        # a mesh fit's collective backend: None picks by the rule of
        # parallel.distributed.choose_backend; an explicit one that cannot
        # be honoured raises
        self.backend = backend
        self._zero_stage = 0          # resolved per fit: 0..3
        self._zero1_active = False
        # a tp / fsdp fit's PartitionSpec tree (None: replicated params),
        # resolved per fit, and this rank's placement under it
        self._pspecs = None
        self._placement = None
        # a pp fit's stage placement (parallel.pp.StagePlacement) and its
        # schedule's serial span (schedule_ticks)
        self._stages = None
        self._pp_ticks = None
        self._zero3_template = None   # standard param shapes, stage-3 fits
        self.last_mesh_stats: Optional[Dict[str, Any]] = None
        self._launch_ema = None
        self._launched_step_stats = None
        self._offload_active = False
        # a launched rank's line to its caller (parallel.distributed), and
        # whether it waits for the caller's verdict after each post
        self._channel = None
        self._await_verdict = False
        self._ctl_stop = False        # the caller's "stop"
        self._resumed_from = 0
        self._epoch_keys: List[int] = []
        # training strategy: None/'sync' is the synchronous loop below;
        # 'elastic_dp' routes fit() through parallel.elastic — bounded-
        # staleness async replicas over a versioned parameter store (the
        # reference's Hogwild identity). `elastic` tunes it
        if strategy not in (None, "sync", "elastic_dp"):
            raise ValueError(f"strategy must be None, 'sync', or "
                             f"'elastic_dp'; got {strategy!r}")
        self.strategy = strategy
        self.elastic = dict(elastic or {})
        known = {"replicas", "max_staleness", "dampening",
                 "density_threshold", "lease_ttl_s"}
        unknown = set(self.elastic) - known
        if unknown:
            raise ValueError(f"unknown elastic option(s) {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        if self.elastic and strategy != "elastic_dp":
            raise ValueError("elastic options require strategy='elastic_dp'")
        # filled by an elastic fit: push/staleness/membership accounting
        self.last_elastic_stats: Optional[Dict[str, Any]] = None
        # debug_recompiles=True runs each fit under track_recompiles: the
        # signature report of the core epoch / step probes lands in
        # self.recompile_report / self.recompile_findings
        self.debug_recompiles = bool(debug_recompiles)
        self.recompile_report: Optional[str] = None
        self.recompile_findings: list = []
        if rng_impl is not None:
            raise ValueError("rng_impl names a jax.random implementation; the "
                             "port draws from torch.Generator")
        if isinstance(graph, GraphDef):
            self.model = GraphModel(graph, compute_dtype, device=device)
        elif isinstance(graph, str):
            from .models import model_from_json
            self.model = model_from_json(graph, compute_dtype, device=device)
        elif isinstance(graph, (RegistryModel, GraphModel, TF1GraphModel)):
            self.model = graph
        else:
            raise TypeError(f"graph must be a spec JSON string, a GraphDef, "
                            f"or a model of this package; got "
                            f"{type(graph).__module__}.{type(graph).__name__}")
        for name in (input_name if isinstance(input_name, (list, tuple))
                     else [input_name]):
            self.model.resolve(name)
        if label_name:
            self.model.resolve(label_name)
        if dropout_name:
            self.model.resolve(dropout_name)
        self.device = self.model.device
        self.input_name = input_name
        self.label_name = label_name
        if isinstance(optimizer, str):
            self.optimizer = build_optimizer(optimizer, learning_rate,
                                             optimizer_options)
            self._opt_cfg = dict(optimizer_options or {})
        else:
            self.optimizer = optimizer
            # an optimizer object: optimizer_options passed alongside (as
            # the estimator does) still inform the zero 'auto' gate
            self._opt_cfg = (dict(optimizer_options) if optimizer_options
                             else None)
        # what a launched rank rebuilds this trainer from (a mesh fit
        # outside a process group): picklable arguments only; None where
        # the caller gave an object a rank cannot rebuild
        self._recipe = dict(
            graph=graph if isinstance(graph, (str, GraphDef)) else None,
            input_name=input_name, label_name=label_name,
            optimizer=optimizer if isinstance(optimizer, str) else None,
            learning_rate=learning_rate, optimizer_options=optimizer_options,
            iters=iters, mini_batch_size=mini_batch_size,
            mini_stochastic_iters=mini_stochastic_iters,
            shuffle_per_iter=shuffle_per_iter,
            partition_shuffles=partition_shuffles, verbose=verbose,
            dropout_name=dropout_name, seed=seed,
            compute_dtype=compute_dtype, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, publish_every=publish_every,
            straggler_factor=straggler_factor, halt_on_nan=halt_on_nan,
            param_sharding=param_sharding,
            pp_microbatches=pp_microbatches, pp_schedule=pp_schedule,
            weight_update_sharding=weight_update_sharding,
            sharding=sharding, backend=backend,
            mesh=dict(self.mesh.shape) if self.mesh is not None else None)
        self.iters = iters
        self.mini_batch_size = mini_batch_size
        self.mini_stochastic_iters = mini_stochastic_iters
        self.shuffle_per_iter = shuffle_per_iter
        self.partition_shuffles = max(1, partition_shuffles)
        self.verbose = verbose
        self.loss_callback = loss_callback
        self.dropout_name = dropout_name
        self.seed = seed
        self.halt_on_nan = halt_on_nan
        # step-level checkpoint/resume; with a checkpoint_dir a failing
        # epoch restores the last checkpoint and continues, up to
        # resume_retries times
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume_retries = resume_retries
        self.straggler_factor = straggler_factor
        self.straggler_callback = straggler_callback
        self.metrics = metrics if metrics is not None else default_metrics
        # live weight publication (train -> serve): publish_every == 0 means
        # publish once at fit end when a store is configured
        self.publish_every = int(publish_every)
        if isinstance(publish_to, str):
            from .serving.weightstore import WeightStore
            publish_to = WeightStore(publish_to)
        self._publish_store = publish_to
        self._recipe["publish_to"] = (publish_to.directory
                                      if publish_to is not None else None)
        self.params = None
        self._last_opt_state = None
        # span tracing: fit(trace_spans=...) fills these per run — the
        # Tracer holding the spans, the StepStats phase summary, and the
        # Chrome-trace path the fit exported
        self.last_tracer = None
        self.last_step_stats: Optional[dict] = None
        self.last_trace_path: Optional[str] = None
        self._tracer = None
        self._step_stats = None

    # -- batching plan ------------------------------------------------------

    def _plan(self, n: int):
        """Resolve (mode, batch_size, num_batches) from the reference's three
        batching modes — the JAX trainer's rule; on a mesh the batch rounds
        up to a multiple of the ranks its rows divide over."""
        dp = self._batch_ranks()
        bs = self.mini_batch_size
        stochastic = bool(self.mini_stochastic_iters
                          and self.mini_stochastic_iters > 0)
        if bs is None or bs <= 0 or (bs >= n and not stochastic):
            # full-batch mode; an over-large miniBatchSize degenerates to one
            # full-batch step per epoch...
            batch = -(-n // dp) * dp
            return "full", batch, 1
        if bs >= n:
            # ...except in stochastic mode, where the batch is clamped to
            # the dataset and the requested number of steps still runs
            bs = n
        batch = -(-bs // dp) * dp
        sweeps = -(-n // batch)
        if stochastic:
            return "stochastic", batch, self.mini_stochastic_iters
        return "sweep", batch, sweeps

    # -- state: parameters, generators, checkpoints -------------------------

    def _initial_params(self, init_params):
        """A float32 copy of ``init_params`` (default ``model.init(seed)``)
        on the model's device, trainable: the optimizer updates it in
        place."""
        if init_params is None:
            init_params = self.model.init(seed=self.seed)
        return self.model.load_params(tree_map(
            lambda a: (a.detach() if torch.is_tensor(a)
                       else torch.as_tensor(np.asarray(a))).to(
                self.device, torch.float32, copy=True), init_params),
            trainable=True)

    def _generators(self):
        """The fit's ``(shuffle, dropout)`` generators: shuffles and batch
        draws on the CPU (the same indices on any device), dropout on the
        model's device."""
        return (torch.Generator().manual_seed(int(self.seed)),
                torch.Generator(device=self.device).manual_seed(
                    int(self.seed) + 1))

    @staticmethod
    def _ckpt_state(params, opt_state, step: int, gens) -> Dict[str, Any]:
        """The checkpoint payload: the JAX trainer's schema (``_ckpt_state``
        there). ``rng`` is the generators' states as one uint8 array,
        ``rng_impl`` the stream's name as ASCII bytes."""
        rng = np.concatenate([g.get_state().numpy() for g in gens])
        return {"params": params,
                "opt_state": state_map(_state_to_ckpt, opt_state),
                "epoch": np.int64(step), "rng": rng,
                "rng_impl": np.frombuffer(RNG_IMPL.encode(), np.uint8).copy()}

    def _check_rng(self, rng, rng_impl, gens) -> List[torch.Tensor]:
        """The generator states of a checkpoint's ``rng``, after refusing a
        checkpoint of another random stream (the JAX package's) or one whose
        states do not fit this trainer's generators."""
        try:
            theirs = np.asarray(rng_impl, np.uint8).tobytes().decode()
        except UnicodeDecodeError:
            raise ValueError(
                "checkpoint rng_impl record is not valid ASCII — the "
                "checkpoint is corrupt; point checkpoint_dir at a fresh "
                "directory to restart the rng stream") from None
        if theirs != RNG_IMPL:
            raise ValueError(
                f"checkpoint was written under rng_impl={theirs!r} (the JAX "
                f"package's jax.random stream) but this trainer draws from "
                f"torch.Generator (rng_impl={RNG_IMPL!r}): the parameters and "
                f"optimizer state interchange, the random stream does not. "
                f"Read the checkpoint with CheckpointManager and pass its "
                f"params as init_params, with checkpoint_dir pointing at a "
                f"fresh directory")
        rng = np.asarray(rng, np.uint8)
        sizes = [g.get_state().numel() for g in gens]
        if rng.shape != (sum(sizes),):
            raise ValueError(
                f"checkpoint rng holds {rng.size} bytes but this trainer's "
                f"generators on {self.device.type} take {sum(sizes)}: the "
                f"checkpoint was written by a fit on another device type — "
                f"resume there, or point checkpoint_dir at a fresh directory")
        cuts = np.cumsum(sizes)[:-1]
        return [torch.from_numpy(part.copy()) for part in np.split(rng, cuts)]

    def _restore(self, state, like, gens):
        """``(params, opt_state, epoch)`` from a restored checkpoint ``state``
        (a tree of ``like``'s structure); sets the generators' states."""
        gen_states = self._check_rng(state["rng"], state["rng_impl"], gens)
        params = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(
            self.device, torch.float32, copy=True), state["params"])
        if self._stages is None:
            params = self.model.load_params(params, trainable=True)
        opt_state = _tree_zip(_state_from_ckpt, like["opt_state"],
                              state["opt_state"])
        for g, st in zip(gens, gen_states):
            g.set_state(st)
        return params, opt_state, int(state["epoch"])

    def _open_checkpoints(self, params, opt_state, gens):
        """``(manager, template, restored)`` for a fit with a
        ``checkpoint_dir`` (``restored`` is ``(params, opt_state, epoch)`` or
        None), ``(None, None, None)`` without one."""
        if not self.checkpoint_dir:
            return None, None, None
        from .checkpoint import CheckpointManager
        mgr = CheckpointManager(self.checkpoint_dir)
        like = self._ckpt_state(params, opt_state, 0, gens)
        theirs = _ckpt_stages(mgr)
        if theirs is not None and (theirs > 0) != (self._stages is not None):
            state = self._restore_relayout(mgr, like, theirs)
        else:
            state = mgr.restore(like=like)
        if state is None:
            return mgr, like, None
        return mgr, like, self._restore(state, like, gens)

    def _restore_relayout(self, mgr, like, theirs: int):
        """A checkpoint of the other layout, read and relaid out into
        ``like``'s: a pp fit's stacked stages (``theirs`` stages) into the
        standard layout, or the standard layout into this pp fit's stacked
        stages (``theirs`` 0)."""
        from .parallel.pp import (merge_stage_params, merge_stage_state,
                                  split_stage_params, split_stage_state)
        meta = tree_map(lambda p: torch.empty(tuple(np.shape(p)),
                                              device="meta"), like["params"])
        if theirs:
            std_t = meta
            other_p = split_stage_params(self.model, std_t, theirs)
            other_o = split_stage_state(self.optimizer, self.model, std_t,
                                        like["opt_state"], theirs)
        else:
            other_p = merge_stage_params(self.model, meta)
            other_o = merge_stage_state(self.optimizer, self.model, meta,
                                        like["opt_state"])
        state = mgr.restore(like=dict(like, params=other_p,
                                      opt_state=other_o))
        if state is None:
            return None
        if theirs:
            stage_t = split_stage_params(self.model, meta, theirs)
            params = merge_stage_params(self.model, state["params"])
            opt = merge_stage_state(self.optimizer, self.model, stage_t,
                                    state["opt_state"])
        else:
            std_t = merge_stage_params(self.model, meta)
            n = self.mesh.shape["pp"]
            params = split_stage_params(self.model, state["params"], n)
            opt = split_stage_state(self.optimizer, self.model, std_t,
                                    state["opt_state"], n)
        return dict(state, params=params, opt_state=opt)

    # -- fit ----------------------------------------------------------------

    def fit(self, features, labels: Optional[np.ndarray] = None,
            init_params=None, *, trace_spans=False,
            trace_dir: Optional[str] = None) -> TrainResult:
        """Train; ``features`` is an array (or a tuple of arrays for a
        multi-input model) of rows — token ids may come as floats, as the
        estimator hands them over. ``labels`` is None for the LM.
        ``init_params`` is a params tree (copied) to start from instead of
        ``model.init(seed=seed)``; a checkpoint in ``checkpoint_dir`` takes
        precedence over both.

        With ``trace_spans`` truthy the fit runs instrumented: phase spans
        (``setup``, ``transfer``, ``step``, ``metrics``, ``checkpoint``)
        collected on a fresh :class:`~sparkflow_tpu_torch.obs.Tracer` under a
        ``train/fit`` root, exported as Chrome-trace JSON and span JSONL
        (``trace_spans`` may be the output path; otherwise one is derived
        from ``trace_dir``, ``checkpoint_dir`` or the system temp dir — see
        ``self.last_trace_path``). Phase totals and the throughput and MFU
        gauges land in ``self.last_step_stats`` and the metrics registry.
        Each step phase waits for the card before it reads the clock.
        Nothing is traced or compiled here, so no step is ever the JAX
        package's ``step_compile``."""
        with self._recompile_scope():
            return self._fit_traced(features, labels, init_params,
                                    trace_spans, trace_dir)

    @contextlib.contextmanager
    def _recompile_scope(self):
        """With ``debug_recompiles``, run the fit under
        :func:`~.analysis.runtime_guards.track_recompiles` and keep the
        tracker's report/findings on the trainer afterwards."""
        if not self.debug_recompiles:
            yield
            return
        from .analysis.runtime_guards import track_recompiles
        with track_recompiles() as tracker:
            try:
                yield
            finally:
                self.recompile_report = tracker.report()
                self.recompile_findings = tracker.findings()

    def _fit_traced(self, features, labels, init_params, trace_spans,
                    trace_dir) -> TrainResult:
        if not trace_spans:
            return self._fit_impl(features, labels, init_params)
        from .obs import StepStats, Tracer
        tracer = Tracer()
        stats = StepStats(tracer=tracer, metrics=self.metrics)
        self.last_tracer = tracer
        self.last_step_stats = None
        self._tracer, self._step_stats = tracer, stats
        try:
            # activate(): checkpoint spans fired deep in the stack route to
            # this fit's tracer, nested under the root
            with tracer.activate(), tracer.span("train/fit"):
                result = self._fit_impl(features, labels, init_params)
        finally:
            self._tracer = None
            self._step_stats = None
        # a launched mesh fit traced its ranks: rank 0's summary
        self.last_step_stats = (self._launched_step_stats
                                or stats._summary)
        self._launched_step_stats = None
        if isinstance(trace_spans, str):
            path = trace_spans
        else:
            base = trace_dir or self.checkpoint_dir or tempfile.gettempdir()
            path = os.path.join(
                base, f"sparkflow_tpu_torch_trace_{os.getpid()}.json")
        self.last_trace_path = tracer.export_chrome_trace(path)
        tracer.export_jsonl(
            (path[:-5] if path.endswith(".json") else path) + ".jsonl")
        return result

    # -- mesh strategies (dp with ZeRO stages, sp) ---------------------------

    def _chief(self) -> bool:
        """Whether this process writes checkpoints and publishes: always off
        a mesh, rank 0 on one."""
        if self.mesh is None or not _in_group():
            return True
        import torch.distributed as dist
        return dist.get_rank() == 0

    def _mesh_strategy(self) -> str:
        axes = self.mesh.axis_names
        if "pp" in axes and "sp" in axes:
            raise ValueError(
                "a Trainer mesh cannot combine 'pp' and 'sp' axes; pick "
                "one strategy per fit (pipeline xor sequence parallelism)")
        if "pp" in axes:
            bad = [a_ for a_ in axes if a_ not in ("pp", "dp")]
            if bad:
                raise ValueError(
                    f"'pp' composes with 'dp' only; mesh also has {bad}")
            return "pp"
        if "sp" in axes:
            bad = [a for a in axes if a not in ("sp", "dp")]
            if bad:
                raise ValueError(
                    f"'sp' composes with 'dp' only; mesh also has {bad}")
            return "sp"
        return "default"

    def _strategy_task(self, strategy: str) -> str:
        """Validate the model/mesh/label combination for a pp or sp fit and
        return the step's task, ``"classifier"`` or ``"lm"`` (the JAX
        trainer's rules)."""
        m = self.model
        # pipeline stages / replicated sp params are placed by the strategy
        # itself — an explicit user pytree cannot be honored, so refuse it
        # loudly rather than silently replicating
        if (self.param_sharding is not None
                and not isinstance(self.param_sharding, str)):
            raise ValueError(
                "explicit param_sharding pytrees do not apply to pp/sp "
                "strategy meshes (the strategy places its own params); "
                "drop param_sharding or use a dp/tp/fsdp/ep mesh")
        n_inputs = (len(self.input_name)
                    if isinstance(self.input_name, (list, tuple)) else 1)
        if strategy == "pp" and self.label_name is not None and n_inputs != 1:
            raise ValueError(
                "pp classifier fits take exactly one input tensor (the "
                "token ids); the pipeline step has no attention-mask path — "
                "extra inputs would be silently ignored, so refuse instead")
        if n_inputs > 2:
            raise ValueError(
                f"{strategy} fits take at most (input_ids, attention_mask); "
                f"got {n_inputs} input tensors")
        if strategy == "pp":
            if not (hasattr(m, "num_layers") and hasattr(m, "_block")):
                raise ValueError(
                    f"meshShape with a 'pp' axis trains the registry "
                    f"transformer families (stage-shardable blocks); "
                    f"{type(m).__name__} has no block structure to "
                    f"pipeline — use dp/fsdp for nn-DSL graphs")
            n_stages = self.mesh.shape["pp"]
            if m.num_layers % n_stages:
                raise ValueError(
                    f"num_layers={m.num_layers} does not divide into "
                    f"pp={n_stages} pipeline stages")
            return "lm" if self.label_name is None else "classifier"
        from .models.transformer import TransformerLM
        if not isinstance(self.model, TransformerLM):
            raise ValueError(
                f"meshShape with an 'sp' axis trains causal LM registry "
                f"models (ring attention over the sequence); "
                f"{type(self.model).__name__} is not a TransformerLM family "
                f"model")
        if self.label_name is not None:
            raise ValueError(
                "'sp' fits are unsupervised next-token training "
                "(tfLabel/label_name must be None)")
        return "lm"

    def _data_axis(self) -> str:
        return (self.sharding.data_axis if self.sharding is not None
                else "dp")

    def _dp_size(self) -> int:
        from .parallel.mesh import mesh_axis_size
        return mesh_axis_size(self.mesh, self._data_axis())

    def _batch_axes(self) -> tuple:
        """The mesh axes a batch's rows shard over: the config's (dcn, dp)
        on the default strategy, ``dp`` under pp and sp."""
        if self.mesh is None:
            return ()
        if self._mesh_strategy() in ("pp", "sp"):
            return tuple(a for a in ("dp",) if a in self.mesh.axis_names)
        return (self.sharding or ShardingConfig()).batch_axes(self.mesh)

    def _active_cfg(self):
        """The ShardingConfig in effect for the current fit, its
        ``zero_stage`` the one :meth:`_resolve_zero_stage` decided."""
        base = (self.sharding if self.sharding is not None
                else ShardingConfig())
        return base.replace(zero_stage=self._zero_stage)

    def _resolve_pspecs(self):
        """PartitionSpec tree for sharded-parameter training, or None — the
        JAX trainer's rule and messages: only on a mesh and the default
        strategy (pp / sp place their own params); ``sharding.param_axes``
        other than ``"auto"`` comes first (None: replicated, a pytree:
        explicit), then ``param_sharding``: an explicit pytree as it is,
        None replicated, ``"auto"`` derived from the model on a mesh with
        axes beyond 'dp' (megatron rules, or fsdp's ZeRO specs). An
        explicit tree is checked against the params here, before any rank
        starts (:func:`~.parallel.tp.check_pspec_tree`)."""
        if self.mesh is None or self._mesh_strategy() != "default":
            return None
        if self.sharding is not None and self.sharding.param_axes != "auto":
            pa = self.sharding.param_axes
            if pa is not None and isinstance(pa, str):
                raise ValueError(
                    f"ShardingConfig.param_axes must be 'auto', None, or a "
                    f"PartitionSpec pytree; got {pa!r}")
            return self._explicit_pspecs(pa)
        if self.param_sharding is None:
            return None
        if not isinstance(self.param_sharding, str):
            return self._explicit_pspecs(self.param_sharding)
        if self.param_sharding != "auto":
            raise ValueError(
                f"param_sharding must be 'auto', None, or a PartitionSpec "
                f"pytree; got {self.param_sharding!r}")
        if all(a == "dp" for a in self.mesh.axis_names):
            return None
        from .parallel.tp import derive_param_pspecs
        pspecs = derive_param_pspecs(self.model, self.mesh)
        if pspecs is None and any(a_ in self.mesh.axis_names
                                  for a_ in ("tp", "ep")):
            # refusing beats silently replicating params and letting the
            # tensor ranks compute redundant identical work
            raise ValueError(
                f"mesh axes {[a_ for a_ in self.mesh.axis_names if a_ != 'dp']} "
                f"request tensor-sharded params but "
                f"{type(self.model).__name__} publishes no param_pspecs() "
                f"(megatron rules exist for the registry transformer/resnet/"
                f"moe families); use an 'fsdp' axis instead — ZeRO specs "
                f"derive from param_specs() for any model")
        return pspecs

    def _explicit_pspecs(self, tree):
        """A user's PartitionSpec tree, checked against the params' shapes
        and the mesh (None passes: replicated)."""
        if tree is not None:
            from .parallel.tp import check_pspec_tree
            check_pspec_tree(tree, {
                ln: {k: shape for k, (shape, _init) in layer.items()}
                for ln, layer in self.model.param_specs().items()},
                self.mesh)
        return tree

    def _resolve_zero_stage(self, strategy: str, params) -> int:
        """Decide how much of the weight update shards over dp (stage 0-3) —
        the JAX trainer's rule. Eligible: the default (pure-dp) strategy and
        dp >= 2. ``weight_update_sharding`` maps 'off' -> 0 and 'on' /
        'auto' -> 1; 'auto' also needs per-param optimizer state and no
        ``clip_norm`` / ``ema_decay``. An explicit
        ``sharding=ShardingConfig(zero_stage=N)`` is a REQUEST: an
        ineligible fit raises instead of falling back. ``params`` None
        only checks."""
        cfg_opts = self._opt_cfg or {}
        blocked = [k for k in ("clip_norm", "ema_decay") if cfg_opts.get(k)]
        sharded = self._pspecs is not None
        eligible = (strategy == "default" and not sharded
                    and self.mesh is not None
                    and self._data_axis() in self.mesh.axis_names
                    and self._dp_size() >= 2)
        if self.sharding is not None:
            stage = self.sharding.zero_stage
            if stage == 0:
                return 0
            if self.mesh is None:
                raise ValueError(
                    f"sharding.zero_stage={stage} shards the update over "
                    f"mesh axis {self.sharding.data_axis!r} but the trainer "
                    f"has no mesh; pass mesh=make_mesh({{'"
                    f"{self.sharding.data_axis}': N}}) or use zero_stage=0")
            self.sharding.validate(self.mesh, require_data_axis=True)
            if not eligible:
                raise ValueError(
                    f"sharding.zero_stage={stage} needs a pure-dp fit with "
                    f"replicated params and {self.sharding.data_axis} >= 2 "
                    f"(got strategy={strategy!r}, sharded-params="
                    f"{sharded}, {self.sharding.data_axis}="
                    f"{self._dp_size()}); use zero_stage=0 or a "
                    f"{self.sharding.data_axis}-axis mesh")
            if blocked:
                raise ValueError(
                    f"sharding.zero_stage={stage} is incompatible with "
                    f"optimizer options {blocked}: the shard-local update "
                    f"would break their global-layout math (clip_norm "
                    f"measures a global norm; ema extraction expects the "
                    f"standard layout)")
            return stage
        mode = self.weight_update_sharding
        if mode == "off":
            return 0
        if mode == "on":
            if not eligible:
                if params is not None:
                    logger.warning(
                        "weight_update_sharding='on' needs a pure-dp fit on "
                        "a mesh with dp >= 2 (got strategy=%r, "
                        "sharded-params=%s, dp=%d); training with the "
                        "replicated update", strategy, sharded,
                        self._dp_size())
                return 0
            if blocked:
                if params is not None:
                    logger.warning(
                        "weight_update_sharding='on' is incompatible with %s "
                        "(shard-local update would break their global-layout "
                        "math); training with the replicated update", blocked)
                return 0
            return 1
        if not eligible or blocked or params is None:
            return 0
        from .optimizers_sharded import has_per_param_state
        return 1 if has_per_param_state(self.optimizer, params) else 0

    def _trim_for_strategy(self, strategy, features, labels, n, multi):
        """Trim the dataset to whole batches for a strategy without
        padded-row masking (the JAX trainer's rule and warning)."""
        dp = self._batch_ranks()
        bs = self.mini_batch_size
        stoch = bool(self.mini_stochastic_iters
                     and self.mini_stochastic_iters > 0)
        if bs is None or bs <= 0 or bs >= n or stoch:
            unit = dp
        else:
            unit = -(-bs // dp) * dp  # the planned sweep batch
        n_use = (n // unit) * unit
        if n_use == 0:
            raise ValueError(f"dataset of {n} rows is smaller than one "
                             f"{strategy} batch ({unit} rows)")
        if n_use != n:
            logger.warning(
                "%s fit drops the %d-row remainder (pp/sp steps carry no "
                "padded-row masking); a miniBatchSize dividing %d trains on "
                "every row", strategy, n - n_use, n)
            features = (tuple(f[:n_use] for f in features) if multi
                        else features[:n_use])
            if labels is not None:
                labels = labels[:n_use]
        return features, labels, n_use

    def _batch_ranks(self) -> int:
        """Ranks one batch's rows divide over."""
        if self.mesh is None:
            return 1
        out = 1
        for a in self._batch_axes():
            out *= self.mesh.shape[a]
        return out

    def _mesh_step(self, strategy: str, task: str, batch: int):
        """``(step_fn, rows)`` for the epoch loop on a mesh: the per-rank
        step (dp at the resolved zero stage, or sp), fed this rank's block
        of every batch, ``rows = (index, count)`` over the batch axes, and
        a seed per step drawn from the fit's dropout stream (the same on
        every rank; the step folds in the rank's mesh indices)."""
        from .parallel.collectives import axis_index
        mesh = self.mesh
        axes = self._batch_axes()
        count = self._batch_ranks()
        if batch % count:
            raise ValueError(
                f"mini_batch_size={batch} must divide over the batch axes "
                f"{axes} ({count} ranks) for a mesh fit")
        rows = (axis_index(axes) if axes else 0, count)
        if strategy == "default" and self._placement is not None:
            from .parallel.dp import make_param_sharded_train_step
            raw = make_param_sharded_train_step(
                self.model, self.optimizer, mesh, self.input_name,
                self.label_name, self._pspecs, self._placement.template,
                sharding=self.sharding)

            def step_fn(p, o, x, y, m, gen):
                return raw(p, o, x, y, m, _draw_seed(gen))

            return step_fn, rows
        if strategy == "default":
            if self._data_axis() not in mesh.axis_names:
                raise ValueError(
                    f"a data-parallel mesh fit shards rows over mesh axis "
                    f"{self._data_axis()!r}; the mesh has axes "
                    f"{list(mesh.axis_names)}")
            from .parallel.dp import make_dp_train_step
            raw = make_dp_train_step(self.model, self.optimizer, mesh,
                                     self.input_name, self.label_name,
                                     sharding=self._active_cfg(),
                                     param_template=self._zero3_template)

            def step_fn(p, o, x, y, m, gen):
                return raw(p, o, x, y, m, _draw_seed(gen))

            return step_fn, rows
        if strategy == "pp":
            return self._pp_step(task, batch, count), rows
        from .parallel.sp import make_sp_train_step
        sp = mesh.shape["sp"]
        j = axis_index("sp")
        raw = make_sp_train_step(self.model, self.optimizer, mesh)

        def step_fn(p, o, x, y, m, gen):
            ids = x[0] if isinstance(x, tuple) else x
            amask = x[1] if isinstance(x, tuple) else y  # y carries ones
            s = ids.shape[1]
            if s % sp:
                raise ValueError(
                    f"sequence length {s} must divide the sp axis (size "
                    f"{sp}) for ring attention")
            cols = slice(j * (s // sp), (j + 1) * (s // sp))
            return raw(p, o, ids[:, cols], amask[:, cols], _draw_seed(gen))

        return step_fn, rows

    def _pp_microbatches(self, batch: int, dp: int) -> int:
        """Microbatches a pp batch splits into: ``pp_microbatches``, or the
        deepest of 8, 4, 2, 1 dividing a dp replica's rows (JAX's rule and
        message)."""
        per_dp = batch // max(dp, 1)
        M = self.pp_microbatches
        if M is None:
            # auto: the deepest power-of-two microbatching the per-replica
            # batch supports (bounds the pipeline bubble at fixed memory)
            return next(m for m in (8, 4, 2, 1) if per_dp % m == 0)
        if per_dp % M:
            raise ValueError(
                f"pp_microbatches={M} must divide the per-dp-replica "
                f"batch {per_dp}")
        return M

    def _pp_step(self, task: str, batch: int, dp: int):
        """The pp epoch's step (microbatches by :meth:`_pp_microbatches`),
        the attention mask as the lm task's token weights."""
        from .parallel.pp import make_pp_train_step
        M = self._pp_microbatches(batch, dp)
        raw = make_pp_train_step(self.model, self.optimizer, self.mesh,
                                 n_microbatches=M, schedule=self.pp_schedule,
                                 task=task)
        self._pp_ticks = raw.schedule_ticks

        def step_fn(p, o, x, y, m, gen):
            ids = x[0] if isinstance(x, tuple) else x
            # the lm task takes the attention mask as token loss weights
            y_eff = x[1] if task == "lm" and isinstance(x, tuple) else y
            return raw(p, o, ids, y_eff, _draw_seed(gen))

        return step_fn

    def _stop_requested(self, guard) -> bool:
        """The preemption flag, or a launched rank's "stop" from its caller;
        on a mesh, raised on any rank stops every rank at the same epoch
        (one small all-reduce an epoch, only when the fit checkpoints)."""
        if self.mesh is None or isinstance(guard, NullGuard):
            return guard.requested or self._ctl_stop
        from .parallel import collectives
        flag = torch.tensor([float(guard.requested or self._ctl_stop)],
                            device=self.device)
        return bool(collectives.psum({"f": flag},
                                     self.mesh.axis_names)["f"].item() > 0)

    # -- layouts: the standard (checkpoint) form and the rank's form --------

    def _params_to_ckpt(self, params):
        """The checkpoint layout of params: the standard one (stage 3
        gathers every rank's rows, a tp / fsdp fit every rank's slices),
        or a pp fit's stacked stages (every rank's stage): a collective."""
        if self._stages is not None:
            with torch.no_grad():
                return self._stages.to_ckpt(params)
        if self._placement is not None:
            with torch.no_grad():
                return self._placement.gather(
                    tree_map(lambda p: p.detach(), params))
        if self._zero_stage < 3:
            return params
        from .optimizers_sharded import gather_rows, gather_zero3_params
        rows = gather_rows(tree_map(lambda p: p.detach(), params),
                           self._dp_size(), self._data_axis())
        return gather_zero3_params(rows, self._zero3_template)

    def _std_params(self, params):
        """Standard-layout params from this rank's (a collective on a
        mesh that shards them)."""
        out = self._params_to_ckpt(params)
        if self._stages is not None:
            from .parallel.pp import merge_stage_params
            out = merge_stage_params(self.model, out)
        return out

    def _params_from_ckpt(self, params):
        """Checkpoint-layout params -> this rank's stage-3 rows, its tp /
        fsdp slices (trainable, installed on the model) or its pp stage
        (trainable), the full tensors' storage released."""
        if self._stages is not None:
            with torch.no_grad():
                local = self._stages.from_ckpt(tree_map(
                    lambda p: torch.as_tensor(p).detach(), params))
            for p in tree_leaves(params):
                if torch.is_tensor(p):
                    p.data = p.data.new_empty(0)
            return tree_map(lambda p: p.requires_grad_(True), local)
        if self._placement is not None:
            with torch.no_grad():
                local = self._placement.place(
                    tree_map(lambda p: p.detach(), params))
            for p in tree_leaves(params):
                p.data = p.data.new_empty(0)
            return self.model.load_params(local, trainable=True)
        if self._zero_stage < 3:
            return params
        from .optimizers_sharded import place_zero1_state, shard_zero3_params
        dp_n = self._dp_size()
        rows = place_zero1_state(
            shard_zero3_params(tree_map(lambda p: p.detach(), params), dp_n),
            self.mesh, dp_n, self._data_axis())
        for p in tree_leaves(params):
            # params at rest are the rows now: free the full copy
            p.data = p.data.new_empty(0)
        return tree_map(lambda r: r.requires_grad_(True), rows)

    def _opt_to_ckpt(self, params, opt_state):
        """The checkpoint layout of the optimizer state: the standard
        (param-shaped) one — a zero fit gathers every rank's rows, a tp /
        fsdp fit every rank's slices — or a pp fit's stacked stages (a
        collective). ``params`` in the checkpoint layout."""
        if self._stages is not None:
            with torch.no_grad():
                return self._stages.state_to_ckpt(self.optimizer, opt_state)
        if self._placement is not None:
            with torch.no_grad():
                return self._placement.gather_state(self.optimizer,
                                                    opt_state)
        if not self._zero1_active:
            return opt_state
        from .optimizers_sharded import gather_rows, gather_zero1_state
        dp_n = self._dp_size()
        return gather_zero1_state(
            self.optimizer, params,
            gather_rows(opt_state, dp_n, self._data_axis()), dp_n)

    def _opt_from_ckpt(self, params, opt_state):
        """Standard state -> this rank's rows, re-padded for THIS mesh's dp
        size (which may differ from the writing run's); a tp / fsdp fit's
        slices; a pp fit's stage."""
        if self._stages is not None:
            return self._stages.state_from_ckpt(self.optimizer, opt_state)
        if self._placement is not None:
            return self._placement.place_state(self.optimizer, opt_state)
        if not self._zero1_active:
            return opt_state
        from .optimizers_sharded import place_zero1_state, shard_zero1_state
        dp_n = self._dp_size()
        return place_zero1_state(
            shard_zero1_state(self.optimizer, params, opt_state, dp_n),
            self.mesh, dp_n, self._data_axis())

    def _rank_stats(self, strategy, opt_state, params, steps, timer,
                    launches0) -> Dict[str, Any]:
        """This rank's accounting of a mesh fit (``last_mesh_stats``)."""
        import torch.distributed as dist
        from .optimizers_sharded import state_bytes_per_device
        from .parallel import collectives
        from .parallel.distributed import current_backend
        rank = dist.get_rank()
        moved = collectives.stats()
        ops = ("all_reduce", "reduce_scatter", "all_gather", "ppermute",
               "pp_hop")
        per_step = max(1, steps)
        now = _launch_counts()
        dev = self.device
        me = {
            "rank": rank, "coords": self.mesh.coords(rank),
            "device": str(dev), "steps": steps,
            "bytes_moved": {k: moved.get(k, 0) for k in ops},
            "bytes_moved_per_step": sum(moved.get(k, 0)
                                        for k in ops) / per_step,
            "host_staged_bytes": moved.get("host_staged", 0),
            "collective_calls": moved.get("calls", 0),
            "opt_state_bytes": state_bytes_per_device(opt_state),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in tree_leaves(params)),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "epoch_ms": timer.ms() if timer is not None else [],
            "kernel_launches": {k: now[k] - launches0.get(k, 0)
                                for k in now}}
        if strategy == "pp":
            me["schedule_ticks"] = self._pp_ticks
        return {"backend": current_backend(), "mesh": dict(self.mesh.shape),
                "strategy": strategy, "zero_stage": self._zero_stage,
                # which splits the forward computes on and which are stored
                # at rest (parallel.tp.PlacementPlan), None when replicated
                "placement": (self._placement.plan.describe()
                              if self._placement is not None else None),
                "world": self.mesh.size, "launched": False, "ranks": [me]}

    def _launch_recipe(self, verdicts: bool) -> Dict[str, Any]:
        """What each launched rank rebuilds this trainer from; refuses what
        a rank cannot rebuild."""
        recipe = dict(self._recipe, verbose=0, device_kind=self.device.type,
                      verdicts=verdicts)
        if recipe["graph"] is None:
            raise ValueError(
                "a mesh fit outside a process group launches its ranks, and "
                "each rebuilds the model from its spec: pass graph as the "
                "spec JSON string (or a GraphDef), not a model object — or "
                "run the fit inside an initialised group (torchrun)")
        if recipe["optimizer"] is None:
            raise ValueError(
                "a mesh fit outside a process group launches its ranks, and "
                "each rebuilds the optimizer: pass it by name (optimizer=, "
                "learning_rate=, optimizer_options=) — or run the fit "
                "inside an initialised group (torchrun)")
        return recipe

    def _live_loss(self, it: int, loss_val: float) -> None:
        """What the one-card loop does with an epoch's (a stream step's)
        loss, for a launched fit's post: ``verbose``, the ``train/loss``
        metric and ``loss_callback`` (which may raise)."""
        if self.verbose:
            logger.info("iteration %d loss %f", it, loss_val)
        self.metrics.scalar("train/loss", loss_val, step=it)
        if self.loss_callback is not None:
            self.loss_callback(loss_val, it, 0)

    def _take_launched(self, results: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Install rank 0's result of a launched fit on this trainer."""
        r0 = results[0]
        self.params = tree_map(lambda p: p.detach(), self.model.load_params(
            tree_map(lambda a: torch.as_tensor(a).to(self.device),
                     r0["params"])))
        self._zero_stage = r0["zero_stage"]
        self._zero1_active = self._zero_stage >= 1
        self._last_opt_state = None
        self._launch_ema = (tree_map(lambda a: torch.as_tensor(a).to(
            self.device), r0["ema"]) if r0["ema"] is not None else None)
        self._launched_step_stats = r0["step_stats"]
        self.last_mesh_stats = dict(
            r0["mesh_stats"], launched=True,
            ranks=[r["mesh_stats"]["ranks"][0] for r in results])
        return r0

    def _fit_launched(self, features, labels, init_params) -> TrainResult:
        """A mesh fit outside a process group: start ``mesh.size`` local
        ranks, fit in place on each, and take rank 0's result. The loss
        posts run the callbacks here, live; with a callback or a
        ``checkpoint_dir`` each post waits for this process's verdict. A
        callback that raises restores the last checkpoint on every rank, a
        rank that fails or dies restarts the ranks on the checkpoint
        directory — each up to ``resume_retries`` times in all."""
        from .parallel.distributed import RankError, RankPool
        verdicts = (self.loss_callback is not None
                    or bool(self.checkpoint_dir))
        recipe = self._launch_recipe(verdicts)
        init_params = _host_tree(init_params)
        trace = self._step_stats is not None
        retries = {"left": self.resume_retries if self.checkpoint_dir
                   else 0}
        live: Dict[int, float] = {}   # epoch -> rank 0's posted loss
        guard = (PreemptionGuard() if self.checkpoint_dir else NullGuard())
        pool = None

        def on_post(_rank, msg):
            _kind, it, loss_val = msg
            live[it] = loss_val
            verdict = "go"
            try:
                self._live_loss(it, loss_val)
            except Exception as e:  # noqa: BLE001 - judged below
                if not (retries["left"] > 0 and self._has_checkpoint()):
                    raise
                retries["left"] -= 1
                verdict = "restore"
                logger.warning(
                    "training failure at iteration %d (%s: %s); every rank "
                    "restores the last checkpoint (%d retries left)", it,
                    type(e).__name__, e, retries["left"])
            if verdict == "go" and guard.requested:
                verdict = "stop"
            if verdicts:
                pool.broadcast(("verdict", verdict))

        # a fit may run for as long as it needs: the wait is unbounded, and
        # a hang still ends it, since every rank's collectives time out
        # after mesh_timeout_s() and a rank that fails or dies stops the pool
        t0 = time.perf_counter()
        with guard:
            while True:
                try:
                    with RankPool(self.mesh.size, device=self.device.type,
                                  backend=self.backend) as pool:
                        results = pool.run(_mesh_fit_rank, recipe, features,
                                           labels, init_params, trace,
                                           timeout_s=math.inf,
                                           on_post=on_post)
                    break
                except RankError as e:
                    if retries["left"] <= 0:
                        raise
                    retries["left"] -= 1
                    logger.warning(
                        "a rank failed (%s); starting new ranks that resume "
                        "from %s (%d retries left)", str(e).splitlines()[0],
                        self.checkpoint_dir, retries["left"])
        wall = time.perf_counter() - t0
        r0 = self._take_launched(results)
        # epochs before the last run's resume point come from the posts of
        # the runs before it; the rest from rank 0's result
        start = r0["resumed_from"]
        losses = dict((k, v) for k, v in live.items() if k <= start)
        losses.update(zip(r0["epochs"], r0["losses"]))
        self._epoch_keys = sorted(losses)
        return TrainResult(self.params, [losses[k] for k in self._epoch_keys],
                           r0["examples_per_sec"], wall,
                           stop_reason=r0["stop_reason"])

    def _has_checkpoint(self) -> bool:
        from .checkpoint import CheckpointManager
        return bool(self.checkpoint_dir
                    and CheckpointManager(self.checkpoint_dir).all_steps())

    def _fit_impl(self, features, labels, init_params) -> TrainResult:
        multi = isinstance(features, tuple)
        n_inputs = (len(self.input_name)
                    if isinstance(self.input_name, (list, tuple)) else 1)
        if multi != (n_inputs > 1) or (multi and len(features) != n_inputs):
            got = (f"a tuple of {len(features)} arrays" if multi
                   else "a single features array")
            raise ValueError(f"model takes {n_inputs} input tensor(s) "
                             f"({self.input_name}) but fit() got {got}")
        if multi:
            features = tuple(np.ascontiguousarray(f, dtype=np.float32)
                             for f in features)
            n = features[0].shape[0]
            if any(f.shape[0] != n for f in features):
                raise ValueError("multi-input feature arrays disagree on rows")
        else:
            features = np.ascontiguousarray(features, dtype=np.float32)
            n = features.shape[0]
        if n == 0:
            raise ValueError("no training data")
        if labels is not None:
            labels = np.ascontiguousarray(labels, dtype=np.float32)
            if labels.ndim == 1:
                labels = labels[:, None]
        if self.strategy == "elastic_dp":
            return self._fit_elastic(features, labels, init_params, multi)

        mesh = self.mesh
        strategy, task = "default", None
        if mesh is not None:
            strategy = self._mesh_strategy()
            task = (self._strategy_task(strategy) if strategy != "default"
                    else None)
            # the placement and zero-stage errors a fit raises, before any
            # rank starts
            self._pspecs = self._resolve_pspecs()
            self._resolve_zero_stage(strategy, None)
            if strategy != "default":
                # pp / sp steps have no padded-row masking: every batch must
                # be all-real rows, so the dataset is trimmed to whole
                # batches (here, so launched ranks get the trimmed rows)
                features, labels, n = self._trim_for_strategy(
                    strategy, features, labels, n, multi)
            if strategy == "pp":
                self._pp_microbatches(self._plan(n)[1], self._batch_ranks())
            if not _in_group():
                return self._fit_launched(features, labels, init_params)

        mode, batch, num_batches = self._plan(n)
        if strategy != "default" and batch > n:
            raise ValueError(
                f"mini_batch_size rounds to {batch} rows (> dataset {n}); "
                f"{strategy} fits cannot pad batches — lower miniBatchSize")
        total = -(-n // batch) * batch
        if strategy != "default" and mode != "stochastic" and total != n:
            raise RuntimeError(
                f"{strategy} fit planned {total} padded rows over {n} real "
                f"ones — internal trim/_plan divergence, please report")
        if multi:
            padded = [pad_to_batches(f, batch, total // batch)
                      for f in features]
            x_pad, mask = tuple(p for p, _ in padded), padded[0][1]
        else:
            x_pad, mask = pad_to_batches(features, batch, total // batch)
        if labels is not None:
            y_pad, _ = pad_to_batches(labels, batch, total // batch)
        elif task == "lm" and not multi:
            # unsupervised sp fits consume the label slot as the attention
            # mask (token loss weights); single-input: every token weighs 1
            y_pad = np.ones((total, features.shape[1]), np.float32)
        else:
            y_pad = np.zeros((total, 1), np.float32)  # dummy; loss ignores it

        with (mesh.bind() if mesh is not None else contextlib.nullcontext()):
            return self._fit_loop(multi, n, mode, batch, num_batches, x_pad,
                                  y_pad, mask, init_params, strategy, task)

    def _report(self, it: int, loss_val: float) -> None:
        """A launched rank's post of a step's loss (rank 0's), then, when
        its caller asked for them, the caller's verdict: go on, "restore"
        the last checkpoint, or "stop"."""
        chan = self._channel
        if chan.rank == 0:
            chan.post(("loss", it, loss_val))
        if self._await_verdict:
            _kind, verdict = chan.recv("verdict")
            if verdict == "restore":
                raise _RestoreVerdict()
            if verdict == "stop":
                self._ctl_stop = True

    def _fit_loop(self, multi, n, mode, batch, num_batches, x_pad, y_pad,
                  mask, init_params, strategy, task) -> TrainResult:
        mesh = self.mesh
        chief = self._chief()
        dev = self.device
        self._ctl_stop = False
        if mesh is not None:
            from .parallel import collectives
            collectives.reset_stats()
            launches0 = _launch_counts()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        fs = _FitState(self, init_params, strategy)
        self._resumed_from = fs.start
        if fs.start:
            logger.info("resumed from checkpoint at epoch %d", fs.start)

        to_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        stats = self._step_stats  # set by fit(trace_spans=...), else None
        if stats is not None:
            # everything up to here (validation, plan, init, restore) is
            # one-time setup; charging it keeps phase sums ≈ wall time
            stats.add("setup", stats.elapsed_s())
        with (stats.phase("transfer") if stats is not None
              else contextlib.nullcontext()):
            data = (tuple(to_dev(a) for a in x_pad) if multi
                    else to_dev(x_pad))
            y_dev, mask_dev = to_dev(y_pad), to_dev(mask)
            if stats is not None:
                _sync(dev)  # the copies are charged here, not to a step
        shuffle_gen, dropout_gen = fs.gens
        loss_fn = make_loss_fn(self.model, self.input_name, self.label_name)
        step_fn, rows = None, None
        if mesh is not None:
            step_fn, rows = self._mesh_step(strategy, task, batch)
        epoch_fn = make_epoch_fn(loss_fn, self.optimizer, batch, num_batches,
                                 mode, self.shuffle_per_iter, n_real=n,
                                 step_fn=step_fn, rows=rows)
        if fs.mirror is not None:
            epoch_fn = fs.mirror.wrap(epoch_fn)
        per_epoch = num_batches * batch if mode == "stochastic" else n
        if stats is not None:
            stats.examples_per_step = per_epoch

        loss_by_it: Dict[int, torch.Tensor] = {}  # device scalars
        epoch_secs: List[float] = []
        timer = _EpochTimer(dev) if mesh is not None else None
        t0 = time.perf_counter()
        it = 0
        ran = 0
        total_epochs = self.partition_shuffles * self.iters
        # a mesh rank that fails fails the fit: its peers cannot resume
        # alone (a launched fit's caller restarts the ranks instead)
        retries_left = (self.resume_retries
                        if fs.mgr is not None and mesh is None else 0)
        guard = PreemptionGuard() if fs.mgr is not None else NullGuard()
        preempted = False
        nan_halted = False
        with guard:
            while True:
                try:
                    it = 0
                    for _round in range(self.partition_shuffles):
                        for _epoch in range(self.iters):
                            if self._stop_requested(guard):
                                # preemption (SIGTERM): save and stop; the
                                # next fit on this checkpoint_dir resumes
                                # here. During the resume skip `it` is behind
                                # the restored state: never label below it
                                at = max(it, fs.start)
                                fs.save(at)
                                logger.warning("preempted: checkpoint saved "
                                               "at epoch %d", at)
                                preempted = True
                                break
                            it += 1
                            if it <= fs.start:
                                # the restored generators were saved AFTER
                                # these epochs' draws: skip without touching
                                # them, so the stream continues exactly
                                continue
                            te = time.perf_counter()
                            if timer is not None:
                                timer.start()
                            if stats is None:
                                fs.params, fs.opt_state, losses = epoch_fn(
                                    fs.params, fs.opt_state, data, y_dev,
                                    mask_dev, shuffle_gen, dropout_gen)
                            else:
                                stats.begin_step()
                                ts0 = time.perf_counter()
                                fs.params, fs.opt_state, losses = epoch_fn(
                                    fs.params, fs.opt_state, data, y_dev,
                                    mask_dev, shuffle_gen, dropout_gen)
                                # the step phase owns its device time
                                _sync(dev)
                                ts1 = time.perf_counter()
                                stats.add("step", ts1 - ts0)
                                self._tracer.record(
                                    "train/step", ts0, ts1,
                                    parent=self._tracer.current(),
                                    args={"epoch": it})
                            if timer is not None:
                                timer.stop()
                            loss_by_it[it] = losses.mean()
                            ran += 1
                            with (stats.phase("metrics") if stats is not None
                                  else contextlib.nullcontext()):
                                if (self.halt_on_nan or self.verbose
                                        or self.loss_callback is not None
                                        or self._channel is not None):
                                    loss_val = float(loss_by_it[it])  # sync
                                    if (self.halt_on_nan
                                            and not np.isfinite(loss_val)):
                                        logger.error(
                                            "non-finite loss %r at epoch %d: "
                                            "halting (halt_on_nan=True)",
                                            loss_val, it)
                                        nan_halted = True
                                        preempted = True  # clean-stop path
                                        break
                                    if self.verbose:
                                        logger.info("iteration %d loss %f",
                                                    it, loss_val)
                                    self.metrics.scalar("train/loss",
                                                        loss_val, step=it)
                                    if self.loss_callback is not None:
                                        # reference signature: (loss,
                                        # iteration, partition_id); one
                                        # logical partition here
                                        self.loss_callback(loss_val, it, 0)
                                    if self._channel is not None:
                                        self._report(it, loss_val)
                            if self.straggler_factor:
                                self._check_straggler(it, te, loss_by_it[it],
                                                      epoch_secs)
                            if (fs.mgr is not None
                                    and self.checkpoint_every > 0
                                    and (it % self.checkpoint_every == 0
                                         or it == total_epochs)):
                                with (stats.phase("checkpoint")
                                      if stats is not None
                                      else contextlib.nullcontext()):
                                    fs.save(it)
                            if (self._publish_store is not None
                                    and self.publish_every > 0
                                    and (it % self.publish_every == 0
                                         or it == total_epochs)):
                                std_p = self._std_params(fs.params)
                                if chief:
                                    self._publish_weights(std_p)
                            if stats is not None:
                                stats.end_step()
                        if preempted:
                            break
                    break
                except (KeyboardInterrupt, SystemExit):
                    raise
                except _RestoreVerdict:
                    # the caller's callback raised: every rank restores the
                    # last checkpoint together and re-runs from there
                    start = fs.restore_latest()
                    if start is None:
                        raise RuntimeError(
                            "the caller asked this rank to restore the last "
                            "checkpoint, but checkpoint_dir holds none")
                    loss_by_it = {k: v for k, v in loss_by_it.items()
                                  if k <= start}
                    logger.warning("restored checkpoint epoch %d at the "
                                   "caller's verdict", start)
                except Exception as e:
                    # restore the last checkpoint and keep training
                    start = fs.restore_latest() if retries_left > 0 else None
                    if start is None:
                        raise
                    retries_left -= 1
                    # epochs past the restore point re-run: drop their losses
                    loss_by_it = {k: v for k, v in loss_by_it.items()
                                  if k <= start}
                    logger.warning(
                        "training failure at iteration %d (%s: %s); "
                        "auto-resumed from checkpoint epoch %d (%d retries "
                        "left)", it, type(e).__name__, e, start,
                        retries_left)
        _sync(dev)
        wall = time.perf_counter() - t0
        if stats is not None:
            # the FLOPs count runs a probe step: stop the clock first so it
            # does not inflate the fit's wall time; on a mesh each rank is
            # charged its share of the global batch's FLOPs
            stats.stop_clock()
            per_batch = self._train_flops_per_batch(
                tuple(a[:batch] for a in x_pad) if multi else x_pad[:batch],
                y_pad[:batch], fs.params if (self._zero_stage < 3
                                             and self._placement is None
                                             and self._stages is None)
                else self._std_params(fs.params))
            if per_batch and mesh is not None:
                per_batch = per_batch / mesh.size
            stats.finalize(flops_per_step=(per_batch * num_batches
                                           if per_batch else None))
        if mesh is not None:
            self.last_mesh_stats = self._rank_stats(
                strategy, fs.opt_state, fs.params, num_batches * ran, timer,
                launches0)
        self.params, self._last_opt_state = fs.finish()
        epoch_keys = sorted(loss_by_it)
        self._epoch_keys = epoch_keys
        epoch_losses = [float(loss_by_it[k]) for k in epoch_keys]
        if not nan_halted:  # the halt already logged its own ERROR
            bad = [k for k, v in zip(epoch_keys, epoch_losses)
                   if not np.isfinite(v)]
            if bad:
                logger.warning("training diverged: non-finite loss at "
                               "epoch(s) %s", bad[:5])
        stop = ("nan" if nan_halted
                else "preempted" if preempted else "completed")
        # publish-at-end mode (publish_every == 0): the fit's final weights
        # become the next served version — but never NaN-halted ones
        if (self._publish_store is not None and self.publish_every <= 0
                and not nan_halted and chief):
            self._publish_weights(self.params)
        return TrainResult(self.params, epoch_losses,
                           per_epoch * ran / max(wall, 1e-9), wall,
                           stop_reason=stop)

    def _fit_elastic(self, features, labels, init_params,
                     multi: bool) -> TrainResult:
        """strategy='elastic_dp': train through
        :class:`~.parallel.elastic.ElasticDPEngine` — N replica threads over
        round-robin data shards, exchanging gradients through the
        bounded-staleness versioned store instead of a synchronous step.
        Reference semantics: the per-replica batch is ``mini_batch_size``
        and each replica makes ``iters`` passes over its shard per shuffle
        round, like the reference's per-partition workers."""
        if multi:
            raise ValueError(
                "strategy='elastic_dp' supports single-input models only "
                "(multi-input gradient exchange is not implemented); use "
                "the sync path")
        if self.checkpoint_dir:
            logger.warning(
                "strategy='elastic_dp' ignores checkpoint_dir: the async "
                "store has no epoch boundary to checkpoint at (resume "
                "support is a sync-path feature)")
        from .parallel.elastic import ElasticDPEngine

        n = features.shape[0]
        replicas = int(self.elastic.get("replicas", 4))
        if replicas < 1:
            raise ValueError(f"elastic replicas must be >= 1, got {replicas}")
        replicas = min(replicas, n)  # every replica needs at least one row
        if init_params is None:
            init_params = self.model.init(seed=self.seed)
        params = tree_map(
            lambda a: (a.detach() if torch.is_tensor(a)
                       else torch.as_tensor(np.asarray(a))).to(
                self.device, torch.float32), init_params)
        # engine calls back as (loss, replica_step, replica_index) — the
        # same shape as the sync path's (loss, iteration, partition_id)
        engine = ElasticDPEngine(
            make_loss_fn(self.model, self.input_name, self.label_name),
            self.optimizer, params,
            max_staleness=int(self.elastic.get("max_staleness", 4)),
            dampening=self.elastic.get("dampening", "inverse"),
            density_threshold=self.elastic.get("density_threshold", 0.25),
            lease_ttl_s=float(self.elastic.get("lease_ttl_s", 10.0)),
            metrics=self.metrics, loss_callback=self.loss_callback,
            publish_to=self._publish_store, publish_every=self.publish_every)
        shards = [(features[i::replicas],
                   labels[i::replicas] if labels is not None else None)
                  for i in range(replicas)]
        # mini_batch_size <= 0 means full-batch (the sync planner's 'full'
        # mode); per replica that is its whole shard per step
        bs = self.mini_batch_size
        if bs is None or bs <= 0:
            bs = n
        epochs = max(1, self.iters) * self.partition_shuffles
        result = engine.run_threads(shards, epochs=epochs, batch_size=bs,
                                    seed=self.seed)
        self.params = self.model.load_params(result.params)
        self._last_opt_state = result.opt_state
        self.last_elastic_stats = result.stats
        if self.verbose:
            logger.info(
                "elastic fit: %d replicas, %d accepted / %d rejected-stale "
                "/ %d dropped pushes, final version %d",
                replicas, result.stats["accepted"],
                result.stats["rejected_stale"],
                result.stats["dropped_stale"] + result.stats["dropped_fault"],
                result.version)
        if self._publish_store is not None and self.publish_every <= 0:
            self._publish_weights(self.params)
        return TrainResult(self.params, result.losses,
                           result.examples_per_sec, result.wall_s,
                           stop_reason="completed")

    def _train_flops_per_batch(self, x, y, params) -> Optional[float]:
        """Model FLOPs of one optimizer step on the batch ``x``: the analytic
        count for a registry transformer (its attention runs in a kernel
        that no counter sees; an MoE LM's expert layers priced as the slot
        dispatch runs them), else one step counted by
        :func:`~sparkflow_tpu_torch.utils.flops.train_step_flops`."""
        from .models.moe import MoETransformerLM
        from .models.transformer import TransformerLM, _TransformerBase
        from .utils.flops import (moe_train_step_flops, train_step_flops,
                                  transformer_train_step_flops)
        m = self.model
        if isinstance(m, MoETransformerLM):
            ids = x[0] if isinstance(x, tuple) else x
            return moe_train_step_flops(
                ids.shape[0], ids.shape[1], m.hidden, m.num_layers,
                m.mlp_dim, m.num_experts, m.moe_every, m.capacity_factor,
                m.router_top_k, vocab_size=m.vocab_size, causal=True)
        if isinstance(m, _TransformerBase):
            ids = x[0] if isinstance(x, tuple) else x
            lm = isinstance(m, TransformerLM)
            return transformer_train_step_flops(
                ids.shape[0], ids.shape[1], m.hidden, m.num_layers,
                m.mlp_dim, vocab_size=m.vocab_size if lm else 0,
                num_classes=0 if lm else m.num_classes, causal=lm)
        return train_step_flops(m, self.input_name, self.label_name,
                                self.optimizer, x, y, params=params)

    def _publish_weights(self, params) -> None:
        """Best-effort push of standard-layout weights to the configured
        :class:`~.serving.weightstore.WeightStore`. A failed publication
        logs and moves on — it must never fail training, and serving
        replicas keep last-good weights regardless."""
        try:
            v = self._publish_store.publish(params)
            logger.info("trainer: published weights as version %d", v)
        except Exception:  # noqa: BLE001 - publication never fails a fit
            logger.exception("trainer: live weight publication failed")

    def _check_straggler(self, it: int, te: float, loss: torch.Tensor,
                         epoch_secs: List[float]) -> None:
        """Opt-in heartbeat: an epoch slower than ``straggler_factor`` x the
        running median warns and calls ``straggler_callback``."""
        float(loss)  # wait for the epoch's work
        secs = time.perf_counter() - te
        if len(epoch_secs) >= 3:
            med = float(np.median(epoch_secs))
            if secs > self.straggler_factor * med:
                logger.warning("straggling epoch %d: %.3fs vs median %.3fs",
                               it, secs, med)
                self.metrics.scalar("train/straggler_secs", secs, step=it)
                if self.straggler_callback is not None:
                    self.straggler_callback(it, secs, med)
        epoch_secs.append(secs)

    # -- streaming fit ------------------------------------------------------

    def fit_stream(self, row_iterator, init_params=None,
                   queue_capacity: int = 8, chunk: int = 1024,
                   epochs: int = 1) -> TrainResult:
        """Streaming fit for datasets that don't fit in device memory.

        ``row_iterator`` yields ``(features, label)`` pairs (bare features
        when unsupervised), or is a zero-arg callable returning a fresh such
        iterator (required when ``epochs > 1`` — streams are single-pass, so
        each epoch re-pulls the source, matching Spark's
        ``rdd.toLocalIterator``). Optimizer state, the generators and the
        loss history carry across epochs.

        Multi-input models (``input_name`` a sequence) stream too: each
        row's features travel as a TUPLE of vectors, ride the batch ring
        concatenated into one flat row, and are split back into per-input
        arrays before the step.

        A native C++ batch-assembly thread (numpy fallback) pads, masks and
        shuffles fixed-shape batches while the card computes; each batch is
        one optimizer step. With a ``checkpoint_dir`` the state is saved
        every ``checkpoint_every`` STEPS, a restart restores it and
        continues on the incoming stream (streams cannot rewind, so rows
        already consumed are not replayed), and SIGTERM saves and stops.
        ``TrainResult.losses`` holds one loss per step.

        On a dp mesh (``pp`` and ``sp`` are refused, as in JAX) the batch
        rounds up to a multiple of the ranks and each rank steps on its
        block of every global batch at the resolved zero stage. Launched
        (outside a process group) the stream is read here and each rank
        gets its rows over its line, at most ``queue_capacity`` batches
        ahead; in place every rank reads the same stream.
        """
        with self._recompile_scope():
            return self._fit_stream_impl(row_iterator, init_params,
                                         queue_capacity, chunk, epochs)

    def _fit_stream_impl(self, row_iterator, init_params, queue_capacity,
                         chunk, epochs) -> TrainResult:
        if epochs > 1 and not callable(row_iterator):
            raise ValueError("epochs > 1 needs a callable iterator factory "
                             "(streams are single-pass)")
        bs = (self.mini_batch_size if self.mini_batch_size
              and self.mini_batch_size > 0 else 128)
        mesh = self.mesh
        if mesh is None:
            return self._stream_loop(self._stream_events(
                row_iterator, epochs, queue_capacity, chunk, bs),
                init_params, bs, rows=None)
        if self._mesh_strategy() != "default":
            raise ValueError(
                "fit_stream trains dp/tp/fsdp/ep meshes; pp/sp strategy "
                "fits need the whole dataset staged for their fixed-shape "
                "batch schedules — use fit() (fitMode='collect')")
        count = self._batch_ranks()
        bs = -(-bs // count) * count
        # the placement and zero-stage errors a fit raises, before any rank
        # starts
        self._pspecs = self._resolve_pspecs()
        self._resolve_zero_stage("default", None)
        if not _in_group():
            return self._fit_stream_launched(row_iterator, init_params,
                                             queue_capacity, chunk, epochs,
                                             bs)
        from .parallel.collectives import axis_index
        axes = self._batch_axes()
        with mesh.bind():
            return self._stream_loop(self._stream_events(
                row_iterator, epochs, queue_capacity, chunk, bs),
                init_params, bs, rows=(axis_index(axes), count))

    def _stream_events(self, row_iterator, epochs: int, queue_capacity: int,
                       chunk: int, bs: int):
        """The stream as one process reads it: ``("epoch", e)`` before each
        pass, then ``("batch", x, y, mask, n_real)`` for each global batch
        the native ring assembles (``x`` a tuple of per-input arrays for a
        multi-input model, ``y`` None when unsupervised)."""
        from .localml.linalg import vector_to_array
        from .utils.data import BatchQueue, feed_from_iterator
        multi = isinstance(self.input_name, (list, tuple))
        factory = row_iterator if callable(row_iterator) else None
        supervised = self.label_name is not None
        for epoch in range(max(1, epochs)):
            yield ("epoch", epoch)
            it = iter(factory() if factory else row_iterator)
            try:
                first = next(it)
            except StopIteration:
                raise ValueError("no training data") from None
            raw0 = first[0] if supervised else first
            split_at = None
            if multi:
                if (not isinstance(raw0, tuple)
                        or len(raw0) != len(self.input_name)):
                    got = (f"a tuple of {len(raw0)}"
                           if isinstance(raw0, tuple) else "a single vector")
                    raise ValueError(
                        f"model takes {len(self.input_name)} input tensors "
                        f"({self.input_name}) but the stream yields {got} "
                        f"per row")
                part_dims = [int(vector_to_array(p).shape[0]) for p in raw0]
                split_at = list(np.cumsum(part_dims))[:-1]
                row_dim = int(sum(part_dims))
            else:
                row_dim = int(vector_to_array(raw0).shape[0])
            if supervised:
                lbl0 = first[1]
                label_dim = (1 if isinstance(lbl0, (int, float))
                             else len(vector_to_array(lbl0)))
            else:
                label_dim = 0
            q = BatchQueue(bs, row_dim, label_dim, capacity=queue_capacity,
                           shuffle=self.shuffle_per_iter,
                           seed=self.seed + epoch)
            feeder = feed_from_iterator(q, itertools.chain([first], it),
                                        supervised, chunk)
            try:
                for x, y, mask, n_real in q:
                    if multi:
                        # split the concatenated ring row back into the
                        # per-input arrays the loss feeds by name
                        x = tuple(np.ascontiguousarray(part)
                                  for part in np.split(x, split_at, axis=1))
                    yield ("batch", x, y if supervised else None, mask,
                           n_real)
                feeder.join()
            finally:
                # always tear the queue down: drains and unblocks the
                # feeder, frees the native ring
                q.close()

    def _stream_loop(self, events, init_params, bs: int,
                     rows) -> TrainResult:
        """The steps of a streaming fit over ``events`` (see
        :meth:`_stream_events`; a launched rank's come from its caller:
        its own rows, and ``("stop",)`` for a preemption there). ``rows =
        (index, count)`` keeps block ``index`` of each global batch (an
        in-place mesh rank); None feeds the batch as it comes."""
        from .parallel.distributed import local_rows
        mesh = self.mesh
        dev = self.device
        self._ctl_stop = False
        if mesh is not None:
            # a launched rank enters here, not through fit_stream
            self._pspecs = self._resolve_pspecs()
            from .parallel import collectives
            collectives.reset_stats()
            launches0 = _launch_counts()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        fs = _FitState(self, init_params, "default")
        self._resumed_from = fs.start
        if fs.start:
            logger.info("fit_stream resumed weights from step %d", fs.start)
        if mesh is not None:
            step = self._mesh_step("default", None, bs)[0]
        else:
            step = make_train_step(make_loss_fn(
                self.model, self.input_name, self.label_name), self.optimizer)
        if fs.mirror is not None:
            step = fs.mirror.wrap(step)
        dropout_gen = fs.gens[1]
        timer = _EpochTimer(dev) if mesh is not None else None
        to_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        losses: List[torch.Tensor] = []
        seen = 0
        nan_halted = False
        stopped = False
        it_count = fs.start
        t0 = time.perf_counter()
        guard = PreemptionGuard() if fs.mgr is not None else NullGuard()
        with guard:
            for ev in events:
                if ev[0] == "stop":
                    self._ctl_stop = True
                if self._stop_requested(guard):
                    # preemption: persist and stop; rows not yet consumed
                    # are not replayed
                    if fs.mgr is not None:
                        fs.save(it_count)
                    logger.warning("preempted: stopping stream at step %d",
                                   it_count)
                    stopped = True
                    break
                if ev[0] != "batch":
                    continue
                _, x, y, mask, n_real = ev
                if rows is not None:
                    x = (tuple(local_rows(a, *rows) for a in x)
                         if isinstance(x, tuple) else local_rows(x, *rows))
                    y = None if y is None else local_rows(y, *rows)
                    mask = local_rows(mask, *rows)
                xd = (tuple(to_dev(a) for a in x) if isinstance(x, tuple)
                      else to_dev(x))
                yd = (to_dev(y) if y is not None
                      else torch.zeros((mask.shape[0], 1), device=dev))
                if timer is not None:
                    timer.start()
                fs.params, fs.opt_state, loss = step(
                    fs.params, fs.opt_state, xd, yd, to_dev(mask),
                    dropout_gen)
                if timer is not None:
                    timer.stop()
                losses.append(loss)
                seen += n_real
                it_count += 1
                # opt-in: a per-step host sync
                if self.halt_on_nan and not np.isfinite(float(loss)):
                    logger.error("non-finite loss at stream step %d: "
                                 "halting (halt_on_nan=True)", it_count)
                    nan_halted = True
                    break
                if self.loss_callback is not None:
                    self.loss_callback(float(loss), it_count, 0)
                if self._channel is not None:
                    self._report(it_count, float(loss))
                if (fs.mgr is not None and self.checkpoint_every > 0
                        and it_count % self.checkpoint_every == 0):
                    fs.save(it_count)
        events.close()
        _sync(dev)
        wall = time.perf_counter() - t0
        if mesh is not None:
            self.last_mesh_stats = self._rank_stats(
                "default", fs.opt_state, fs.params, len(losses), timer,
                launches0)
        self.params, self._last_opt_state = fs.finish()
        step_losses = [float(v) for v in losses]
        self._epoch_keys = list(range(fs.start + 1,
                                      fs.start + 1 + len(step_losses)))
        if not nan_halted:
            bad = [i + fs.start + 1 for i, v in enumerate(step_losses)
                   if not np.isfinite(v)]
            if bad:
                logger.warning("training diverged: non-finite loss at stream "
                               "step(s) %s", bad[:5])
        stop = ("nan" if nan_halted
                else "preempted" if stopped or guard.requested
                else "completed")
        return TrainResult(self.params, step_losses, seen / max(wall, 1e-9),
                           wall, stop_reason=stop)

    def _fit_stream_launched(self, row_iterator, init_params,
                             queue_capacity: int, chunk: int, epochs: int,
                             bs: int) -> TrainResult:
        """A streaming mesh fit outside a process group: the stream is read
        here (a Spark ``toLocalIterator`` cannot travel to a rank), each
        global batch assembled as one process would, and each rank sent
        its own rows — at most ``queue_capacity`` batches ahead of rank 0's
        steps. Rank 0 posts each step's loss; ``loss_callback`` runs here
        on it, and the ranks then wait for the verdict. A SIGTERM here
        (with a ``checkpoint_dir``) sends "stop", which each rank takes
        ahead of the batches it has queued: the ranks stop at their next
        step, and rank 0 saves."""
        from .parallel.distributed import RankPool, local_rows
        verdicts = self.loss_callback is not None
        recipe = self._launch_recipe(verdicts)
        init_params = _host_tree(init_params)
        axes = self._batch_axes()
        count = self._batch_ranks()
        blocks = [self.mesh.axis_index(axes, rank=r) if axes else 0
                  for r in range(self.mesh.size)]
        guard = (PreemptionGuard() if self.checkpoint_dir else NullGuard())
        acked = [0]

        def on_post(_rank, msg):
            _kind, it, loss_val = msg
            acked[0] += 1
            self._live_loss(it, loss_val)
            if verdicts:
                pool.broadcast(("verdict",
                                "stop" if guard.requested else "go"))

        def rows(a, r):
            if a is None:
                return None
            if isinstance(a, tuple):
                return tuple(rows(p, r) for p in a)
            return local_rows(a, blocks[r], count)

        t0 = time.perf_counter()
        sent = 0
        events = self._stream_events(row_iterator, epochs, queue_capacity,
                                     chunk, bs)
        try:
            # the first batch before any rank starts: an empty or malformed
            # stream fails here
            head = []
            for ev in events:
                head.append(ev)
                if ev[0] == "batch":
                    break
            with guard, RankPool(self.mesh.size, device=self.device.type,
                                 backend=self.backend) as pool:
                pool.start(_mesh_stream_rank, recipe, init_params, bs)
                for ev in itertools.chain(head, events):
                    if pool.done():
                        break        # the ranks stopped (halt_on_nan)
                    if guard.requested:
                        pool.broadcast(("stop",))
                        break
                    if ev[0] != "batch":
                        pool.broadcast(ev)      # an epoch boundary
                        continue
                    _, x, y, mask, n_real = ev
                    for r in range(self.mesh.size):
                        pool.send(r, ("batch", rows(x, r), rows(y, r),
                                      rows(mask, r), n_real))
                    sent += 1
                    while True:
                        got = pool.poll(
                            0.0 if sent - acked[0] < queue_capacity else 1.0)
                        if got is not None:
                            on_post(*got)
                        elif (sent - acked[0] < queue_capacity
                              or pool.done()):
                            break
                events.close()      # the producer stops pulling rows
                pool.broadcast(("end",))
                results = pool.finish(timeout_s=math.inf, on_post=on_post)
        finally:
            events.close()
        wall = time.perf_counter() - t0
        r0 = self._take_launched(results)
        self._epoch_keys = r0["epochs"]
        return TrainResult(self.params, r0["losses"], r0["examples_per_sec"],
                           wall, stop_reason=r0["stop_reason"])

    # -- conveniences -------------------------------------------------------

    def ema_weights(self):
        """The debiased Polyak-averaged weight tree of the last fit when the
        optimizer was built with ``ema_decay``; None otherwise."""
        if self._launch_ema is not None:
            return self._launch_ema
        if self._last_opt_state is None:
            return None
        return extract_ema_params(self._last_opt_state)

    def weights_list(self) -> List[np.ndarray]:
        """Final weights as a flat float32 array list (the wire format)."""
        if self.params is None:
            raise RuntimeError("fit() has not been run")
        return params_to_list(self.model, self.params)

    def predict_fn(self, output_name: str, dropout_value: float = 1.0,
                   mesh=None) -> Callable:
        """``predict(params, x)``; ``mesh=`` opts into dp-sharded batch
        inference in this process (one parameter copy per dp shard, see
        :mod:`.parallel.mesh`; batches of any size pad up to a dp multiple
        and trim), as JAX's ``predict_fn(mesh=)``."""
        return make_predict_fn(self.model, self.input_name, output_name,
                               self.dropout_name, dropout_value, mesh=mesh,
                               sharding=self.sharding)
