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

Not ported yet, and rejected with "not yet ported (see ROADMAP.md)": a
device mesh (``mesh``, ``sharding``, ``param_sharding`` other than
``"auto"``, ``pp_*``, ``weight_update_sharding``) and
``strategy="elastic_dp"``. ``debug_recompiles`` has no counterpart: PyTorch
runs eagerly, so there are no traces or compiles to count.
``graph`` is a registry spec, an ``nn`` graph-DSL spec, a
:class:`~.graphdef.GraphDef` or a model object. ``jax.random`` streams
cannot be repeated in PyTorch: shuffles and dropout come from
``torch.Generator`` s seeded from ``seed``, so a fit repeats within the
port, not across the two packages.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
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
from .optimizers import (GradientTransformation, build_optimizer,
                         extract_ema_params, tree_map)
from .utils.metrics import default_metrics
from .utils.preempt import NullGuard, PreemptionGuard

logger = logging.getLogger("sparkflow_tpu_torch")

# the name of this package's random stream in a checkpoint's ``rng_impl``
# (the JAX package writes its jax.random implementation's, e.g. "threefry")
RNG_IMPL = "torch"


def _not_yet(what: str):
    raise NotImplementedError(f"{what} is not yet ported to PyTorch (see "
                              f"ROADMAP.md)")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
                 device=None):
        if mesh is not None or sharding is not None:
            _not_yet("training on a device mesh (mesh=, sharding=)")
        if param_sharding != "auto" or weight_update_sharding != "auto":
            _not_yet("sharded parameters and ZeRO weight-update sharding")
        if pp_microbatches is not None or pp_schedule != "gpipe":
            _not_yet("pipeline-parallel training (pp_microbatches, "
                     "pp_schedule)")
        if strategy not in (None, "sync", "elastic_dp"):
            raise ValueError(f"strategy must be None, 'sync', or "
                             f"'elastic_dp'; got {strategy!r}")
        if strategy == "elastic_dp" or elastic:
            _not_yet("strategy='elastic_dp'")
        if debug_recompiles:
            raise ValueError(
                "debug_recompiles counts the JAX package's traces and XLA "
                "compiles of the train step; PyTorch runs the step eagerly "
                "and traces and compiles nothing, so there is nothing to "
                "count")
        if rng_impl is not None:
            raise ValueError("rng_impl names a jax.random implementation; the "
                             "port draws from torch.Generator")
        if isinstance(graph, GraphDef):
            self.model = GraphModel(graph, compute_dtype, device=device)
        elif isinstance(graph, str):
            from .models import model_from_json
            self.model = model_from_json(graph, compute_dtype, device=device)
        elif isinstance(graph, (RegistryModel, GraphModel)):
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
        else:
            self.optimizer = optimizer
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
        batching modes — the JAX trainer's rule on one device."""
        dp = 1
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
                "opt_state": _tree_zip(lambda leaf, _same: _state_to_ckpt(
                    leaf), opt_state, opt_state),
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
        params = self.model.load_params(tree_map(
            lambda a: torch.as_tensor(np.asarray(a)).to(
                self.device, torch.float32, copy=True), state["params"]),
            trainable=True)
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
        state = mgr.restore(like=like)
        if state is None:
            return mgr, like, None
        return mgr, like, self._restore(state, like, gens)

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
        self.last_step_stats = stats._summary
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

        mode, batch, num_batches = self._plan(n)
        total = -(-n // batch) * batch
        if multi:
            padded = [pad_to_batches(f, batch, total // batch)
                      for f in features]
            x_pad, mask = tuple(p for p, _ in padded), padded[0][1]
        else:
            x_pad, mask = pad_to_batches(features, batch, total // batch)
        if labels is not None:
            y_pad, _ = pad_to_batches(labels, batch, total // batch)
        else:
            y_pad = np.zeros((total, 1), np.float32)  # dummy; loss ignores it

        params = self._initial_params(init_params)
        opt_state = self.optimizer.init(params)
        gens = self._generators()
        ckpt_mgr, ckpt_like, restored = self._open_checkpoints(
            params, opt_state, gens)
        start_epoch = 0
        if restored is not None:
            params, opt_state, start_epoch = restored
            logger.info("resumed from checkpoint at epoch %d", start_epoch)

        dev = self.device
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
        shuffle_gen, dropout_gen = gens
        loss_fn = make_loss_fn(self.model, self.input_name, self.label_name)
        epoch_fn = make_epoch_fn(loss_fn, self.optimizer, batch, num_batches,
                                 mode, self.shuffle_per_iter, n_real=n)
        per_epoch = num_batches * batch if mode == "stochastic" else n
        if stats is not None:
            stats.examples_per_step = per_epoch

        loss_by_it: Dict[int, torch.Tensor] = {}  # device scalars
        epoch_secs: List[float] = []
        t0 = time.perf_counter()
        it = 0
        ran = 0
        total_epochs = self.partition_shuffles * self.iters
        retries_left = self.resume_retries if ckpt_mgr is not None else 0
        guard = PreemptionGuard() if ckpt_mgr is not None else NullGuard()
        preempted = False
        nan_halted = False
        with guard:
            while True:
                try:
                    it = 0
                    for _round in range(self.partition_shuffles):
                        for _epoch in range(self.iters):
                            if guard.requested:
                                # preemption (SIGTERM): save and stop; the
                                # next fit on this checkpoint_dir resumes
                                # here. During the resume skip `it` is behind
                                # the restored state: never label below it
                                at = max(it, start_epoch)
                                ckpt_mgr.save(at, self._ckpt_state(
                                    params, opt_state, at, gens))
                                logger.warning("preempted: checkpoint saved "
                                               "at epoch %d", at)
                                preempted = True
                                break
                            it += 1
                            if it <= start_epoch:
                                # the restored generators were saved AFTER
                                # these epochs' draws: skip without touching
                                # them, so the stream continues exactly
                                continue
                            te = time.perf_counter()
                            if stats is None:
                                params, opt_state, losses = epoch_fn(
                                    params, opt_state, data, y_dev, mask_dev,
                                    shuffle_gen, dropout_gen)
                            else:
                                stats.begin_step()
                                ts0 = time.perf_counter()
                                params, opt_state, losses = epoch_fn(
                                    params, opt_state, data, y_dev, mask_dev,
                                    shuffle_gen, dropout_gen)
                                # the step phase owns its device time
                                _sync(dev)
                                ts1 = time.perf_counter()
                                stats.add("step", ts1 - ts0)
                                self._tracer.record(
                                    "train/step", ts0, ts1,
                                    parent=self._tracer.current(),
                                    args={"epoch": it})
                            loss_by_it[it] = losses.mean()
                            ran += 1
                            with (stats.phase("metrics") if stats is not None
                                  else contextlib.nullcontext()):
                                if (self.halt_on_nan or self.verbose
                                        or self.loss_callback is not None):
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
                            if self.straggler_factor:
                                self._check_straggler(it, te, loss_by_it[it],
                                                      epoch_secs)
                            if (ckpt_mgr is not None
                                    and self.checkpoint_every > 0
                                    and (it % self.checkpoint_every == 0
                                         or it == total_epochs)):
                                with (stats.phase("checkpoint")
                                      if stats is not None
                                      else contextlib.nullcontext()):
                                    ckpt_mgr.save(it, self._ckpt_state(
                                        params, opt_state, it, gens))
                            if (self._publish_store is not None
                                    and self.publish_every > 0
                                    and (it % self.publish_every == 0
                                         or it == total_epochs)):
                                self._publish_weights(params)
                            if stats is not None:
                                stats.end_step()
                        if preempted:
                            break
                    break
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    # restore the last checkpoint and keep training
                    state = (ckpt_mgr.restore(like=ckpt_like)
                             if retries_left > 0 else None)
                    if state is None:
                        raise
                    retries_left -= 1
                    params, opt_state, start_epoch = self._restore(
                        state, ckpt_like, gens)
                    # epochs past the restore point re-run: drop their losses
                    loss_by_it = {k: v for k, v in loss_by_it.items()
                                  if k <= start_epoch}
                    logger.warning(
                        "training failure at iteration %d (%s: %s); "
                        "auto-resumed from checkpoint epoch %d (%d retries "
                        "left)", it, type(e).__name__, e, start_epoch,
                        retries_left)
        _sync(dev)
        wall = time.perf_counter() - t0
        if stats is not None:
            # the FLOPs count runs a probe step: stop the clock first so it
            # does not inflate the fit's wall time
            stats.stop_clock()
            per_batch = self._train_flops_per_batch(
                tuple(a[:batch] for a in x_pad) if multi else x_pad[:batch],
                y_pad[:batch], params)
            stats.finalize(flops_per_step=(per_batch * num_batches
                                           if per_batch else None))
        self.params = tree_map(lambda p: p.detach(), params)
        self._last_opt_state = opt_state
        epoch_keys = sorted(loss_by_it)
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
                and not nan_halted):
            self._publish_weights(self.params)
        return TrainResult(self.params, epoch_losses,
                           per_epoch * ran / max(wall, 1e-9), wall,
                           stop_reason=stop)

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
        """
        from .localml.linalg import vector_to_array
        from .utils.data import BatchQueue, feed_from_iterator

        multi = isinstance(self.input_name, (list, tuple))
        factory = row_iterator if callable(row_iterator) else None
        if epochs > 1 and factory is None:
            raise ValueError("epochs > 1 needs a callable iterator factory "
                             "(streams are single-pass)")
        supervised = self.label_name is not None
        bs = (self.mini_batch_size if self.mini_batch_size
              and self.mini_batch_size > 0 else 128)

        params = self._initial_params(init_params)
        opt_state = self.optimizer.init(params)
        gens = self._generators()
        dropout_gen = gens[1]
        step = make_train_step(make_loss_fn(self.model, self.input_name,
                                            self.label_name), self.optimizer)
        ckpt_mgr, _like, restored = self._open_checkpoints(params, opt_state,
                                                           gens)
        start_step = 0
        if restored is not None:
            params, opt_state, start_step = restored
            logger.info("fit_stream resumed weights from step %d", start_step)

        dev = self.device
        losses: List[torch.Tensor] = []
        seen = 0
        nan_halted = False
        it_count = start_step
        t0 = time.perf_counter()
        dummy_y = torch.zeros((bs, 1), device=dev)
        guard = PreemptionGuard() if ckpt_mgr is not None else NullGuard()
        preempt_saved = False

        def save():
            ckpt_mgr.save(it_count, self._ckpt_state(params, opt_state,
                                                     it_count, gens))

        with guard:
            for epoch in range(max(1, epochs)):
                if guard.requested:
                    # the signal landed between epochs: persist, then stop
                    if ckpt_mgr is not None and not preempt_saved:
                        save()
                        logger.warning("preempted: checkpoint saved at "
                                       "stream step %d", it_count)
                    break
                it = iter(factory() if factory else row_iterator)
                try:
                    first = next(it)
                except StopIteration:
                    raise ValueError("no training data") from None
                raw0 = first[0] if supervised else first
                if multi:
                    if (not isinstance(raw0, tuple)
                            or len(raw0) != len(self.input_name)):
                        got = (f"a tuple of {len(raw0)}"
                               if isinstance(raw0, tuple)
                               else "a single vector")
                        raise ValueError(
                            f"model takes {len(self.input_name)} input "
                            f"tensors ({self.input_name}) but the stream "
                            f"yields {got} per row")
                    part_dims = [int(vector_to_array(p).shape[0])
                                 for p in raw0]
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

                q = BatchQueue(bs, row_dim, label_dim,
                               capacity=queue_capacity,
                               shuffle=self.shuffle_per_iter,
                               seed=self.seed + epoch)
                feeder = feed_from_iterator(q, itertools.chain([first], it),
                                            supervised, chunk)
                try:
                    for x, y, mask, n_real in q:
                        if guard.requested:
                            # preemption: persist and stop; rows not yet
                            # consumed are not replayed
                            if ckpt_mgr is not None:
                                save()
                                preempt_saved = True
                            logger.warning("preempted: stopping stream at "
                                           "step %d", it_count)
                            # unblock the producer before joining it
                            q.close()
                            break
                        if multi:
                            # split the concatenated ring row back into the
                            # per-input arrays the loss feeds by name
                            xd = tuple(torch.as_tensor(np.ascontiguousarray(
                                part), device=dev)
                                for part in np.split(x, split_at, axis=1))
                        else:
                            xd = torch.as_tensor(x, device=dev)
                        yd = (torch.as_tensor(y, device=dev) if supervised
                              else dummy_y)
                        params, opt_state, loss = step(
                            params, opt_state, xd, yd,
                            torch.as_tensor(mask, device=dev), dropout_gen)
                        losses.append(loss)
                        seen += n_real
                        it_count += 1
                        # opt-in: a per-step host sync
                        if self.halt_on_nan and not np.isfinite(float(loss)):
                            logger.error("non-finite loss at stream step %d: "
                                         "halting (halt_on_nan=True)",
                                         it_count)
                            nan_halted = True
                            q.close()
                            break
                        if self.loss_callback is not None:
                            self.loss_callback(float(loss), it_count, 0)
                        if (ckpt_mgr is not None and self.checkpoint_every > 0
                                and it_count % self.checkpoint_every == 0):
                            save()
                    feeder.join()
                    if nan_halted:
                        break
                finally:
                    # always tear the queue down: drains and unblocks the
                    # feeder, frees the native ring
                    q.close()
        _sync(dev)
        wall = time.perf_counter() - t0
        self.params = tree_map(lambda p: p.detach(), params)
        self._last_opt_state = opt_state
        step_losses = [float(v) for v in losses]
        if not nan_halted:
            bad = [i + start_step + 1 for i, v in enumerate(step_losses)
                   if not np.isfinite(v)]
            if bad:
                logger.warning("training diverged: non-finite loss at stream "
                               "step(s) %s", bad[:5])
        stop = ("nan" if nan_halted
                else "preempted" if guard.requested else "completed")
        return TrainResult(self.params, step_losses, seen / max(wall, 1e-9),
                           wall, stop_reason=stop)

    # -- conveniences -------------------------------------------------------

    def ema_weights(self):
        """The debiased Polyak-averaged weight tree of the last fit when the
        optimizer was built with ``ema_decay``; None otherwise."""
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
        if mesh is not None:
            _not_yet("predicting on a device mesh (mesh=)")
        return make_predict_fn(self.model, self.input_name, output_name,
                               self.dropout_name, dropout_value)
