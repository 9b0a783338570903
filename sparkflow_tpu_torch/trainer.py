"""Synchronous single-card trainer — the port of the JAX package's
``trainer.py`` (its one-device loop path).

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

Live weight publication: ``publish_to`` (a
:class:`~.serving.weightstore.WeightStore` or its directory) receives the
weights after every ``publish_every``-th epoch and after the last, or once
at the end of the fit with ``publish_every=0`` (never after a NaN halt).
Publication is best-effort: a failure is logged and never fails training.

Not ported yet, and rejected with "not yet ported (see ROADMAP.md)": a
device mesh (``mesh``, ``sharding``, ``param_sharding`` other than
``"auto"``, ``pp_*``, ``weight_update_sharding``), ``strategy="elastic_dp"``,
``checkpoint_dir`` (checkpointing the training state is queue 1 item 2),
``fit_stream``, ``trace_spans`` and ``debug_recompiles``.
``graph`` is a registry spec, an ``nn`` graph-DSL spec, a
:class:`~.graphdef.GraphDef` or a model object. ``jax.random`` streams
cannot be repeated in PyTorch: shuffles and dropout come from
``torch.Generator`` s seeded from ``seed``, so a fit repeats within the
port, not across the two packages.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .convert import params_to_list
from .core import make_epoch_fn, make_loss_fn, make_predict_fn, pad_to_batches
from .graphdef import GraphDef, GraphModel
from .models.base import RegistryModel
from .optimizers import (GradientTransformation, build_optimizer,
                         extract_ema_params, tree_map)
from .utils.metrics import default_metrics

logger = logging.getLogger("sparkflow_tpu_torch")


def _not_yet(what: str):
    raise NotImplementedError(f"{what} is not yet ported to PyTorch (see "
                              f"ROADMAP.md)")


class TrainResult:
    """Outcome of a fit: final params + per-epoch mean losses.
    ``stop_reason`` is ``'completed'`` or ``'nan'`` (``halt_on_nan``)."""

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
    (see the module docstring for those not ported yet)."""

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
        if checkpoint_dir is not None:
            _not_yet("checkpoint_dir (checkpointing the training state)")
        if debug_recompiles:
            _not_yet("debug_recompiles")
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

    # -- fit ----------------------------------------------------------------

    def fit(self, features, labels: Optional[np.ndarray] = None,
            init_params=None, *, trace_spans=False,
            trace_dir: Optional[str] = None) -> TrainResult:
        """Train; ``features`` is an array (or a tuple of arrays for a
        multi-input model) of rows — token ids may come as floats, as the
        estimator hands them over. ``labels`` is None for the LM.
        ``init_params`` is a params tree (copied) to start from instead of
        ``model.init(seed=seed)``."""
        if trace_spans:
            _not_yet("trace_spans")
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

        if init_params is None:
            init_params = self.model.init(seed=self.seed)
        # a float32 copy on the card: the optimizer updates it in place
        params = self.model.load_params(tree_map(
            lambda a: (a.detach() if torch.is_tensor(a)
                       else torch.as_tensor(np.asarray(a))).to(
                self.device, torch.float32, copy=True), init_params),
            trainable=True)
        opt_state = self.optimizer.init(params)

        dev = self.device
        to_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        data = tuple(to_dev(a) for a in x_pad) if multi else to_dev(x_pad)
        y_dev, mask_dev = to_dev(y_pad), to_dev(mask)
        shuffle_gen = torch.Generator().manual_seed(int(self.seed))
        dropout_gen = torch.Generator(device=dev).manual_seed(
            int(self.seed) + 1)
        loss_fn = make_loss_fn(self.model, self.input_name, self.label_name)
        epoch_fn = make_epoch_fn(loss_fn, self.optimizer, batch, num_batches,
                                 mode, self.shuffle_per_iter, n_real=n)

        losses_by_epoch: List[torch.Tensor] = []
        epoch_secs: List[float] = []
        nan_halted = False
        t0 = time.perf_counter()
        it = 0
        total_epochs = self.partition_shuffles * self.iters
        for _round in range(self.partition_shuffles):
            for _epoch in range(self.iters):
                it += 1
                te = time.perf_counter()
                params, opt_state, losses = epoch_fn(
                    params, opt_state, data, y_dev, mask_dev, shuffle_gen,
                    dropout_gen)
                losses_by_epoch.append(losses.mean())
                if self.halt_on_nan or self.verbose or self.loss_callback:
                    loss_val = float(losses_by_epoch[-1])  # one host sync
                    if self.halt_on_nan and not np.isfinite(loss_val):
                        logger.error("non-finite loss %r at epoch %d: halting "
                                     "(halt_on_nan=True)", loss_val, it)
                        nan_halted = True
                        break
                    if self.verbose:
                        logger.info("iteration %d loss %f", it, loss_val)
                    self.metrics.scalar("train/loss", loss_val, step=it)
                    if self.loss_callback is not None:
                        # reference signature: loss_callback(loss, iteration,
                        # partition_id); one logical partition here
                        self.loss_callback(loss_val, it, 0)
                if self.straggler_factor:
                    self._check_straggler(it, te, losses_by_epoch[-1],
                                          epoch_secs)
                if (self._publish_store is not None and self.publish_every > 0
                        and (it % self.publish_every == 0
                             or it == total_epochs)):
                    self._publish_weights(params)
            if nan_halted:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        per_epoch = num_batches * batch if mode == "stochastic" else n
        self.params = tree_map(lambda p: p.detach(), params)
        self._last_opt_state = opt_state
        epoch_losses = [float(v) for v in losses_by_epoch]
        if not nan_halted:
            bad = [i + 1 for i, v in enumerate(epoch_losses)
                   if not np.isfinite(v)]
            if bad:
                logger.warning("training diverged: non-finite loss at "
                               "epoch(s) %s", bad[:5])
        # publish-at-end mode (publish_every == 0): the fit's final weights
        # become the next served version — but never NaN-halted ones
        if (self._publish_store is not None and self.publish_every <= 0
                and not nan_halted):
            self._publish_weights(self.params)
        return TrainResult(self.params, epoch_losses,
                           per_epoch * len(epoch_losses) / max(wall, 1e-9),
                           wall, stop_reason="nan" if nan_halted
                           else "completed")

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

    def fit_stream(self, *args, **kwargs):
        _not_yet("fit_stream")

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
