"""``HogwildTrainer``: the ``HogwildSparkModel``-shaped direct training entry
— the port of the JAX package's ``hogwild.py``.

The reference lets users bypass the Estimator and train an RDD of
``(features, label)`` pairs directly (``HogwildSparkModel(...).train(rdd)``,
``sparkflow/HogwildSparkModel.py:110-143,246-266``; exercised by
``tests/dl_runner.py:187-214``). This class keeps that constructor surface —
including the parameter-server-era arguments — and trains asynchronously
through the bounded-staleness elastic engine (``parallel.elastic``): each
RDD partition maps to a replica thread that pushes gradients to a versioned
in-process parameter store whenever it finishes a mini-batch — the
reference's Hogwild loop, with the HTTP hop and the unbounded staleness
removed. ``master_url``, ``serverStartup`` and ``port`` are accepted and
ignored (the store is in-process: no server to spawn, no startup sleep),
and ``stop_server`` does nothing, kept for cleanup code written against
the reference. ``acquire_lock`` is accepted for parity: the store always
serializes updates under its lock.

``device`` is the replicas' card (the CUDA card unless ``"cpu"`` is asked
for). Also exported under the reference's class name ``HogwildSparkModel``.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, List, Optional

import numpy as np

from .ml_util import handle_features
from .optimizers import GradientTransformation, build_optimizer
from .trainer import Trainer


class HogwildTrainer:
    def __init__(self,
                 tensorflowGraph: Optional[str] = None,
                 iters: int = 1000,
                 tfInput: Optional[str] = None,
                 tfLabel: Optional[str] = None,
                 optimizer: Any = None,
                 master_url: Optional[str] = None,   # ignored: store is in-process
                 serverStartup: int = 8,             # ignored: nothing to wait for
                 acquire_lock: bool = False,         # store always locks
                 mini_batch: int = -1,
                 mini_stochastic_iters: int = -1,
                 shuffle: bool = True,
                 verbose: int = 0,
                 partition_shuffles: int = 1,
                 loss_callback: Optional[Callable] = None,
                 port: int = 5000,                   # ignored: no port to bind
                 mesh=None,                          # ignored, as in the JAX package
                 max_staleness: int = 4,
                 dampening="inverse",
                 device=None):
        if tensorflowGraph is None:
            raise ValueError("tensorflowGraph (JSON graph spec) is required")
        if optimizer is None:
            optimizer = build_optimizer("adam", 0.01, None)
        elif isinstance(optimizer, str):
            optimizer = build_optimizer(optimizer, 0.01, None)
        elif not isinstance(optimizer, GradientTransformation):
            raise TypeError(
                "optimizer must be a GradientTransformation or a name; TF "
                "optimizer objects do not exist in this framework — build "
                "one with sparkflow_tpu_torch.optimizers.build_optimizer")
        self._trainer = Trainer(
            tensorflowGraph, tfInput, tfLabel,
            optimizer=optimizer,
            iters=iters,
            mini_batch_size=mini_batch,
            mini_stochastic_iters=mini_stochastic_iters,
            shuffle_per_iter=shuffle,
            partition_shuffles=partition_shuffles,
            verbose=verbose,
            loss_callback=loss_callback,
            acquire_lock=acquire_lock,
            strategy="elastic_dp",
            elastic={"max_staleness": max_staleness,
                     "dampening": dampening},
            device=device,
        )
        self.tfLabel = tfLabel
        self.weights: Optional[List[np.ndarray]] = None

    def train(self, rdd) -> List[np.ndarray]:
        """Train on an RDD (or any iterable) of ``(features, label)`` pairs —
        bare features when unsupervised — and return the flat weight list
        (reference ``HogwildSparkModel.train``, ``HogwildSparkModel.py:246-269``).

        One replica per RDD partition, like the reference's one async worker
        per ``foreachPartition`` task (clamped to [1, 8]); a plain iterable
        trains with 4 replicas."""
        if hasattr(rdd, "getNumPartitions"):
            replicas = max(1, min(8, int(rdd.getNumPartitions())))
        else:
            replicas = 4
        self._trainer.elastic["replicas"] = replicas
        items = rdd.collect() if hasattr(rdd, "collect") else list(rdd)
        features, labels = handle_features(items,
                                           is_supervised=self.tfLabel is not None)
        self._trainer.fit(features, labels)
        self.weights = self._trainer.weights_list()
        return self.weights

    @property
    def elastic_stats(self):
        """Push/staleness/membership accounting from the last ``train``
        (``ElasticResult.stats``), or None before training."""
        return self._trainer.last_elastic_stats

    def stop_server(self) -> None:
        """No server exists; kept so reference-style cleanup code runs
        (``tests/dl_runner.py:209-214``)."""

    @staticmethod
    def determine_master(port: int = 8476) -> str:
        """Reference API parity (``HogwildSparkModel.determine_master``,
        ``HogwildSparkModel.py:145-154``): a coordinator address — the
        ``SPARKFLOW_TPU_COORDINATOR`` environment variable when set, else
        this host's address — as the JAX package resolves it."""
        addr = os.environ.get("SPARKFLOW_TPU_COORDINATOR")
        if addr:
            return addr if ":" in addr else f"{addr}:{port}"
        return f"{socket.gethostbyname(socket.gethostname())}:{port}"

    # reference attribute some callers poke at
    @property
    def server(self):
        return None


HogwildSparkModel = HogwildTrainer
