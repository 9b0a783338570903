"""Online serving, ported to PyTorch.

- :class:`~sparkflow_tpu_torch.serving.engine.InferenceEngine` — the
  predict plane: a trained model served over a ladder of padded batch
  buckets (each run once at warmup), int8 weights on request
  (``quantize="weight_only"|"dynamic"``), live weight hot-swap;
- :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine` — paged-KV
  prefill + decode over the CUDA ``flash_fwd`` / ``paged_attention``
  kernels;
- :class:`~sparkflow_tpu_torch.serving.batcher.MicroBatcher` /
  :class:`~sparkflow_tpu_torch.serving.batcher.ContinuousBatcher` —
  deadline batching in front of the predict engine, token-boundary
  batching in front of the decode engine;
- :class:`~sparkflow_tpu_torch.serving.server.InferenceServer` /
  :class:`~sparkflow_tpu_torch.serving.client.ServingClient` — the stdlib
  JSON-HTTP front (``POST /v1/predict``, ``POST /v1/generate``,
  ``/healthz``, ``/metrics``) and its client;
- :class:`~sparkflow_tpu_torch.serving.weightstore.WeightStore` /
  :class:`~sparkflow_tpu_torch.serving.weightstore.WeightWatcher` — live
  weight publication (the JAX package's on-disk format) and the watcher
  that hot-swaps either engine;
- :class:`~sparkflow_tpu_torch.serving.router.RouterServer` /
  :class:`~sparkflow_tpu_torch.serving.membership.Membership` — the fleet:
  N replicas behind one router with health-gated membership, circuit
  breakers, least-loaded and KV-headroom dispatch, admission control,
  retry and reroute, hedging, a result cache and canary rollout, every
  decision made by the pure :mod:`~sparkflow_tpu_torch.serving.policies`;
- :class:`~sparkflow_tpu_torch.serving.autoscaler.Autoscaler` /
  :class:`~sparkflow_tpu_torch.serving.autoscaler.ReplicaManager` — the
  elastic fleet that spawns, drains and replaces replica processes;
- :class:`~sparkflow_tpu_torch.serving.coldstart.ExecutableStore` — the
  built kernel library stored beside the weights, so a new replica boots
  its kernels without ``nvcc`` (``executable_dir=`` on both engines).
"""

from . import policies
from .autoscaler import Autoscaler, ReplicaManager
from .batcher import ContinuousBatcher, Draining, MicroBatcher, QueueFull
from .client import ConnectionPool, ServingClient, ServingError
from .coldstart import ExecutableStore
from .decode import DecodeEngine
from .engine import InferenceEngine
from .kvcache import OutOfPages, PagedKVCache
from .membership import BreakerState, CircuitBreaker, Membership, Replica
from .policies import ReplicaView, VersionStats
from .router import (CanaryController, ResultCache, RouterServer,
                     TokenBucket)
from .server import InferenceServer
from .weightstore import WeightStore, WeightStoreError, WeightWatcher

__all__ = ["InferenceEngine", "MicroBatcher", "QueueFull", "Draining",
           "InferenceServer", "ServingClient", "ServingError",
           "ConnectionPool", "RouterServer", "Membership", "Replica",
           "CircuitBreaker", "BreakerState", "TokenBucket", "ResultCache",
           "DecodeEngine", "ContinuousBatcher", "PagedKVCache",
           "OutOfPages", "WeightStore", "WeightWatcher", "WeightStoreError",
           "CanaryController", "policies", "ReplicaView", "VersionStats",
           "Autoscaler", "ReplicaManager", "ExecutableStore"]
