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
  that hot-swaps either engine.

The router, autoscaler and cold-start store of the JAX package are not
ported yet (ROADMAP.md).
"""

from .batcher import ContinuousBatcher, Draining, MicroBatcher, QueueFull
from .client import ConnectionPool, ServingClient, ServingError
from .decode import DecodeEngine
from .engine import InferenceEngine
from .kvcache import OutOfPages, PagedKVCache
from .server import InferenceServer
from .weightstore import WeightStore, WeightStoreError, WeightWatcher

__all__ = ["ContinuousBatcher", "Draining", "MicroBatcher", "QueueFull",
           "ConnectionPool", "ServingClient", "ServingError", "DecodeEngine",
           "InferenceEngine", "OutOfPages", "PagedKVCache", "InferenceServer",
           "WeightStore", "WeightStoreError", "WeightWatcher"]
