"""Online decode serving, ported to PyTorch.

- :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine` — paged-KV
  prefill + decode over the CUDA ``flash_fwd`` / ``paged_attention``
  kernels;
- :class:`~sparkflow_tpu_torch.serving.batcher.ContinuousBatcher` —
  token-boundary batching in front of it (``MicroBatcher`` is carried for
  the predict plane, whose engine is not ported yet);
- :class:`~sparkflow_tpu_torch.serving.server.InferenceServer` /
  :class:`~sparkflow_tpu_torch.serving.client.ServingClient` — the stdlib
  JSON-HTTP front (``POST /v1/generate``, ``/healthz``, ``/metrics``) and
  its client.

The predict engine, router, autoscaler, weight store and cold-start store
of the JAX package are not ported yet (ROADMAP.md).
"""

from .batcher import ContinuousBatcher, Draining, MicroBatcher, QueueFull
from .client import ConnectionPool, ServingClient, ServingError
from .decode import DecodeEngine
from .kvcache import OutOfPages, PagedKVCache
from .server import InferenceServer

__all__ = ["ContinuousBatcher", "Draining", "MicroBatcher", "QueueFull",
           "ConnectionPool", "ServingClient", "ServingError", "DecodeEngine",
           "OutOfPages", "PagedKVCache", "InferenceServer"]
