"""Parallel training in the port. So far the in-process half of the JAX
package's ``parallel``: :mod:`.elastic`, bounded-staleness async data
parallelism over a versioned parameter store (the reference's Hogwild
heritage), whose replicas are threads on one card. The device-mesh paths
(``mesh``, ``dp``, ``ep``, ``pp``, ``sp``, ring attention, ``hyper``,
``distributed``) are not yet ported (see ROADMAP.md)."""

from .elastic import (ElasticDPEngine, ElasticParamStore, ElasticResult,
                      InProcessTransport, PushResult, ReplicaSpec, SparseRows,
                      decode_grads, encode_grads,
                      sync_baseline_examples_per_sec)

__all__ = ["ElasticDPEngine", "ElasticParamStore", "ElasticResult",
           "InProcessTransport", "PushResult", "ReplicaSpec", "SparseRows",
           "encode_grads", "decode_grads", "sync_baseline_examples_per_sec"]
