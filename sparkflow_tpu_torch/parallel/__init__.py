"""Parallel training in the port, on ``torch.distributed``:

- :mod:`.mesh` — named meshes over ranks (one process per rank, a card or
  the CPU each) and their axis groups; the rule of data-parallel serving
  in one process;
- :mod:`.collectives` — ``psum`` / ``psum_scatter`` / ``all_gather`` /
  ``ppermute`` over named axes, and the two-level ``dcn`` reduction;
- :mod:`.distributed` — joining a process group, and the local launcher
  (:class:`~.distributed.RankPool`) a single-process caller gets its ranks
  from, with a line to each rank while a task runs; the backend rule;
- :mod:`.dp` — synchronous data parallelism with ZeRO stages 0-3;
- :mod:`.sp` — sequence parallelism through ring attention;
- :mod:`.tp` — Megatron tensor parallelism and fsdp parameter sharding:
  the spec rules, a rank's slices and the gather back, and the one-process
  serving split (:class:`~.tp.TPShards`); the step is
  :func:`~.dp.make_param_sharded_train_step`;
- :mod:`.pp` — pipeline parallelism: the stage layout, the 1F1B tables
  and the gpipe / 1f1b / sequential train step with a hand-scheduled
  backward over stage-to-stage hops;
- :mod:`.elastic` — bounded-staleness async data parallelism over a
  versioned parameter store (the reference's Hogwild heritage), whose
  replicas are threads on one card.

Expert parallelism (``ep``) and ``hyper`` are not yet ported (ROADMAP.md,
queue 1 item 7)."""

from .mesh import default_mesh, make_mesh, mesh_axis_size
from . import collectives
from .dp import (make_dp_shardmap_train_step, make_dp_train_step,
                 make_dp_zero1_train_step)
from ..sharding import ShardingConfig
from .elastic import (ElasticDPEngine, ElasticParamStore, ElasticResult,
                      InProcessTransport, PushResult, ReplicaSpec, SparseRows,
                      decode_grads, encode_grads,
                      sync_baseline_examples_per_sec)

__all__ = ["default_mesh", "make_mesh", "mesh_axis_size", "collectives",
           "ShardingConfig", "make_dp_train_step",
           "make_dp_shardmap_train_step", "make_dp_zero1_train_step",
           "ElasticDPEngine", "ElasticParamStore", "ElasticResult",
           "InProcessTransport", "PushResult", "ReplicaSpec", "SparseRows",
           "encode_grads", "decode_grads",
           "sync_baseline_examples_per_sec"]
