"""Fleet-scale trace-driven simulation: what-if the fleet, not the model —
carried unchanged from the JAX package's ``sim``, so the same trace, cost
model and fleet give the same event-log digest in both packages.

The north-star system serves heavy traffic from a large fleet — but every
routing/health/canary policy question ("what does the pick rule do to a
mixed int8/bf16 fleet at 4x burst?") is unanswerable on a 3-replica test
rig and unaffordable to answer in production. This package answers them
offline: a deterministic discrete-event simulator
(:class:`~sparkflow_tpu_torch.sim.core.FleetSimulator`) replays a request trace
(:mod:`~sparkflow_tpu_torch.sim.trace`) against a modelled fleet whose
*decisions* are made by the real serving plane's policy code
(:mod:`sparkflow_tpu_torch.serving.policies`, plus the real ``CircuitBreaker``,
``TokenBucket``, ``CanaryController``, and ``RetryPolicy`` on a virtual
clock) while transport + compute are priced by a bench-fitted
:class:`~sparkflow_tpu_torch.sim.costmodel.CostModel`. Calibration
(:mod:`~sparkflow_tpu_torch.sim.calibrate`) pins sim-vs-real agreement on the
same trace; determinism is byte-exact (same trace + seed => identical
event-log sha256).

``chip_smoke.py`` (phase 15) fits ``CostModel.predict_ms`` to a BERT-base
predict fleet on the card and reads the sim-versus-real p95 there.
"""

from .core import (FleetSimulator, ReplicaSpec, SimAutoscaler, SimReplica,
                   SimReport, legacy_generate_pick_key)
from .costmodel import CostModel
from .trace import Request, load, save, synthetic_trace

# NOTE: `calibrate` is deliberately NOT imported here — it pulls the full
# serving stack (and through it torch); `from sparkflow_tpu_torch.sim import
# calibrate` loads it on demand. Pure-sim runs stay import-light.
__all__ = ["FleetSimulator", "ReplicaSpec", "SimAutoscaler", "SimReplica",
           "SimReport", "legacy_generate_pick_key", "CostModel", "Request",
           "synthetic_trace", "save", "load"]
