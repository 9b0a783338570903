"""Calibration: pin the simulator against a real fleet on one trace —
carried unchanged from the JAX package's ``sim/calibrate.py``.

The simulator is only as trustworthy as its agreement with the system it
models, so this module closes the loop: replay the *same trace* against

1. a **real** fleet — actual :class:`~sparkflow_tpu_torch.serving.server.
   InferenceServer` replicas (stub engine with a known service cost, so
   calibration measures the serving stack, not model FLOPs) behind a real
   :class:`~sparkflow_tpu_torch.serving.router.RouterServer` over HTTP, and
2. the **simulator** — same replica count/concurrency, cost model fitted
   from the real run's own median latency (:meth:`CostModel.fit_predict`),

then compare tail latency and per-replica dispatch counts. The test suite
(``tests/test_torch_sim.py``) asserts the agreement factors.

Fitting on the median and *checking* on the p95 + per-replica split is
deliberate: the median is one scalar (rig speed), while the tail and the
dispatch split emerge from queueing + routing dynamics — exactly what the
simulator claims to reproduce.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..serving import policies
from ..serving.client import ServingClient
from ..serving.router import RouterServer
from ..serving.server import InferenceServer
from .core import FleetSimulator, ReplicaSpec
from .costmodel import CostModel

__all__ = ["StubEngine", "RealRunResult", "CalibrationResult",
           "run_real_fleet", "calibrate"]


class StubEngine:
    """Engine with a fixed, known service cost (sleeps ``delay_s`` per
    predict call) — calibration measures routing + HTTP + batching around
    it, not model compute."""

    max_batch = 16
    _multi = False
    _in_shapes = [(4,)]

    def __init__(self, delay_s: float = 0.01):
        self.delay_s = float(delay_s)

    def predict(self, x):
        time.sleep(self.delay_s)
        return np.asarray(x)[:, :2]

    def stats(self) -> Dict[str, Any]:
        return {}


@dataclass
class RealRunResult:
    """Measurements from one real-fleet trace replay."""

    latencies_ms: List[float] = field(default_factory=list)
    errors: int = 0
    per_replica_successes: List[int] = field(default_factory=list)
    wall_s: float = 0.0


@dataclass
class CalibrationResult:
    """Sim-vs-real agreement on one trace."""

    real: RealRunResult = field(default_factory=RealRunResult)
    sim_report: Any = None
    real_p95_ms: float = 0.0
    sim_p95_ms: float = 0.0
    p95_ratio: float = 0.0          # max(sim, real) / min(sim, real)
    count_ratios: List[float] = field(default_factory=list)
    max_count_ratio: float = 0.0    # worst per-replica dispatch-split skew

    def summary(self) -> Dict[str, Any]:
        return {"real_p95_ms": round(self.real_p95_ms, 3),
                "sim_p95_ms": round(self.sim_p95_ms, 3),
                "p95_ratio": round(self.p95_ratio, 3),
                "max_count_ratio": round(self.max_count_ratio, 3),
                "real_requests": len(self.real.latencies_ms),
                "real_errors": self.real.errors}


def run_real_fleet(trace: Sequence, num_replicas: int = 3, *,
                   service_delay_s: float = 0.01,
                   time_scale: float = 1.0,
                   probe_interval_s: float = 0.1,
                   router_kwargs: Optional[Dict[str, Any]] = None
                   ) -> RealRunResult:
    """Replay ``trace`` against a real ``num_replicas``-replica fleet.

    One thread per request fires at ``arrival_s * time_scale`` (scale < 1
    compresses the replay), measures wall latency through the real
    router, and per-replica success counts come from the router's own
    membership snapshot.
    """
    servers = [InferenceServer(StubEngine(service_delay_s),
                               max_delay_ms=1.0).start()
               for _ in range(num_replicas)]
    router = RouterServer([s.url for s in servers],
                          probe_interval_s=probe_interval_s,
                          **(router_kwargs or {})).start()
    res = RealRunResult()
    lock = threading.Lock()
    x = [[0.0, 1.0, 2.0, 3.0]]
    client = ServingClient(router.url, timeout=10.0, retries=2)

    def one(delay_s: float) -> None:
        time.sleep(delay_s)
        t0 = time.monotonic()
        try:
            client.predict(x)
            ok = True
        except Exception:  # noqa: BLE001 - counted, calibration goes on
            ok = False
        lat = (time.monotonic() - t0) * 1e3
        with lock:
            if ok:
                res.latencies_ms.append(lat)
            else:
                res.errors += 1

    t_start = time.monotonic()
    threads = []
    base = trace[0].arrival_s if len(trace) else 0.0
    for req in trace:
        th = threading.Thread(
            target=one, args=((req.arrival_s - base) * time_scale,),
            daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=60.0)
    res.wall_s = time.monotonic() - t_start
    snap = router.membership.snapshot()
    res.per_replica_successes = [row["successes"] for row in snap]
    client.close()
    router.stop()
    for s in servers:
        s.stop()
    return res


def calibrate(trace: Sequence, num_replicas: int = 3, *,
              service_delay_s: float = 0.01,
              time_scale: float = 1.0,
              slots_per_replica: int = 8,
              seed: int = 0) -> CalibrationResult:
    """Run real + sim on the same trace and compare (see module doc)."""
    out = CalibrationResult()
    out.real = run_real_fleet(trace, num_replicas,
                              service_delay_s=service_delay_s,
                              time_scale=time_scale)
    cost = CostModel.fit_predict(out.real.latencies_ms)
    specs = [ReplicaSpec(slots=slots_per_replica)
             for _ in range(num_replicas)]
    scaled = ([type(r)(r.arrival_s * time_scale, r.prompt_tokens,
                       r.output_tokens, r.tenant, r.session, r.turn)
               for r in trace] if time_scale != 1.0 else list(trace))
    sim = FleetSimulator(specs, scaled, cost, mode="predict", seed=seed,
                         probe_interval_s=0.1)
    out.sim_report = sim.run()
    out.real_p95_ms = policies.percentile_nearest_rank(
        out.real.latencies_ms, 95.0)
    out.sim_p95_ms = out.sim_report.latency_p95_ms
    lo = min(out.real_p95_ms, out.sim_p95_ms)
    hi = max(out.real_p95_ms, out.sim_p95_ms)
    out.p95_ratio = hi / lo if lo > 0 else float("inf")
    # per-replica dispatch split: compare each replica's share, sorted
    # (replica identity does not survive across the two runs — the real
    # fleet's probe/startup order is nondeterministic)
    real_counts = sorted(out.real.per_replica_successes)
    sim_counts = sorted(row["completed"]
                        for row in out.sim_report.per_replica)
    for rc, sc in zip(real_counts, sim_counts):
        lo, hi = min(rc, sc), max(rc, sc)
        out.count_ratios.append(hi / lo if lo > 0 else float("inf"))
    out.max_count_ratio = max(out.count_ratios) if out.count_ratios else 0.0
    return out
