"""Per-step phase breakdown for training loops — carried from the JAX
package.

:class:`StepStats` answers "where did this step spend its time" — the
question the reference (print-per-loss, fixed 8s sleep) never could. The
trainer's loop path charges every slice of wall time to a named phase:

- ``setup``         everything before staging: validation, batching plan,
                    param/optimizer init, checkpoint restore
- ``transfer``      host→device staging of the epoch's arrays
- ``step_compile``  a compiled-step call that triggered an XLA trace (the
                    JAX package's; the PyTorch trainer traces nothing and
                    never charges it)
- ``step``          one epoch's optimizer steps (device-synced)
- ``metrics``       loss fetch / verbose logging / loss_callback
- ``checkpoint``    periodic CheckpointManager.save

Phase totals therefore sum to ≈ the traced wall time (pinned by a test).
:meth:`finalize` derives throughput gauges — steps/sec, examples/sec, and
(best-effort) model FLOPs utilisation via :mod:`sparkflow_tpu_torch.utils.flops` —
and publishes them on a :class:`~sparkflow_tpu_torch.utils.metrics.Metrics`
registry as ``train/*`` gauges.

Single-threaded by design: one StepStats belongs to one ``fit`` call on one
thread (it owns no lock). Cross-thread span collection is the
:class:`~sparkflow_tpu_torch.obs.spans.Tracer`'s job.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

__all__ = ["StepStats"]


class StepStats:
    """Accumulates per-phase durations for a single training run.

    Usage (what the trainer does)::

        ss = StepStats(tracer=tr, metrics=m, examples_per_step=batch)
        with ss.phase("transfer"):
            stage_arrays()
        ss.begin_step()
        ...time the compiled call yourself, then...
        ss.add("step", dt)            # or "step_compile"
        ss.end_step(compiled=False)
        summary = ss.finalize(flops_per_step=fl)
    """

    def __init__(self, tracer=None, metrics=None,
                 examples_per_step: int = 0):
        self.tracer = tracer
        self.metrics = metrics
        self.examples_per_step = int(examples_per_step)
        self.phase_totals: Dict[str, float] = {}
        self.phase_counts: Dict[str, int] = {}
        self.steps: List[Dict[str, Any]] = []
        self._current: Optional[Dict[str, Any]] = None
        self._examples = 0
        self._t_start = time.perf_counter()
        self._t_end: Optional[float] = None
        self._summary: Optional[Dict[str, Any]] = None

    # -- recording -----------------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name: str):
        """Charge the block's wall time to ``name`` (and to the current
        step, if one is open). Also emits a ``train/<name>`` span when a
        tracer is attached."""
        ctx = self.tracer.span(f"train/{name}") if self.tracer else None
        if ctx is not None:
            ctx.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ctx is not None:
                ctx.__exit__(None, None, None)
            self.add(name, dt)

    def add(self, name: str, seconds: float) -> None:
        """Post-hoc charge (for phases whose name is only known after the
        fact — e.g. ``step`` vs ``step_compile`` decided by the trace-count
        delta)."""
        self.phase_totals[name] = self.phase_totals.get(name, 0.0) + seconds
        self.phase_counts[name] = self.phase_counts.get(name, 0) + 1
        if self._current is not None:
            p = self._current["phases"]
            p[name] = p.get(name, 0.0) + seconds

    def begin_step(self, examples: Optional[int] = None) -> None:
        self._current = {
            "phases": {},
            "examples": self.examples_per_step if examples is None
            else int(examples),
        }

    def end_step(self, compiled: bool = False) -> None:
        cur = self._current
        if cur is None:
            return
        cur["compiled"] = bool(compiled)
        self.steps.append(cur)
        self._examples += cur["examples"]
        self._current = None

    def elapsed_s(self) -> float:
        """Seconds since this StepStats started (used by the trainer to
        charge everything before data staging to a ``setup`` phase)."""
        return time.perf_counter() - self._t_start

    def stop_clock(self) -> None:
        """Freeze the wall clock now (call before post-run extras like the
        FLOPs probe compile, so they don't inflate ``wall_s``)."""
        if self._t_end is None:
            self._t_end = time.perf_counter()

    # -- derived -------------------------------------------------------------

    def wall_s(self) -> float:
        end = self._t_end if self._t_end is not None else time.perf_counter()
        return end - self._t_start

    def summary(self) -> Dict[str, Any]:
        """Phase totals plus derived throughput numbers. Steady-state
        steps/sec uses only non-compile steps so a one-off compile does
        not drag the rate down."""
        wall = self.wall_s()
        steps = len(self.steps)
        compile_steps = sum(1 for s in self.steps if s.get("compiled"))
        steady = steps - compile_steps
        steady_step_s = self.phase_totals.get("step", 0.0)
        out: Dict[str, Any] = {
            "wall_s": wall,
            "steps": steps,
            "compile_steps": compile_steps,
            "examples": self._examples,
            "phase_totals_s": dict(self.phase_totals),
            "phase_counts": dict(self.phase_counts),
            "steps_per_sec": steps / wall if wall > 0 else 0.0,
            "examples_per_sec": self._examples / wall if wall > 0 else 0.0,
            "steady_steps_per_sec": (steady / steady_step_s
                                     if steady and steady_step_s > 0
                                     else 0.0),
        }
        return out

    def finalize(self, flops_per_step: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Freeze the clock, compute the summary (adding FLOPs/sec + MFU
        when ``flops_per_step`` is known), publish ``train/*`` gauges, and
        return the summary dict."""
        if self._t_end is None:
            self._t_end = time.perf_counter()
        out = self.summary()
        if flops_per_step:
            out["flops_per_step"] = float(flops_per_step)
            rate = out["steady_steps_per_sec"] or out["steps_per_sec"]
            out["flops_per_sec"] = float(flops_per_step) * rate
            try:
                from ..utils.flops import mfu
                out["mfu"] = mfu(out["flops_per_sec"])
            except Exception:
                out["mfu"] = None
        m = self.metrics
        if m is not None:
            m.gauge("train/steps_per_sec", out["steps_per_sec"])
            m.gauge("train/examples_per_sec", out["examples_per_sec"])
            if out["steady_steps_per_sec"]:
                m.gauge("train/steady_steps_per_sec",
                        out["steady_steps_per_sec"])
            for name, total in out["phase_totals_s"].items():
                m.gauge(f"train/phase_{name}_s", total)
            if out.get("flops_per_sec"):
                m.gauge("train/flops_per_sec", out["flops_per_sec"])
            if out.get("mfu") is not None:
                m.gauge("train/mfu", out["mfu"])
        self._summary = out
        return out
