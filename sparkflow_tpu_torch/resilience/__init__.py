"""Resilience layer carried from the JAX package: retry with backoff, the
resumable-fit driver (:func:`run_resilient_fit`: re-invoke ``Trainer.fit``
after crashes or preemptions, resuming from the newest valid checkpoint to
bit-identical final weights), the serving lifecycle state machine, and the
deterministic fault-injection harness."""

from .driver import run_resilient_fit
from .lifecycle import Lifecycle, ServerState
from .retry import RetryExhausted, RetryPolicy
from . import faults

__all__ = ["RetryPolicy", "RetryExhausted", "run_resilient_fit",
           "Lifecycle", "ServerState", "faults"]
