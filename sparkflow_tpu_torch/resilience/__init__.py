"""Resilience layer carried from the JAX package: retry with backoff, the
serving lifecycle state machine, and the deterministic fault-injection
harness. The resilient-fit driver belongs to training and is not ported
yet (ROADMAP.md)."""

from .lifecycle import Lifecycle, ServerState
from .retry import RetryExhausted, RetryPolicy
from . import faults

__all__ = ["Lifecycle", "ServerState", "RetryExhausted", "RetryPolicy",
           "faults"]
