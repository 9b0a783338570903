"""Generic retry with exponential backoff + jitter + deadline.

One policy object serves every transient-failure site in the framework —
coordinator joins (``parallel.distributed.initialize``), checkpoint reads
(``CheckpointManager.restore``), the serving client
(``serving.ServingClient.predict``), and the resilient-fit driver
(``resilience.run_resilient_fit``) — so backoff behavior, determinism, and
the structured give-up error are defined in exactly one place.

Determinism: a seeded policy produces a reproducible jitter stream, and both
the clock and the sleep function are injectable, so tests assert exact delay
sequences with a stubbed clock instead of sleeping.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryExhausted", "RetryPolicy"]


class RetryExhausted(Exception):
    """Structured give-up: carries what was attempted, how many times, for
    how long, and the last underlying error (also chained via ``__cause__``)."""

    def __init__(self, op: str, attempts: int, elapsed_s: float,
                 last_error: Optional[BaseException]):
        self.op = op
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last_error = last_error
        last = (f"{type(last_error).__name__}: {last_error}"
                if last_error is not None else "<none>")
        super().__init__(f"{op}: gave up after {attempts} attempt(s) over "
                         f"{elapsed_s:.2f}s; last error: {last}")


class RetryPolicy:
    """Exponential backoff with jitter, an attempt budget, and a wall-clock
    deadline.

    Parameters
    ----------
    max_attempts : int
        Total tries (1 = no retry).
    base_s / multiplier / max_s : float
        Attempt ``i`` (0-based) backs off ``min(max_s, base_s * multiplier**i)``
        before jitter.
    jitter : float
        Fractional jitter in [0, 1]: the delay is scaled by a factor drawn
        uniformly from ``[1 - jitter, 1 + jitter]``. 0 disables jitter.
    deadline_s : float | None
        Hard wall-clock budget across ALL attempts (including the sleep about
        to be taken); exceeded -> :class:`RetryExhausted` without sleeping.
    seed : int | None
        Seeds the jitter stream for reproducible delay sequences.
    retry_on : tuple of exception types
        Only these are retried; anything else propagates immediately.
    sleep / clock : callables
        Injectable for tests (stubbed clock => no real sleeping).
    """

    def __init__(self, max_attempts: int = 5, base_s: float = 0.1,
                 multiplier: float = 2.0, max_s: float = 5.0,
                 jitter: float = 0.5, deadline_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self.retry_on = retry_on
        self.sleep = sleep
        self.clock = clock
        self._rng = random.Random(seed)

    def backoff(self, attempt: int) -> float:
        """Jittered delay before retry number ``attempt`` (0-based: the delay
        taken after the first failure is ``backoff(0)``)."""
        d = min(self.max_s, self.base_s * self.multiplier ** attempt)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn: Callable, *args, describe: Optional[str] = None,
             on_retry: Optional[Callable] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy.

        Retryable failures (``retry_on``) back off and re-run until the
        attempt budget or deadline is spent, then raise
        :class:`RetryExhausted` (chained to the last error). Non-retryable
        exceptions propagate untouched. ``on_retry(attempt, delay_s, error)``
        is called before each sleep.
        """
        op = describe or getattr(fn, "__name__", "call")
        start = self.clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                elapsed = self.clock() - start
                if attempt >= self.max_attempts:
                    raise RetryExhausted(op, attempt, elapsed, e) from e
                delay = self.backoff(attempt - 1)
                if (self.deadline_s is not None
                        and elapsed + delay > self.deadline_s):
                    raise RetryExhausted(op, attempt, elapsed, e) from e
                if on_retry is not None:
                    on_retry(attempt, delay, e)
                # the backoff wait becomes a span: a trace of a slow fit or
                # a long replica start shows WHERE the time went — sleeping
                # out retries — and names the error that caused each one
                from ..obs.spans import span as obs_span
                with obs_span("retry/backoff",
                              args={"op": op, "attempt": attempt,
                                    "delay_s": round(delay, 6),
                                    "error": type(e).__name__}):
                    self.sleep(delay)
