"""Resumable-fit driver: keep a training job alive across crashes and
preemptions — carried from the JAX package.

``Trainer.fit`` already handles *in-fit* recovery (``resume_retries``
restores mid-loop) and turns SIGTERM into a clean checkpoint-and-return.
This driver closes the remaining gap: failures that escape ``fit`` entirely
(a crash before the in-fit retry budget could catch it, an exhausted budget,
a preemption that returned a partial result) are answered by re-invoking
``fit`` on the same ``checkpoint_dir`` — each attempt restores the newest
*valid* checkpoint (``CheckpointManager`` falls back past torn/corrupt
steps) and continues the identical rng/optimizer trajectory, so the final
weights are bit-identical to an uninterrupted run (pinned in
tests/test_torch_resilience.py).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from .retry import RetryExhausted, RetryPolicy

logger = logging.getLogger("sparkflow_tpu_torch")

__all__ = ["run_resilient_fit"]


def run_resilient_fit(trainer, features, labels=None, *, init_params=None,
                      max_restarts: int = 3,
                      restart_policy: Optional[RetryPolicy] = None):
    """Run ``trainer.fit(features, labels)`` to completion, restarting from
    the latest valid checkpoint after crashes or preemptions.

    Requires the trainer to be constructed with a ``checkpoint_dir`` (and a
    sensible ``checkpoint_every``) — without one there is nothing to resume
    from and the call refuses up front. ``max_restarts`` bounds the total
    number of re-invocations across both failure kinds; ``restart_policy``
    shapes the backoff between them (jitter matters when a whole pod
    restarts at once). Returns the :class:`~sparkflow_tpu_torch.trainer.TrainResult`
    of the completing attempt; raises :class:`RetryExhausted` when the
    restart budget is spent on exceptions.
    """
    if not getattr(trainer, "checkpoint_dir", None):
        raise ValueError(
            "run_resilient_fit needs a Trainer with checkpoint_dir set "
            "(and checkpoint_every > 0): restarts resume from checkpoints")
    if trainer.checkpoint_every <= 0:
        logger.warning(
            "run_resilient_fit: checkpoint_every is 0 — only preemption "
            "checkpoints will be written, so a hard crash restarts the fit "
            "from scratch")
    policy = restart_policy or RetryPolicy(
        max_attempts=max_restarts + 1, base_s=0.2, multiplier=2.0,
        max_s=10.0, jitter=0.5, seed=0)
    restarts = 0
    start = time.perf_counter()
    while True:
        try:
            result = trainer.fit(features, labels, init_params=init_params)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            restarts += 1
            if restarts > max_restarts:
                raise RetryExhausted(
                    f"resilient fit (checkpoint_dir={trainer.checkpoint_dir})",
                    restarts, time.perf_counter() - start, e) from e
            delay = policy.backoff(restarts - 1)
            logger.warning(
                "fit attempt failed (%s: %s); restarting from the latest "
                "valid checkpoint in %.2fs (restart %d/%d)",
                type(e).__name__, e, delay, restarts, max_restarts)
            policy.sleep(delay)
            continue
        if result.stop_reason != "preempted":
            return result
        restarts += 1
        if restarts > max_restarts:
            logger.warning(
                "still preempted after %d restart(s); returning the partial "
                "result (checkpointed at the stop point)", max_restarts)
            return result
        logger.warning(
            "fit preempted mid-run; resuming from its checkpoint "
            "(restart %d/%d)", restarts, max_restarts)
        continue
