"""Preemption guard: turn SIGTERM into a clean checkpoint-and-return —
carried from the JAX package.

Cloud machines are routinely preempted (maintenance events, spot reclaim) with a
SIGTERM and a short grace window. The reference had no story for this at all
(SURVEY.md §5: drop-and-print); here the Trainer checks the guard at every
epoch/step boundary and, when a signal arrived, saves a checkpoint and
returns the partial result — the next ``fit`` on the same ``checkpoint_dir``
resumes exactly where it stopped (same rng stream, optimizer state).

Only installed while a fit with a configured ``checkpoint_dir`` is running;
outside that window signals keep their default behavior.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger("sparkflow_tpu_torch")


class PreemptionGuard:
    """Context manager: latches SIGTERM (and optionally other signals) into
    a flag instead of killing the process. Main-thread only (CPython routes
    signals to the main thread); elsewhere it degrades to a no-op guard."""

    def __init__(self, signals=(signal.SIGTERM,), on_signal=None):
        self._signals = tuple(signals)
        self._previous = {}
        self.requested = False
        self._armed = False
        # optional hook fired from the handler after the latch is set —
        # serving uses it to flip its lifecycle to DRAINING; must itself be
        # async-signal-tolerant (no locks the interrupted thread may hold)
        self._on_signal = on_signal

    def _handler(self, signum, frame):
        self.requested = True
        logger.warning("signal %d received: will checkpoint and stop at the "
                       "next epoch boundary", signum)
        if self._on_signal is not None:
            self._on_signal(signum)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handler)
            self._armed = True
        return self

    def __exit__(self, *exc):
        if self._armed:
            for s, prev in self._previous.items():
                signal.signal(s, prev)
            self._previous.clear()
            self._armed = False
        return False


class NullGuard:
    """No-op stand-in when no checkpoint_dir is configured."""

    requested = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
