"""Serving lifecycle: a small thread-safe state machine with in-flight
request accounting.

States flow one way — ``STARTING -> SERVING -> DRAINING -> STOPPED`` (any
state may jump straight to ``STOPPED``). ``DRAINING`` is the graceful-drain
window: in-flight requests run to completion while new ones are refused
(the HTTP front maps the refusal to ``503`` + ``Retry-After``, so a load
balancer retries against another replica instead of surfacing an error).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Optional

__all__ = ["ServerState", "Lifecycle"]


class ServerState(enum.Enum):
    STARTING = "starting"
    SERVING = "serving"
    DRAINING = "draining"
    STOPPED = "stopped"


_ALLOWED = {
    ServerState.STARTING: {ServerState.SERVING, ServerState.STOPPED},
    ServerState.SERVING: {ServerState.DRAINING, ServerState.STOPPED},
    ServerState.DRAINING: {ServerState.STOPPED},
    ServerState.STOPPED: set(),
}


class Lifecycle:
    """State + in-flight counter, safe to poke from handler threads, the
    drain thread, and signal handlers alike."""

    def __init__(self):
        self._cond = threading.Condition()
        self._state = ServerState.STARTING
        self._inflight = 0

    @property
    def state(self) -> ServerState:
        with self._cond:
            return self._state

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def transition(self, new: ServerState) -> bool:
        """Move to ``new`` if the edge is legal; returns whether the state
        changed (repeat/illegal transitions are refused, not raised — a
        second SIGTERM during a drain must be harmless)."""
        with self._cond:
            if new is self._state or new not in _ALLOWED[self._state]:
                return False
            self._state = new
            self._cond.notify_all()
            return True

    def try_begin_request(self) -> bool:
        """Admit one request iff SERVING (counted until
        :meth:`end_request`)."""
        with self._cond:
            if self._state is not ServerState.SERVING:
                return False
            self._inflight += 1
            return True

    def end_request(self) -> None:
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            self._cond.notify_all()

    def wait_idle(self, timeout: Optional[float] = 10.0) -> bool:
        """Block until no requests are in flight (the drain barrier).
        Returns False if ``timeout`` expired first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True
