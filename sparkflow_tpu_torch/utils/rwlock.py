"""Write-priority reader-writer lock (reference parity: ``sparkflow/RWLock.py``).

A copy of the JAX package's ``utils/rwlock.py``, which imports no JAX. In
the reference this is the only concurrency primitive, serializing
parameter-server reads (``GET /parameters``) against optimizer writes
(``POST /update``) when ``acquireLock=True``
(``HogwildSparkModel.py:212-216,227-240``). Here the elastic store
(``parallel/elastic.py``) serializes its own updates under a plain lock, so
this lock's role is host-side: shared driver-side state (metrics sinks,
registries, user callback state) touched by feeder and replica threads.
Same semantics as the reference: concurrent readers, exclusive writers,
writers take priority so they cannot starve.
"""

from __future__ import annotations

import threading


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writers = 0          # active writers (0/1)
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            # write priority: readers queue behind any waiting writer
            while self._writers > 0 or self._writers_waiting > 0:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            while self._readers > 0 or self._writers > 0:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writers = 1

    def release_write(self) -> None:
        with self._cond:
            self._writers = 0
            self._cond.notify_all()

    def release(self) -> None:
        """Release whichever side the calling thread holds (the reference
        exposed a single ``release``, ``RWLock.py:47``)."""
        with self._cond:
            if self._writers:
                self._writers = 0
            elif self._readers:
                self._readers -= 1
            else:
                raise RuntimeError("release() without a held lock")
            if self._readers == 0:
                self._cond.notify_all()

    # context-manager views -------------------------------------------------

    class _Guard:
        def __init__(self, acq, rel):
            self._acq, self._rel = acq, rel

        def __enter__(self):
            self._acq()
            return self

        def __exit__(self, *exc):
            self._rel()
            return False

    def reading(self) -> "_Guard":
        return RWLock._Guard(self.acquire_read, self.release_read)

    def writing(self) -> "_Guard":
        return RWLock._Guard(self.acquire_write, self.release_write)
