"""Import-compatibility alias: ``from sparkflow_tpu_torch.RWLock import
RWLock`` works like the reference's ``from sparkflow.RWLock import RWLock``
(``sparkflow/RWLock.py:10``).

The implementation lives in :mod:`sparkflow_tpu_torch.utils.rwlock` — same
semantics (concurrent readers, write priority, single ``release``) plus
context managers."""

from .utils.rwlock import RWLock

__all__ = ["RWLock"]
