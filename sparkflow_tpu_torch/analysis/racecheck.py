"""Dynamic lockset race detection (GC-R402) — Eraser for the serving fleet.

The static passes (:mod:`locks`, :mod:`lockgraph`) reason about code; this
one watches an actual threaded run. It implements the Eraser lockset
algorithm (Savage et al., SOSP '97): for every tracked shared field,
maintain the set of locks held at *every* access once a second thread shows
up. Each access intersects the candidate set with the locks the accessing
thread holds right now; a field whose candidate set goes empty while being
written from multiple threads has **no lock that consistently protects
it** — a data race by construction, independent of whether this particular
run's timing happened to corrupt anything. That is the whole value over
stress testing: one quiet interleaving is enough to convict.

Per-field state machine (why init writes don't false-positive)::

    virgin --first access--> exclusive --2nd thread reads--> shared
                                 |                             |
                                 +--2nd thread writes--+       | write
                                                       v       v
                                                    shared-modified

Accesses in ``exclusive`` (typically ``__init__`` plus anything before the
worker threads start) never shrink the lockset — single-threaded setup needs
no locks. ``shared`` (read-only after publication) shrinks the set but
never reports — immutable config fields read lock-free are fine. Only
``shared-modified`` — the field is being *written* concurrently — reports
when the lockset empties, with the stacks of the first access, the first
cross-thread access, and the access that emptied the set.

Instrumentation is drop-in and opt-in:

- :class:`InstrumentedLock` wraps an existing ``threading.Lock``/``RLock``
  and reports acquire/release to the active tracker (including the
  release/re-acquire inside ``Condition.wait`` when the condition is
  rebuilt over the wrapper).
- :func:`tracked(obj, attr)` swaps ``obj.__class__`` for a cached subclass
  whose data-descriptor property funnels reads/writes of ``attr`` through
  the tracker (instance ``__dict__`` storage moves to ``_rc_<attr>``).
- :func:`instrument_object(obj, fields=...)` does both at once: wraps every
  lock attribute, rebuilds Conditions over the wrappers, tracks ``fields``.
  **Call it before the threads start** — rebuilding a Condition with
  waiters would strand them.

Everything is gated on an *installed* :class:`RaceTracker`: with none
active (the default), ``instrument_object``/``tracked`` return immediately
and no object in the system is touched — production code paths pay one
``is None`` check per *harness setup call*, zero per access. Chaos
harnesses opt in via the ``SPARKFLOW_TPU_RACECHECK=1`` env flag
(:func:`enabled`), install a tracker for the run, and call
:meth:`RaceTracker.assert_clean` at the end (``make race-smoke``).
"""

from __future__ import annotations

import os
import threading
import traceback
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from .findings import Finding

__all__ = ["RaceTracker", "InstrumentedLock", "tracked", "instrument_object",
           "enabled", "active"]

_ACTIVE: Optional["RaceTracker"] = None

_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()))


def enabled() -> bool:
    """True when the ``SPARKFLOW_TPU_RACECHECK`` env flag asks chaos/test
    harnesses to run under a tracker."""
    return os.environ.get("SPARKFLOW_TPU_RACECHECK", "") not in ("", "0")


def active() -> Optional["RaceTracker"]:
    """The installed tracker, or None (the common, zero-overhead case)."""
    return _ACTIVE


def _site_stack(skip_internal: bool = True) -> Tuple[str, Optional[str],
                                                     Optional[int]]:
    """(formatted stack, path, line) of the current access site — the
    innermost frame outside this module."""
    frames = traceback.extract_stack()
    frames = [f for f in frames if not f.filename.endswith("racecheck.py")]
    frames = frames[-8:]
    text = "".join(traceback.format_list(frames)).rstrip()
    if frames:
        return text, frames[-1].filename, frames[-1].lineno
    return text, None, None


@dataclass
class _FieldState:
    label: str
    state: str = "virgin"           # virgin|exclusive|shared|shared_modified
    first_thread: Optional[int] = None
    lockset: Optional[FrozenSet[int]] = None  # None until 2nd thread
    first_stack: str = ""
    second_stack: str = ""
    threads: set = field(default_factory=set)
    reported: bool = False


@dataclass
class Race:
    """One GC-R402 report: a shared-modified field whose lockset emptied."""
    label: str
    path: Optional[str]
    line: Optional[int]
    threads: List[str]
    first_stack: str
    second_stack: str
    race_stack: str

    def to_finding(self) -> Finding:
        return Finding(
            "GC-R402",
            f"{self.label}: written from threads {', '.join(self.threads)} "
            f"with no lock held in common across all accesses — the Eraser "
            f"lockset emptied at this access (first access and first "
            f"cross-thread access stacks in detail)",
            path=self.path, line=self.line, source="racecheck",
            detail={"first_stack": self.first_stack,
                    "second_stack": self.second_stack,
                    "race_stack": self.race_stack,
                    "threads": self.threads})


class RaceTracker:
    """Eraser lockset state for one instrumented run.

    Use as a context manager (installs/uninstalls the module-global active
    tracker) around the threaded section, then :meth:`assert_clean` or
    :meth:`findings`. One tracker at a time; nesting restores the outer one.
    """

    def __init__(self):
        self._mu = threading.Lock()        # guards _fields/_races (raw lock:
        self._tls = threading.local()      # the tracker must not track itself)
        self._fields: Dict[Tuple[int, str], _FieldState] = {}
        self._pins: List[object] = []      # keep tracked objects alive so
        self._lock_names: Dict[int, str] = {}   # id() keys stay unambiguous
        self.races: List[Race] = []
        self._prev: Optional[RaceTracker] = None
        self._serial_mu = threading.Lock()  # guards _next_serial only
        self._next_serial = 1

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "RaceTracker":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        _ACTIVE = self._prev
        self._prev = None

    def __enter__(self) -> "RaceTracker":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- lock bookkeeping (called by InstrumentedLock) ----------------------

    def _held(self) -> Dict[int, int]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = {}
        return held

    def _tid(self) -> int:
        # tracker-assigned per-thread serial, NOT threading.get_ident():
        # the OS reuses idents, so a worker that fully finishes before its
        # sibling starts would alias the sibling into the same "thread" and
        # the field would never leave the exclusive state (missed race)
        serial = getattr(self._tls, "serial", None)
        if serial is None:
            with self._serial_mu:
                serial = self._next_serial
                self._next_serial += 1
            self._tls.serial = serial
        return serial

    def _on_acquire(self, lock: "InstrumentedLock") -> None:
        held = self._held()
        held[id(lock)] = held.get(id(lock), 0) + 1
        self._lock_names.setdefault(id(lock), lock.name)

    def _on_release(self, lock: "InstrumentedLock") -> None:
        held = self._held()
        n = held.get(id(lock), 0) - 1
        if n > 0:
            held[id(lock)] = n
        else:
            held.pop(id(lock), None)

    # -- field accesses (called by tracked() properties) --------------------

    def register(self, obj: object, attr: str, label: str) -> None:
        key = (id(obj), attr)
        with self._mu:
            if key not in self._fields:
                self._fields[key] = _FieldState(label)
                self._pins.append(obj)

    def record(self, obj: object, attr: str, write: bool) -> None:
        tid = self._tid()
        held = frozenset(self._held())
        key = (id(obj), attr)
        with self._mu:
            fs = self._fields.get(key)
            if fs is None:
                fs = self._fields[key] = _FieldState(
                    f"{type(obj).__name__}.{attr}")
                self._pins.append(obj)
            fs.threads.add(threading.current_thread().name)
            if fs.state == "virgin":
                fs.state = "exclusive"
                fs.first_thread = tid
                fs.first_stack = _site_stack()[0]
                return
            if fs.state == "exclusive":
                if tid == fs.first_thread:
                    return  # still single-threaded: no lock needed yet
                fs.state = "shared_modified" if write else "shared"
                fs.lockset = held
                fs.second_stack = _site_stack()[0]
            else:
                if fs.state == "shared" and write:
                    fs.state = "shared_modified"
                fs.lockset = (held if fs.lockset is None
                              else fs.lockset & held)
            if (fs.state == "shared_modified" and not fs.lockset
                    and not fs.reported):
                fs.reported = True
                stack, path, line = _site_stack()
                self.races.append(Race(
                    label=fs.label, path=path, line=line,
                    threads=sorted(fs.threads),
                    first_stack=fs.first_stack,
                    second_stack=fs.second_stack,
                    race_stack=stack))

    # -- results ------------------------------------------------------------

    def findings(self) -> List[Finding]:
        with self._mu:
            return [r.to_finding() for r in self.races]

    def assert_clean(self) -> None:
        """Raise AssertionError with full stacks if any race was detected."""
        races = self.findings()
        if not races:
            return
        parts = []
        for f in races:
            parts.append(f.render())
            parts.append("  first access:\n" + _indent(
                str(f.detail["first_stack"])))
            parts.append("  first cross-thread access:\n" + _indent(
                str(f.detail["second_stack"])))
            parts.append("  lockset emptied at:\n" + _indent(
                str(f.detail["race_stack"])))
        raise AssertionError(
            f"racecheck: {len(races)} data race(s) detected\n"
            + "\n".join(parts))


def _indent(text: str, pad: str = "    ") -> str:
    return "\n".join(pad + ln for ln in text.splitlines())


class InstrumentedLock:
    """Drop-in wrapper over a ``threading.Lock``/``RLock`` that reports
    acquire/release to the active tracker (so held locksets are known).
    API-compatible where it matters: ``with``, ``acquire(blocking,
    timeout)``, ``release``, ``locked``; usable as the lock behind a
    ``threading.Condition`` (the default ``_release_save`` /
    ``_acquire_restore`` go through :meth:`release`/:meth:`acquire`, so
    ``wait()`` correctly drops the lock from the waiter's lockset)."""

    def __init__(self, inner=None, name: Optional[str] = None):
        self._inner = inner if inner is not None else threading.Lock()
        self.name = name or f"lock@{id(self._inner):#x}"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            t = _ACTIVE
            if t is not None:
                t._on_acquire(self)
        return ok

    def release(self) -> None:
        t = _ACTIVE
        if t is not None:
            t._on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"InstrumentedLock({self.name})"


# -- attribute tracking -------------------------------------------------------

#: (base class, frozenset of tracked attrs) -> generated subclass
_SUBCLASS_CACHE: Dict[Tuple[type, FrozenSet[str]], type] = {}


def _make_property(attr: str) -> property:
    store = "_rc_" + attr

    def fget(self):
        t = _ACTIVE
        if t is not None:
            t.record(self, attr, write=False)
        try:
            return self.__dict__[store]
        except KeyError:
            raise AttributeError(attr) from None

    def fset(self, value):
        t = _ACTIVE
        if t is not None:
            t.record(self, attr, write=True)
        self.__dict__[store] = value

    def fdel(self):
        t = _ACTIVE
        if t is not None:
            t.record(self, attr, write=True)
        del self.__dict__[store]

    return property(fget, fset, fdel)


def tracked(obj: object, attr: str, label: Optional[str] = None):
    """Put ``obj.attr`` under lockset tracking (no-op without an active
    tracker). Swaps ``obj.__class__`` for a cached subclass whose property
    routes the attribute through the tracker; the current value moves to
    ``_rc_<attr>`` in the instance dict. Returns ``obj``."""
    t = _ACTIVE
    if t is None:
        return obj
    cls = type(obj)
    base = getattr(cls, "_rc_base", cls)
    attrs = frozenset(getattr(cls, "_rc_attrs", frozenset()) | {attr})
    sub = _SUBCLASS_CACHE.get((base, attrs))
    if sub is None:
        ns = {"_rc_base": base, "_rc_attrs": attrs}
        for a in attrs:
            ns[a] = _make_property(a)
        # keep the base's name so reprs/logs stay readable
        sub = type(base.__name__, (base,), ns)
        _SUBCLASS_CACHE[(base, attrs)] = sub
    if attr in obj.__dict__:
        obj.__dict__["_rc_" + attr] = obj.__dict__.pop(attr)
    obj.__class__ = sub
    t.register(obj, attr, label or f"{base.__name__}.{attr}")
    return obj


def instrument_object(obj: object, fields: Tuple[str, ...] = (),
                      name: Optional[str] = None):
    """Full drop-in instrumentation of one object (no-op without an active
    tracker): every ``threading`` lock attribute is wrapped in an
    :class:`InstrumentedLock` (one wrapper per underlying lock, so aliased
    attributes stay aliased), every ``Condition`` is rebuilt over its
    wrapped lock, and each name in ``fields`` goes under :func:`tracked`.
    Call before the object's threads start. Returns ``obj``."""
    if _ACTIVE is None:
        return obj
    prefix = name or type(obj).__name__
    wrappers: Dict[int, InstrumentedLock] = {}
    items = list(vars(obj).items())
    for attr, val in items:
        if isinstance(val, _LOCK_TYPES):
            w = wrappers.get(id(val))
            if w is None:
                w = wrappers[id(val)] = InstrumentedLock(
                    val, name=f"{prefix}.{attr}")
            setattr(obj, attr, w)
    for attr, val in items:
        if isinstance(val, threading.Condition):
            inner = val._lock
            w = wrappers.get(id(inner))
            if w is None and isinstance(inner, _LOCK_TYPES):
                w = wrappers[id(inner)] = InstrumentedLock(
                    inner, name=f"{prefix}.{attr}._lock")
            if w is not None:
                setattr(obj, attr, threading.Condition(w))
    for f_ in fields:
        tracked(obj, f_, label=f"{prefix}.{f_}")
    return obj
