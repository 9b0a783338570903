"""Runtime resource-balance tracking (GC-X605) — the dynamic twin of
:mod:`~sparkflow_tpu.analysis.lifecycle`.

The static pass proves acquire/release pairing over paths it can see; this
one audits an actual run. A :class:`ResourceTracker` keeps a per-resource
balance for the same pair registry — KV slots and their pages, batcher
admissions, pooled connections, per-entity gauge namespaces — recording the
acquisition stack each time a resource is checked out and crossing it off
on release. At the end of the run, :meth:`ResourceTracker.report` turns
every nonzero balance (and every double release) into a **GC-X605**
finding whose detail carries the stacks of the acquisitions that were
never paid back; :meth:`ResourceTracker.assert_balanced` raises with those
stacks inline. Chaos drills (``race_smoke``/``fleet_smoke``/
``scale_smoke``) run under the tracker when ``SPARKFLOW_TPU_RESTRACK=1``
(:func:`enabled`), turning every kill/drain/disconnect they already
perform into a leak oracle.

Instrumentation is drop-in and opt-in, racecheck-style: every
``instrument_*`` helper returns its argument untouched when no tracker is
installed — the production hot path pays one ``is None`` check per
*harness setup call* and nothing per operation. With a tracker active, the
helpers shadow the relevant bound methods on the *instance* (the class is
never touched), so only the audited objects pay for bookkeeping.

**Instrument before the worker threads start.** The wrappers swap instance
attributes non-atomically; a thread mid-call during instrumentation could
run the un-wrapped method and acquire a resource the tracker never sees —
the same gotcha as :func:`racecheck.instrument_object`.

Typical harness shape::

    tracker = ResourceTracker().install() if restrack.enabled() else None
    if tracker is not None:
        restrack.instrument_engine(engine)      # slots + KV pages
        restrack.instrument_batcher(batcher)    # admissions
        restrack.instrument_metrics(metrics, prefixes=("router/replica",))
    ... chaos ...
    if tracker is not None:
        tracker.assert_balanced()
        tracker.uninstall()
"""

from __future__ import annotations

import os
import re
import threading
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = ["ResourceTracker", "enabled", "active", "instrument_pair",
           "instrument_engine", "instrument_pool", "instrument_batcher",
           "instrument_metrics"]

_ACTIVE: Optional["ResourceTracker"] = None


def enabled() -> bool:
    """True when the ``SPARKFLOW_TPU_RESTRACK`` env flag asks chaos/test
    harnesses to run under a tracker."""
    return os.environ.get("SPARKFLOW_TPU_RESTRACK", "") not in ("", "0")


def active() -> Optional["ResourceTracker"]:
    """The installed tracker, or None (the common, zero-overhead case)."""
    return _ACTIVE


def _site_stack() -> str:
    frames = traceback.extract_stack()
    frames = [f for f in frames if not f.filename.endswith("restrack.py")]
    return "".join(traceback.format_list(frames[-8:])).rstrip()


@dataclass
class Violation:
    """A release with no matching acquire (double free / free of something
    the tracker never saw acquired)."""
    category: str
    key: Hashable
    stack: str


class ResourceTracker:
    """Per-resource acquire/release balance for one instrumented run.

    Keys are ``(category, key)`` — e.g. ``("kv-slot", 3)``,
    ``("http-conn", id(conn))``, ``("gauge-ns", "router/replica2/healthy")``.
    Same-key re-acquisition stacks pile up (balance 2 means two unpaid
    acquires). Use as a context manager or ``install()``/``uninstall()``;
    one tracker at a time, nesting restores the outer one.
    """

    def __init__(self):
        self._mu = threading.Lock()   # raw lock: must not track itself
        self._live: Dict[Tuple[str, Hashable], List[str]] = {}
        self.violations: List[Violation] = []
        self.acquired = 0
        self.released = 0
        self._prev: Optional[ResourceTracker] = None

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "ResourceTracker":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        _ACTIVE = self._prev
        self._prev = None

    def __enter__(self) -> "ResourceTracker":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- the pair protocol --------------------------------------------------

    def acquire(self, category: str, key: Hashable) -> None:
        stack = _site_stack()
        with self._mu:
            self._live.setdefault((category, key), []).append(stack)
            self.acquired += 1

    def release(self, category: str, key: Hashable) -> None:
        with self._mu:
            stacks = self._live.get((category, key))
            if not stacks:
                self.violations.append(
                    Violation(category, key, _site_stack()))
                return
            stacks.pop()
            if not stacks:
                del self._live[(category, key)]
            self.released += 1

    def release_if_live(self, category: str, key: Hashable) -> bool:
        """Release only if the key has unpaid acquires — for release verbs
        that are legal on an already-released resource (``truncate`` after
        ``free``, pool ``close`` after drain). Returns whether it paid one
        down."""
        with self._mu:
            if not self._live.get((category, key)):
                return False
        self.release(category, key)
        return True

    # -- results ------------------------------------------------------------

    def balance(self, category: Optional[str] = None) -> int:
        """Outstanding acquires (optionally for one category). Zero at the
        end of a clean run."""
        with self._mu:
            return sum(len(s) for (cat, _), s in self._live.items()
                       if category is None or cat == category)

    def live(self) -> Dict[Tuple[str, Hashable], List[str]]:
        """{(category, key): acquisition stacks} for everything unpaid."""
        with self._mu:
            return {k: list(v) for k, v in self._live.items()}

    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        for (cat, key), stacks in sorted(self.live().items(),
                                         key=lambda kv: repr(kv[0])):
            out.append(Finding(
                "GC-X605",
                f"{cat}[{key!r}]: {len(stacks)} acquire(s) never released "
                f"by the end of the run — the acquisition stack(s) in "
                f"detail name the leak site",
                source="restrack",
                detail={"category": cat, "key": repr(key),
                        "balance": len(stacks), "stacks": stacks}))
        with self._mu:
            viols = list(self.violations)
        for v in viols:
            out.append(Finding(
                "GC-X605",
                f"{v.category}[{v.key!r}]: released with no matching "
                f"acquire (double free, or acquired before the tracker "
                f"was installed)",
                source="restrack",
                detail={"category": v.category, "key": repr(v.key),
                        "double_release": True, "stacks": [v.stack]}))
        return out

    def report(self) -> List[Finding]:
        """Alias of :meth:`findings` — the name the smokes print under."""
        return self.findings()

    def assert_balanced(self) -> None:
        """Raise AssertionError with acquisition stacks if anything is
        unbalanced."""
        fs = self.findings()
        if not fs:
            return
        parts = []
        for f in fs:
            parts.append(f.render())
            for s in f.detail.get("stacks", []):
                parts.append(_indent(str(s)))
        raise AssertionError(
            f"restrack: {len(fs)} unbalanced resource(s)\n"
            + "\n".join(parts))


def _indent(text: str, pad: str = "    ") -> str:
    return "\n".join(pad + ln for ln in text.splitlines())


# -- instrumentation ----------------------------------------------------------


def instrument_pair(obj: object, category: str, acquire: str,
                    releases: Sequence[str],
                    key_of: Callable[..., Hashable],
                    key_of_release: Optional[Callable[..., Hashable]] = None,
                    idempotent_releases: Sequence[str] = ()):
    """Generic pair wrapper (no-op without an active tracker): shadow
    ``obj.<acquire>`` and each ``obj.<release>`` with bound wrappers that
    record the balance. ``key_of(result, *args, **kw)`` maps an acquire
    call to its resource key; ``key_of_release(*args, **kw)`` (default: the
    first positional argument) maps a release call. Verbs listed in
    ``idempotent_releases`` only pay down live balances (legal on an
    already-released resource). Returns ``obj``."""
    t = _ACTIVE
    if t is None:
        return obj

    orig_acquire = getattr(obj, acquire)

    def acq_wrapper(*a, **kw):
        result = orig_acquire(*a, **kw)
        key = key_of(result, *a, **kw)
        if key is not None:
            t.acquire(category, key)
        return result

    setattr(obj, acquire, acq_wrapper)
    for rel in releases:
        orig_rel = getattr(obj, rel)
        idem = rel in idempotent_releases

        def rel_wrapper(*a, _orig=orig_rel, _idem=idem, **kw):
            key = (key_of_release(*a, **kw) if key_of_release is not None
                   else (a[0] if a else None))
            if key is not None:
                if _idem:
                    t.release_if_live(category, key)
                else:
                    t.release(category, key)
            return _orig(*a, **kw)

        setattr(obj, rel, rel_wrapper)
    return obj


def instrument_engine(engine):
    """Track decode-slot checkout on a :class:`DecodeEngine`:
    ``prefill`` acquires the slot its result names, ``release`` pays it
    back. The engine releases its KV pages inside ``release`` under its
    own lock, so slot balance == page-holding-sequence balance. No-op
    without an active tracker; returns ``engine``."""
    return instrument_pair(
        engine, "decode-slot", "prefill", ("release",),
        key_of=lambda info, *a, **kw: int(info["slot"]),
        key_of_release=lambda slot, *a, **kw: int(slot))


def instrument_pool(pool):
    """Track checkouts on a :class:`ConnectionPool`: ``acquire`` checks a
    connection out, ``release`` (either reuse flavor) returns it. No-op
    without an active tracker; returns ``pool``."""
    return instrument_pair(
        pool, "http-conn", "acquire", ("release",),
        key_of=lambda result, *a, **kw: id(result[0]),
        key_of_release=lambda conn, *a, **kw: id(conn))


def instrument_batcher(batcher):
    """Track admissions on a :class:`ContinuousBatcher`: an admission is
    acquired when ``_try_admit_locked`` pops a request and released when
    that request's future resolves — which covers every retirement path
    (normal finish, prefill failure, close/drain abandonment) because each
    of them must resolve the future for the caller to unblock. No-op
    without an active tracker; returns ``batcher``."""
    t = _ACTIVE
    if t is None:
        return batcher
    orig = batcher._try_admit_locked

    def admit_wrapper():
        req = orig()
        if req is not None:
            key = id(req)
            t.acquire("batch-slot", key)
            req.future.add_done_callback(
                lambda _f: t.release("batch-slot", key))
        return req

    batcher._try_admit_locked = admit_wrapper
    return batcher


def instrument_metrics(metrics, prefixes: Sequence[str]):
    """Track per-entity gauge namespaces on a
    :class:`~sparkflow_tpu.utils.metrics.Metrics` registry: a ``gauge()``
    whose name starts with one of ``prefixes`` and wasn't registered
    before acquires that name; ``remove_prefix``/``remove_matching``/
    ``reset`` release every tracked name they drop. Names outside
    ``prefixes`` (process-level gauges) are not tracked — only per-entity
    families must come down with their entity. No-op without an active
    tracker; returns ``metrics``."""
    t = _ACTIVE
    if t is None:
        return metrics
    prefixes = tuple(prefixes)
    seen: set = set()
    mu = threading.Lock()

    orig_gauge = metrics.gauge
    orig_remove_prefix = metrics.remove_prefix
    orig_remove_matching = getattr(metrics, "remove_matching", None)
    orig_reset = metrics.reset

    def gauge_wrapper(name, value):
        with mu:
            fresh = (name not in seen
                     and any(name.startswith(p) for p in prefixes))
            if fresh:
                seen.add(name)
        if fresh:
            t.acquire("gauge-ns", name)
        return orig_gauge(name, value)

    def _drop(names):
        with mu:
            dropped = [n for n in names if n in seen]
            seen.difference_update(dropped)
        for n in dropped:
            t.release("gauge-ns", n)

    def remove_prefix_wrapper(prefix):
        with mu:
            names = [n for n in seen if n.startswith(prefix)]
        removed = orig_remove_prefix(prefix)
        _drop(names)
        return removed

    def remove_matching_wrapper(match):
        pred = match if callable(match) else re.compile(match).search
        with mu:
            names = [n for n in seen if pred(n)]
        removed = orig_remove_matching(match)
        _drop(names)
        return removed

    def reset_wrapper():
        with mu:
            names = list(seen)
        orig_reset()
        _drop(names)

    metrics.gauge = gauge_wrapper
    metrics.remove_prefix = remove_prefix_wrapper
    if orig_remove_matching is not None:
        metrics.remove_matching = remove_matching_wrapper
    metrics.reset = reset_wrapper
    return metrics
