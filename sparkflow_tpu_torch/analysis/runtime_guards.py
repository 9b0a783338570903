"""Runtime guards (GC-R4xx): catch silent shape churn while the program runs.

The port of the JAX package's ``analysis/runtime_guards.py``. JAX's guard
counts traces: ``jax.jit`` compiles once per argument signature, and the
guard's probe runs once per trace. PyTorch runs eagerly and traces
nothing, so this guard counts what a trace stood for: the distinct argument
signatures a guarded callable has run with. A signature leaf is a tensor's
(or array's) shape, dtype and device; a Python number's type (a JAX
argument of that kind is a weakly typed scalar, whose value retraces
nothing); a ``torch.Generator``'s device; and ``repr`` for anything else.
Arguments are flattened with ``torch.utils._pytree`` and named by its
``keystr`` paths (``[0]['params']...``, JAX's spelling), so a diff names
the leaf that changed. In the port a new signature is a shape run for the
first time — the first-use work :meth:`InferenceEngine.warmup` exists to
take off the request path — and, once fixed-shape steps are captured in
CUDA graphs, one capture each.

Two ways in, as in JAX:

- ``RecompileGuard(fn)`` — call the guard in ``fn``'s place.
  ``guard.retraces`` / ``guard.report()`` / ``guard.findings()``.
- ``guard.wrap(fn)`` — instrument ``fn`` where something else calls it
  (how the serving engines count their bucket ladders: every warmup
  signature is expected, anything after :meth:`mark_steady` is a
  regression).

:func:`track_recompiles` is the fit-level hook: inside the context every
``trace_probe``-instrumented function (the core train step and epoch)
reports the signatures it has not run with before to the tracker, and the
trainer's ``debug_recompiles=True`` wires it up end to end. A probe with no
tracker active costs one thread-local lookup per call.
"""

from __future__ import annotations

import functools
import logging
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .findings import Finding

__all__ = ["RecompileGuard", "track_recompiles", "trace_probe",
           "describe_signature_diff"]

logger = logging.getLogger("sparkflow_tpu_torch")

Signature = List[Tuple[str, Tuple]]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_sig(leaf) -> Tuple:
    if isinstance(leaf, torch.Tensor):
        return ("array", tuple(leaf.shape), _dtype_name(leaf.dtype),
                str(leaf.device))
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):   # numpy
        return ("array", tuple(leaf.shape), _dtype_name(leaf.dtype), "host")
    if isinstance(leaf, (bool, int, float, complex)):
        return ("scalar", type(leaf).__name__)
    if isinstance(leaf, torch.Generator):
        return ("generator", str(leaf.device))
    return ("static", repr(leaf))


def _flatten(tree, prefix: str = ""):
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        name = prefix + pytree.keystr(path)
        if leaf is None:          # JAX: an empty node, no leaf
            continue
        if isinstance(leaf, (list, tuple, dict)):
            # a container subclass torch's pytree does not know (the tp
            # serving trees' TPShards, EPShards): flatten it as its base
            base = dict if isinstance(leaf, dict) else list
            yield from _flatten(base(leaf), name)
        else:
            yield name, _leaf_sig(leaf)


def _signature(args: Tuple, kwargs: Dict) -> Signature:
    """Flat [(path, leaf signature)] for one call's arguments."""
    return list(_flatten((args, kwargs)))


def describe_signature_diff(old: Signature, new: Signature) -> str:
    """Human-readable first difference between two call signatures."""
    old_d, new_d = dict(old), dict(new)
    if set(old_d) != set(new_d):
        gained = sorted(set(new_d) - set(old_d))[:3]
        lost = sorted(set(old_d) - set(new_d))[:3]
        return (f"pytree structure changed (new leaves: {gained or '[]'}, "
                f"dropped leaves: {lost or '[]'})")
    diffs = []
    for path, sig in new:
        prev = old_d.get(path)
        if prev != sig:
            moved = (prev is not None and prev[0] == sig[0] == "array"
                     and prev[1:3] == sig[1:3])
            diffs.append(f"arg{path}: {_render_sig(prev, moved)} -> "
                         f"{_render_sig(sig, moved)}")
    if not diffs:
        return "signatures identical (cache evicted or first trace)"
    shown = "; ".join(diffs[:3])
    more = f" (+{len(diffs) - 3} more)" if len(diffs) > 3 else ""
    return shown + more


def _render_sig(sig: Optional[Tuple], device: bool = False) -> str:
    if sig is None:
        return "<absent>"
    if sig[0] == "array":
        _, shape, dtype, dev = sig
        return f"{dtype}{list(shape)}" + (f" on {dev}" if device else "")
    if sig[0] == "scalar":
        return f"python {sig[1]}"
    if sig[0] == "generator":
        return f"generator on {sig[1]}"
    return f"static {sig[1]}"


class _Seen:
    """The signatures one guarded callable has run with: the port's
    counterpart of a jitted function's compilation cache."""

    def __init__(self):
        self._keys: set = set()
        self._lock = threading.Lock()

    def first(self, sig: Signature) -> bool:
        key = tuple(sig)
        with self._lock:
            if key in self._keys:
                return False
            self._keys.add(key)
            return True


class RecompileGuard:
    """Count the distinct argument signatures of one callable and name what
    changed at each new one.

    Parameters
    ----------
    fn : callable | None
        With a function, the guard is called in its place. With None, use
        :meth:`wrap` to instrument a function something else calls.
    warn_after : int
        Signature count beyond which each further new signature logs a
        warning and :meth:`findings` reports GC-R401. The first is free; a
        bucket-ladder warmup should raise it (or use :meth:`mark_steady`).
    """

    def __init__(self, fn: Optional[Callable] = None, *,
                 name: Optional[str] = None, warn_after: int = 1):
        self.name = name or (getattr(fn, "__name__", "fn") if fn else "fn")
        self.warn_after = int(warn_after)
        self._lock = threading.Lock()
        self._sigs: List[Signature] = []
        self._causes: List[str] = []
        self._steady_at: Optional[int] = None
        self._fn = self.wrap(fn) if fn is not None else None

    def wrap(self, fn: Callable) -> Callable:
        """Instrument ``fn``: each call whose signature ``fn`` has not run
        with before is recorded as one trace."""
        seen = _Seen()

        @functools.wraps(fn)
        def probed(*args, **kwargs):
            sig = _signature(args, kwargs)
            if seen.first(sig):
                self._record(sig)
            return fn(*args, **kwargs)

        return probed

    def _record(self, sig: Signature) -> None:
        with self._lock:
            cause = (describe_signature_diff(self._sigs[-1], sig)
                     if self._sigs else "first trace")
            self._sigs.append(sig)
            self._causes.append(cause)
            traces = len(self._sigs)
            steady = self._steady_at
        if steady is not None and traces > steady:
            logger.warning("RecompileGuard[%s]: new signature after steady "
                           "state (#%d): %s", self.name, traces, cause)
        elif traces > self.warn_after:
            logger.warning("RecompileGuard[%s]: new signature #%d: %s",
                           self.name, traces, cause)

    def __call__(self, *args, **kwargs):
        if self._fn is None:
            raise TypeError("RecompileGuard was built without a function; "
                            "use .wrap(fn) and call the wrapped function")
        return self._fn(*args, **kwargs)

    # -- introspection -------------------------------------------------------

    @property
    def traces(self) -> int:
        with self._lock:
            return len(self._sigs)

    @property
    def retraces(self) -> int:
        return max(0, self.traces - 1)

    @property
    def causes(self) -> List[str]:
        with self._lock:
            return list(self._causes)

    def mark_steady(self) -> None:
        """Declare warmup over: every signature so far was expected, any
        new one after this is a regression (``steady_traces`` counts
        them)."""
        with self._lock:
            self._steady_at = len(self._sigs)

    @property
    def steady_traces(self) -> int:
        """New signatures since :meth:`mark_steady` (0 before it's
        called)."""
        with self._lock:
            if self._steady_at is None:
                return 0
            return len(self._sigs) - self._steady_at

    def findings(self) -> List[Finding]:
        out = []
        with self._lock:
            traces = len(self._sigs)
            causes = list(self._causes)
            steady = self._steady_at
        excess = (traces - steady if steady is not None
                  else traces - self.warn_after)
        if excess > 0 and traces > 1:
            out.append(Finding(
                "GC-R401",
                f"{self.name} traced {traces}x "
                f"({excess} beyond budget); last cause: {causes[-1]}",
                source="runtime_guard",
                detail={"traces": traces, "causes": causes}))
        return out

    def report(self) -> str:
        with self._lock:
            lines = [f"RecompileGuard[{self.name}]: "
                     f"{len(self._sigs)} trace(s)"]
            lines += [f"  #{i + 1}: {c}"
                      for i, c in enumerate(self._causes)]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# fit-level tracking: trace probes + an ambient tracker
# ---------------------------------------------------------------------------

_tracker_stack = threading.local()


def _current_tracker() -> Optional["_Tracker"]:
    stack = getattr(_tracker_stack, "stack", None)
    return stack[-1] if stack else None


class _Tracker:
    """Collects per-probe signatures inside a track_recompiles()."""

    def __init__(self, warn_after: int = 1):
        self.warn_after = warn_after
        self._lock = threading.Lock()
        self._sigs: Dict[str, List[Signature]] = {}
        self._causes: Dict[str, List[str]] = {}

    def record(self, name: str, sig: Signature) -> None:
        with self._lock:
            sigs = self._sigs.setdefault(name, [])
            causes = self._causes.setdefault(name, [])
            cause = (describe_signature_diff(sigs[-1], sig) if sigs
                     else "first trace")
            sigs.append(sig)
            causes.append(cause)
            count = len(sigs)
        if count > self.warn_after:
            logger.warning("recompile: %s traced #%d: %s", name, count,
                           cause)

    @property
    def traces(self) -> Dict[str, int]:
        with self._lock:
            return {k: len(v) for k, v in self._sigs.items()}

    def findings(self) -> List[Finding]:
        out = []
        with self._lock:
            items = [(k, len(v), self._causes[k][-1])
                     for k, v in self._sigs.items()]
        for name, count, last in items:
            if count > self.warn_after:
                out.append(Finding(
                    "GC-R401",
                    f"{name} traced {count}x inside one fit "
                    f"(budget {self.warn_after}); last cause: {last}",
                    source="runtime_guard",
                    detail={"traces": count}))
        return out

    def report(self) -> str:
        with self._lock:
            if not self._sigs:
                return "no traced builds inside track_recompiles()"
            lines = []
            for name, sigs in self._sigs.items():
                lines.append(f"{name}: {len(sigs)} trace(s)")
                lines += [f"  #{i + 1}: {c}"
                          for i, c in enumerate(self._causes[name])]
        return "\n".join(lines)


@contextmanager
def track_recompiles(warn_after: int = 1):
    """Activate signature tracking for ``trace_probe``-instrumented
    functions on this thread. Yields the tracker; read ``tracker.traces``
    / ``tracker.findings()`` / ``tracker.report()`` after the workload."""
    tracker = _Tracker(warn_after=warn_after)
    stack = getattr(_tracker_stack, "stack", None)
    if stack is None:
        stack = _tracker_stack.stack = []
    stack.append(tracker)
    try:
        yield tracker
    finally:
        stack.pop()


def trace_probe(fn: Callable, name: str) -> Callable:
    """Instrument ``fn`` so an ambient :func:`track_recompiles` tracker
    sees each signature it runs with for the first time. With no tracker
    active a call costs one thread-local lookup."""
    seen = _Seen()

    @functools.wraps(fn)
    def probed(*args, **kwargs):
        tracker = _current_tracker()
        if tracker is not None:
            sig = _signature(args, kwargs)
            if seen.first(sig):
                tracker.record(name, sig)
        return fn(*args, **kwargs)

    return probed
