"""Deterministic fault injection for chaos testing.

Two complementary mechanisms:

1. **Named fault points.** Production code calls :func:`fire` at a handful of
   interesting places (``"engine.predict"`` in the serving engine,
   ``"checkpoint.pre_commit"`` between a checkpoint's tmp-dir write and its
   atomic rename, ``"elastic.push"`` / ``"elastic.pull"`` around the elastic
   parameter store's weight/gradient exchange, ``"router.dispatch"`` /
   ``"replica.predict"`` around the serving router's admission and its
   per-replica forwarding attempts, ``"weights.publish_commit"`` between a
   weight publication's manifest write and its atomic rename,
   ``"weights.pull"`` on every ``WeightStore.load``, and ``"engine.swap"``
   inside the engines' hot-swap paths). The call is a no-op dict
   probe unless a test has armed the
   point via the :func:`inject` context manager — which can raise a chosen
   exception on chosen call indices (or with a seeded probability) and/or
   delay calls, all reproducibly.

2. **Out-of-band injectors.** Helpers that damage state the way real failures
   do: :func:`crash_at` / :func:`sigterm_at` build Trainer ``loss_callback``
   hooks that blow up (or deliver a real SIGTERM) at a chosen epoch exactly
   once, and :func:`corrupt_file` / :func:`truncate_file` tear files on disk
   (byte flips, truncation) so fallback paths are exercised against genuine
   corruption; :func:`corrupt_latest_checkpoint` /
   :func:`corrupt_latest_weights` aim them at the newest checkpoint step or
   published weight version.

Everything is seeded/counted — the same test run injects the same faults.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["InjectedFault", "inject", "fire", "crash_at", "sigterm_at",
           "corrupt_file", "truncate_file", "corrupt_latest_checkpoint",
           "corrupt_latest_weights"]


class InjectedFault(Exception):
    """The default exception raised at an armed fault point."""


_LOCK = threading.Lock()
_ACTIVE: Dict[str, "_FaultSpec"] = {}


class _FaultSpec:
    """One armed fault point: which calls fail/delay, with what."""

    def __init__(self, point: str, fail_calls: Iterable[int], p_fail: float,
                 exc, delay_ms: float, seed: int,
                 max_failures: Optional[int]):
        self.point = point
        self.fail_calls = frozenset(fail_calls)
        self.p_fail = float(p_fail)
        self.exc = exc
        self.delay_ms = float(delay_ms)
        self.max_failures = max_failures
        self.calls = 0
        self.failures = 0
        self._rng = random.Random(seed)

    def on_call(self, sleep=None) -> None:
        with _LOCK:
            i = self.calls
            self.calls += 1
            # draw under the lock so concurrent callers consume the seeded
            # stream in a serialized (reproducible-per-call-index) order
            u = self._rng.random()
            should_fail = (i in self.fail_calls or u < self.p_fail)
            if should_fail and (self.max_failures is not None
                                and self.failures >= self.max_failures):
                should_fail = False
            if should_fail:
                self.failures += 1
        if self.delay_ms > 0:
            (sleep or time.sleep)(self.delay_ms / 1000.0)
        if should_fail:
            exc = self.exc
            raise (exc(f"injected fault at {self.point!r} (call {i})")
                   if isinstance(exc, type) else exc)


def fire(point: str, *, sleep=None) -> None:
    """Fault-point hook for production code: no-op unless a test armed
    ``point`` via :func:`inject` (then it may delay and/or raise).

    ``sleep`` overrides how an injected ``delay_ms`` waits — virtual-time
    harnesses (``parallel.elastic``'s simulated clock) pass an advance
    function so delays cost simulated, not real, seconds."""
    if not _ACTIVE:  # fast path: nothing armed anywhere
        return
    spec = _ACTIVE.get(point)
    if spec is not None:
        spec.on_call(sleep)


@contextmanager
def inject(point: str, *, fail_calls: Iterable[int] = (), p_fail: float = 0.0,
           exc=InjectedFault, delay_ms: float = 0.0, seed: int = 0,
           max_failures: Optional[int] = None):
    """Arm ``point`` for the duration of the block.

    ``fail_calls`` are 0-based call indices that raise ``exc``; ``p_fail``
    adds a seeded per-call failure probability; ``delay_ms`` sleeps every
    call (latency injection); ``max_failures`` caps total raises so a
    retried operation eventually succeeds. Yields the spec (``.calls`` /
    ``.failures`` counters for assertions).
    """
    spec = _FaultSpec(point, fail_calls, p_fail, exc, delay_ms, seed,
                      max_failures)
    with _LOCK:
        if point in _ACTIVE:
            raise RuntimeError(f"fault point {point!r} is already armed")
        _ACTIVE[point] = spec
    try:
        yield spec
    finally:
        with _LOCK:
            _ACTIVE.pop(point, None)


# -- trainer-side injectors (loss_callback hooks) ---------------------------

def crash_at(step: int, exc=None, times: int = 1):
    """A Trainer ``loss_callback`` that raises at epoch/step ``step``, at
    most ``times`` times total (so the resumed run passes the same step).
    The returned hook carries a ``.fired`` counter."""

    def cb(loss, iteration, partition_id):
        if iteration == step and cb.fired < times:
            cb.fired += 1
            raise exc if exc is not None else InjectedFault(
                f"injected crash at step {step}")

    cb.fired = 0
    return cb


def sigterm_at(step: int, times: int = 1):
    """A Trainer ``loss_callback`` that delivers a real SIGTERM to this
    process at epoch/step ``step`` (at most ``times`` times) — the
    preemption path (``utils.preempt.PreemptionGuard``), not an exception."""

    def cb(loss, iteration, partition_id):
        if iteration == step and cb.fired < times:
            cb.fired += 1
            os.kill(os.getpid(), signal.SIGTERM)

    cb.fired = 0
    return cb


# -- on-disk corruption ------------------------------------------------------

def corrupt_file(path: str, mode: str = "flip", seed: int = 0,
                 nbytes: int = 16) -> None:
    """Damage ``path`` in place: ``'flip'`` xors ``nbytes`` seeded positions
    with 0xFF; ``'truncate'`` keeps the first half; ``'empty'`` zero-lengths
    it."""
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        return
    if mode == "empty":
        with open(path, "w"):
            pass
        return
    if mode != "flip":
        raise ValueError(f"mode must be flip|truncate|empty, got {mode!r}")
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if not data:
            data = bytearray(b"\x00")
        rng = random.Random(seed)
        for _ in range(min(nbytes, len(data))):
            i = rng.randrange(len(data))
            data[i] ^= 0xFF
        f.seek(0)
        f.write(bytes(data))
        f.truncate(len(data))


def truncate_file(path: str, keep_bytes: int = 0) -> None:
    """Truncate ``path`` to ``keep_bytes`` (a torn write)."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def corrupt_latest_checkpoint(directory: str, mode: str = "flip",
                              seed: int = 0) -> Tuple[int, str]:
    """Corrupt the newest checkpoint under a
    :class:`~sparkflow_tpu_torch.checkpoint.CheckpointManager` directory the way a
    crash or bit-rot would, returning ``(step, damaged_path)``.

    Modes: ``'flip'`` / ``'truncate'`` damage the largest data file of the
    step (manifest checksum then catches it); ``'manifest'`` garbles the
    step's manifest.json; ``'latest_json'`` garbles the ``latest.json``
    pointer (``latest_step`` must fall back to scanning).
    """
    from ..checkpoint import MANIFEST_NAME, CheckpointManager
    mgr = CheckpointManager(directory)
    if mode == "latest_json":
        p = os.path.join(mgr.directory, "latest.json")
        with open(p, "w") as f:
            f.write('{"latest_step": 9')  # torn mid-write
        steps = mgr.all_steps()
        return (steps[-1] if steps else -1), p
    steps = mgr.all_steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1]
    step_dir = mgr._step_dir(step)
    if mode == "manifest":
        p = os.path.join(step_dir, MANIFEST_NAME)
        corrupt_file(p, "truncate", seed=seed)
        return step, p
    candidates = []
    for root, _dirs, names in os.walk(step_dir):
        for nm in names:
            if nm == MANIFEST_NAME:
                continue
            full = os.path.join(root, nm)
            candidates.append((os.path.getsize(full), full))
    if not candidates:
        raise FileNotFoundError(f"checkpoint step {step} has no data files")
    # the largest file holds the arrays — damaging it is the realistic tear
    _size, target = max(candidates, key=lambda t: (t[0], t[1]))
    corrupt_file(target, mode, seed=seed)
    return step, target


def corrupt_latest_weights(directory: str, mode: str = "flip",
                           seed: int = 0) -> Tuple[int, str]:
    """Corrupt the newest published version under a
    :class:`~sparkflow_tpu_torch.serving.weightstore.WeightStore` directory the
    way a crash or bit-rot would, returning ``(version, damaged_path)`` —
    the weight-publication mirror of :func:`corrupt_latest_checkpoint`.

    Modes: ``'flip'`` / ``'truncate'`` damage the version's weight file
    (the manifest checksum then catches it); ``'manifest'`` garbles the
    version's manifest.json; ``'latest_json'`` garbles the ``latest.json``
    pointer (``latest_version`` must fall back to scanning).
    """
    from ..serving.weightstore import (MANIFEST_NAME, WEIGHTS_NAME,
                                       WeightStore)
    store = WeightStore(directory)
    if mode == "latest_json":
        p = os.path.join(store.directory, "latest.json")
        with open(p, "w") as f:
            f.write('{"latest_version": 9')  # torn mid-write
        vs = store.all_versions()
        return (vs[-1] if vs else -1), p
    vs = store.all_versions()
    if not vs:
        raise FileNotFoundError(f"no published weights under {directory}")
    version = vs[-1]
    vdir = store._version_dir(version)
    if mode == "manifest":
        p = os.path.join(vdir, MANIFEST_NAME)
        corrupt_file(p, "truncate", seed=seed)
        return version, p
    target = os.path.join(vdir, WEIGHTS_NAME)
    corrupt_file(target, mode, seed=seed)
    return version, target
