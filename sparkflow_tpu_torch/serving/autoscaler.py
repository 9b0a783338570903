"""Self-healing elastic fleet: process supervisor + autoscaler daemon —
carried unchanged from the JAX package's ``serving/autoscaler.py``.

Two classes, one line between them:

- :class:`ReplicaManager` is *transport*: it spawns real
  :class:`~sparkflow_tpu_torch.serving.server.InferenceServer` processes (via a
  caller-supplied ``launcher``), waits for ``/healthz``, registers them
  with :class:`~sparkflow_tpu_torch.serving.membership.Membership`, SIGTERM-
  drains them on scale-down (the server's drain machinery finishes in-flight
  work behind a 503 ``/healthz``), hard-kills the ones that will not die,
  and reaps exit codes so a crash is noticed within one tick rather than
  after ``failure_threshold`` probe misses.
- :class:`Autoscaler` is the *control loop*: each tick it reaps crashes,
  snapshots the fleet (``Membership.views()`` — router-side in-flight,
  probe-reported ``decode/{free_slots,pages_free}``), reads the queue-wait
  p95 from the router's ``router/request_ms`` histogram, and feeds all of
  it to the pure :func:`~sparkflow_tpu_torch.serving.policies.scale_decision` —
  the SAME function the fleet simulator replays, so bands and cooldowns
  tuned in ``sparkflow_tpu_torch.sim`` transfer to production unchanged. The
  daemon only *applies* the returned action.

Failure discipline:

- ``spawn`` fires the ``autoscaler.spawn`` fault point and is bounded by
  a :class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy` — a replica that
  dies before becoming healthy is killed and retried with backoff, and
  :class:`~sparkflow_tpu_torch.resilience.retry.RetryExhausted` surfaces to the
  tick loop, which logs, counts, and tries again next tick (the policy's
  below-min rule keeps asking until the fleet recovers).
- ``drain`` fires ``autoscaler.drain``; a replica that ignores SIGTERM
  past ``drain_timeout_s`` is SIGKILLed — scale-down must converge.
- Crash replacement deregisters the dead record (its gauges go with it)
  and spawns a fresh process; the replacement gets a never-recycled index.

The tick publishes ``autoscaler/{replicas,target,spawns,drains,
replacements,last_decision}`` gauges so the exposition shows what the
controller last did and why-shaped counters accumulate across the run.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.flight import harvest_flight
from ..resilience import faults
from ..resilience.retry import RetryExhausted, RetryPolicy
from ..utils import metrics as metrics_mod
from . import policies
from .client import ServingClient
from .membership import BreakerState, Membership, Replica

__all__ = ["Autoscaler", "ReplicaManager", "free_port"]

logger = logging.getLogger("sparkflow_tpu_torch")

# numeric codes for the autoscaler/last_decision gauge (Prometheus gauges
# are floats; the mapping is part of the exposition contract)
DECISION_CODES = {policies.SCALE_HOLD: 0.0, policies.SCALE_UP: 1.0,
                  policies.SCALE_DOWN: 2.0, policies.SCALE_REPLACE: 3.0}


def free_port() -> int:
    """An OS-assigned free TCP port (racy by nature; spawn retries absorb
    the rare collision)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Managed:
    """One supervised replica process: the Popen-like handle (``poll`` /
    ``terminate`` / ``kill`` / ``wait``), its URL, and the Membership
    record it registered as."""

    __slots__ = ("proc", "url", "replica")

    def __init__(self, proc, url: str, replica: Replica):
        self.proc = proc
        self.url = url
        self.replica = replica


class ReplicaManager:
    """Spawns, drains, kills, and reaps replica server processes.

    Parameters
    ----------
    launcher : Callable[[int], process]
        Starts a replica server on the given port and returns a
        Popen-like handle (``poll()``, ``terminate()``, ``kill()``,
        ``wait(timeout)``). Tests pass fakes; examples re-invoke
        themselves with ``--replica PORT``.
    membership : Membership
        Fleet table new replicas register with (and leave on drain).
    retry : RetryPolicy, optional
        Bounds spawn attempts (default: 3 attempts, 0.2 s base backoff).
    health_timeout_s : float
        How long one spawn attempt waits for a green ``/healthz`` before
        the process is killed and the attempt counts as failed.
    drain_timeout_s : float
        SIGTERM-to-SIGKILL grace on scale-down.
    flight_dir : str, optional
        Directory where managed replicas write their flight-recorder
        files (``replica-<port>.jsonl``). When set, :meth:`drain` and
        :meth:`destroy` harvest the dead replica's record — in-flight
        trace ids and the last dumped spans — into
        :attr:`flight_reports` before the record is dropped.
    """

    def __init__(self, launcher: Callable[[int], object], *,
                 membership: Membership,
                 retry: Optional[RetryPolicy] = None,
                 port_factory: Callable[[], int] = free_port,
                 health_timeout_s: float = 60.0,
                 drain_timeout_s: float = 10.0,
                 poll_interval_s: float = 0.2,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 flight_dir: Optional[str] = None):
        self.launcher = launcher
        self.membership = membership
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_s=0.2, max_s=2.0)
        self.port_factory = port_factory
        self.health_timeout_s = float(health_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.metrics = (metrics if metrics is not None
                        else membership.metrics)
        self.flight_dir = flight_dir
        self._lock = threading.Lock()
        self._managed: Dict[int, _Managed] = {}  # replica.index -> record
        # harvested flight records of dead replicas, newest last (bounded)
        self.flight_reports: List[Dict[str, Any]] = []

    # -- introspection -------------------------------------------------------

    def owns(self, replica: Replica) -> bool:
        with self._lock:
            return replica.index in self._managed

    @property
    def managed_count(self) -> int:
        with self._lock:
            return len(self._managed)

    def managed(self) -> List[Replica]:
        with self._lock:
            return [m.replica for m in self._managed.values()]

    # -- spawn ---------------------------------------------------------------

    def _wait_healthy(self, url: str, proc) -> None:
        client = ServingClient(url, retries=0)
        try:
            deadline = time.monotonic() + self.health_timeout_s
            while time.monotonic() < deadline:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"replica at {url} exited with code "
                        f"{proc.poll()} before becoming healthy")
                try:
                    if client.healthz(timeout_s=1.0).get("status") == "ok":
                        return
                except Exception:  # noqa: BLE001 - not up yet
                    pass
                time.sleep(self.poll_interval_s)
            raise TimeoutError(f"replica at {url} not healthy within "
                               f"{self.health_timeout_s:.0f}s")
        finally:
            client.close()

    def _spawn_attempt(self) -> Tuple[object, str]:
        # the fault point sits INSIDE the attempt so an injected failure
        # exercises the retry path, not just the caller's error handling
        faults.fire("autoscaler.spawn")
        port = self.port_factory()
        url = f"http://127.0.0.1:{port}"
        proc = self.launcher(port)
        try:
            self._wait_healthy(url, proc)
        except Exception:
            # a half-started process must not leak past a failed attempt
            try:
                proc.kill()
                proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001 - already gone
                pass
            raise
        return proc, url

    def spawn(self) -> Replica:
        """Start one replica, wait for health, register it. Retries are
        bounded by the manager's ``RetryPolicy``; exhaustion raises
        :class:`RetryExhausted` to the caller (the autoscaler tick)."""
        proc, url = self.retry.call(self._spawn_attempt,
                                    describe="autoscaler.spawn")
        replica = self.membership.register(url)
        with self._lock:
            self._managed[replica.index] = _Managed(proc, url, replica)
        self.metrics.incr("autoscaler/spawn_total")
        logger.info("autoscaler: spawned replica %s (index %d)",
                    url, replica.index)
        return replica

    def adopt(self, replica: Replica, proc, url: Optional[str] = None
              ) -> None:
        """Take over supervision of an already-running replica process —
        the founding fleet a RouterServer was created with, so crash
        replacement and drain cover it too."""
        with self._lock:
            self._managed[replica.index] = _Managed(
                proc, url if url is not None else replica.url, replica)

    # -- drain / kill / reap -------------------------------------------------

    def _pop(self, replica: Replica) -> Optional[_Managed]:
        with self._lock:
            return self._managed.pop(replica.index, None)

    def _harvest(self, replica: Replica, reason: str) -> None:
        """Read the dead replica's flight-recorder file (after the process
        is gone, so the file is settled) and keep the report: which trace
        ids were in flight when it died, plus the last dumped spans if the
        death was graceful enough to dump (SIGTERM yes, SIGKILL no)."""
        path = replica.flight_path
        if path is None and self.flight_dir is not None:
            path = os.path.join(self.flight_dir,
                                f"replica-{replica.port}.jsonl")
        if path is None:
            return
        try:
            report = harvest_flight(path)
        except Exception:  # noqa: BLE001 - torn file must not block reaping
            logger.exception("autoscaler: flight harvest failed for %s",
                             replica.url)
            return
        if report is None:
            return
        report["replica_url"] = replica.url
        # "reason" (if present) is the replica's own dump reason, e.g.
        # "signal:15"; this is why the MANAGER removed it
        report["harvest_reason"] = reason
        with self._lock:
            self.flight_reports.append(report)
            del self.flight_reports[:-64]
        self.metrics.incr("autoscaler/flight_harvested")
        inflight = report.get("inflight_trace_ids", [])
        if inflight:
            logger.warning(
                "autoscaler: replica %s died (%s) with %d in-flight "
                "trace(s): %s", replica.url, reason, len(inflight),
                ", ".join(inflight[:8]))

    def drain(self, replica: Replica, reason: str = "scale-down") -> None:
        """Graceful scale-down: eject from rotation now, SIGTERM (the
        server's lifecycle finishes in-flight work), wait, SIGKILL past
        the grace, deregister (gauges drop with the record)."""
        faults.fire("autoscaler.drain")
        m = self._pop(replica)
        self.membership.eject(replica, reason)
        if m is not None:
            try:
                m.proc.terminate()
                m.proc.wait(timeout=self.drain_timeout_s)
            except Exception:  # noqa: BLE001 - stuck past the grace
                logger.warning("autoscaler: replica %s ignored SIGTERM; "
                               "killing", replica.url)
                try:
                    m.proc.kill()
                    m.proc.wait(timeout=5.0)
                except Exception:  # noqa: BLE001 - already gone
                    pass
        self._harvest(replica, reason)
        self.membership.deregister(replica)
        logger.info("autoscaler: drained replica %s (%s)",
                    replica.url, reason)

    def destroy(self, replica: Replica, reason: str = "crash") -> None:
        """Hard removal (crash replacement): kill whatever is left of the
        process and drop the record — no drain, the work is already lost."""
        m = self._pop(replica)
        if m is not None and m.proc.poll() is None:
            try:
                m.proc.kill()
                m.proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001 - already gone
                pass
        self._harvest(replica, reason)
        self.membership.deregister(replica)
        logger.warning("autoscaler: destroyed replica %s (%s)",
                       replica.url, reason)

    def reap(self) -> List[Tuple[Replica, int]]:
        """Exit-code sweep: every managed process that has terminated,
        as ``(replica, returncode)``. The records stay managed — the
        autoscaler decides whether the death is a crash to replace or a
        drain that already completed elsewhere."""
        dead = []
        with self._lock:
            for m in self._managed.values():
                rc = m.proc.poll()
                if rc is not None:
                    dead.append((m.replica, rc))
        return dead

    def stop_all(self, *, kill: bool = False) -> None:
        """Tear down every managed replica (test/example cleanup)."""
        for replica in self.managed():
            if kill:
                self.destroy(replica, reason="shutdown")
            else:
                self.drain(replica, reason="shutdown")


class Autoscaler:
    """Daemon that closes the loop between fleet telemetry and the pure
    scaling policy.

    Each :meth:`tick`:

    1. reaps crashed processes (``ReplicaManager.reap``) and trips their
       breakers/health so the router stops picking them immediately;
    2. snapshots the fleet (``Membership.views()``), marking reaped and
       breaker-open replicas unhealthy — the policy sees crashes the
       prober has not noticed yet;
    3. reads the queue-wait p95 signal (default: the router's
       ``router/request_ms`` histogram; injectable for tests);
    4. calls :func:`policies.scale_decision` with the carried
       :class:`policies.AutoscalerState`;
    5. applies the action — spawn / drain / destroy+respawn — and
       publishes the ``autoscaler/*`` gauges.

    ``start()`` runs ticks on a daemon thread every ``interval_s``;
    ``tick()`` is public so tests and examples can step the loop
    deterministically.
    """

    def __init__(self, membership: Membership, manager: ReplicaManager, *,
                 targets: Optional[policies.ScaleTargets] = None,
                 interval_s: float = 1.0,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 queue_wait_signal: Optional[
                     Callable[[], Optional[float]]] = None,
                 signal_name: str = "router/request_ms",
                 signal_window: int = 256):
        self.membership = membership
        self.manager = manager
        self.targets = targets if targets is not None \
            else policies.ScaleTargets()
        self.interval_s = float(interval_s)
        self.metrics = (metrics if metrics is not None
                        else membership.metrics)
        self._clock = clock
        self.signal_name = signal_name
        self.signal_window = int(signal_window)
        self._signal = queue_wait_signal
        self.state = policies.AutoscalerState(
            desired=max(self.targets.min_replicas,
                        len(membership.replicas)))
        self.spawns = 0
        self.drains = 0
        self.replacements = 0
        self.spawn_failures = 0
        self.last_action: Optional[policies.ScaleAction] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal --------------------------------------------------------------

    def queue_wait_p95_ms(self) -> Optional[float]:
        """The scaling signal: p95 of the router's end-to-end request
        latency histogram (queue wait dominates it under saturation),
        windowed to the last ``signal_window`` samples so a long-past
        overload burst doesn't pin the signal high forever. None while
        the histogram is empty (idle fleet)."""
        if self._signal is not None:
            return self._signal()
        try:
            return self.metrics.percentile(self.signal_name, 95,
                                           window=self.signal_window)
        except (KeyError, ValueError):
            return None

    # -- one tick ------------------------------------------------------------

    def tick(self) -> policies.ScaleAction:
        now = self._clock()

        # 1. exit-code reaping: a crash is actionable this tick, not
        #    failure_threshold probe intervals from now
        reaped: Dict[int, Replica] = {}
        for replica, rc in self.manager.reap():
            reaped[replica.index] = replica
            self.membership.eject(replica, f"exit code {rc}")
            logger.warning("autoscaler: replica %s exited with code %d",
                           replica.url, rc)

        # 2. fleet snapshot; reaped + breaker-open managed replicas are
        #    dead to the policy even if their last probe was green (the
        #    overlay clears the probe-miss debounce: an exit code or a
        #    tripped breaker is definitive, a single missed probe is not),
        #    and unmanaged (founding-fleet) records are flagged so the
        #    policy never orders a kill there is no process handle for
        managed = self.manager.managed()
        managed_idx = {r.index for r in managed}
        tripped = {r.index for r in managed
                   if r.breaker.state is BreakerState.OPEN}
        views = []
        for v in self.membership.views(now):
            if v.index in reaped or v.index in tripped:
                v = dataclasses.replace(
                    v, healthy=False,
                    probe_misses=max(v.probe_misses,
                                     self.targets.dead_after_misses))
            if v.index not in managed_idx:
                v = dataclasses.replace(v, managed=False)
            views.append(v)

        # 3-4. the pure decision
        action = policies.scale_decision(
            views, self.targets, self.state, now,
            queue_wait_p95_ms=self.queue_wait_p95_ms())

        # 5. apply
        by_index = {r.index: r for r in self.membership.replicas}
        if action.kind == policies.SCALE_REPLACE:
            for idx in action.targets:
                replica = reaped.get(idx) or by_index.get(idx)
                # the policy only targets managed views; the owns() check
                # guards the race where a drain landed between snapshot
                # and apply. Unmanaged records are never destroyed or
                # deregistered here — a recovered probe re-admits them,
                # and the below-min rule refills capacity around them.
                if replica is None or not self.manager.owns(replica):
                    continue
                self.manager.destroy(replica)
                try:
                    self.manager.spawn()
                    self.replacements += 1
                    self.spawns += 1
                except RetryExhausted as exc:
                    # next tick sees the fleet below min and retries
                    self.spawn_failures += 1
                    logger.error("autoscaler: replacement spawn failed "
                                 "(%s); will retry next tick", exc)
        elif action.kind == policies.SCALE_UP:
            for _ in range(action.count):
                try:
                    self.manager.spawn()
                    self.spawns += 1
                except RetryExhausted as exc:
                    self.spawn_failures += 1
                    logger.error("autoscaler: scale-up spawn failed (%s); "
                                 "will retry next tick", exc)
                    break
        elif action.kind == policies.SCALE_DOWN:
            applied = 0
            for idx in action.targets:
                replica = by_index.get(idx)
                if replica is None or not self.manager.owns(replica):
                    logger.info("autoscaler: skipping scale-down of "
                                "unmanaged or departed replica %d", idx)
                    continue
                self.manager.drain(replica)
                self.drains += 1
                applied += 1
            if applied == 0:
                # nothing actually drained: committing the successor state
                # would drift the target gauge below the real fleet size
                # and burn the down-cooldown on a no-op
                action = dataclasses.replace(action, state=self.state)

        self.state = action.state
        self.last_action = action
        self.publish_gauges()
        return action

    def publish_gauges(self) -> None:
        m = self.metrics
        m.gauge("autoscaler/replicas", float(len(self.membership.replicas)))
        m.gauge("autoscaler/target", float(self.state.desired))
        m.gauge("autoscaler/spawns", float(self.spawns))
        m.gauge("autoscaler/drains", float(self.drains))
        m.gauge("autoscaler/replacements", float(self.replacements))
        m.gauge("autoscaler/last_decision",
                DECISION_CODES.get(
                    self.last_action.kind if self.last_action else
                    policies.SCALE_HOLD, 0.0))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive a tick
                logger.exception("autoscaler: tick failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # a stopped autoscaler must not keep stale replicas/target in a
        # shared registry — the next controller would read its ghost
        self.metrics.remove_prefix("autoscaler/")
