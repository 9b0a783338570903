"""Bounded-staleness elastic async data parallelism — the Hogwild heritage,
modernized. The port of the JAX package's ``parallel/elastic.py``.

The reference's identity is asynchronous parameter-server training
(``sparkflow/HogwildSparkModel.py``: every Spark partition pushes gradients
to a Flask server whenever it finishes a mini-batch, lock-free). This module
keeps that async shape with modern bounds, per DeepSpark (arXiv:1602.08191)
and SSP-style staleness control:

- :class:`ElasticParamStore` — a versioned in-process parameter store. Each
  accepted gradient push bumps a monotonic weight version. A push carries
  the version its gradient was computed against (its *basis*); the gap to
  the current version is its **staleness**. Pushes within ``max_staleness``
  are accepted with a **dampening** scale (default ``1/(1+staleness)``);
  beyond the bound they are rejected and the replica must refresh — a
  straggler therefore *delays its own contribution*, never the fleet.
- **Immutable snapshots** — every accepted push publishes a NEW parameter
  tree (and optimizer state) under the store's lock; the tree a replica
  pulled (or received piggybacked on a push) never changes afterwards, as a
  pulled JAX tree never does. The port's in-place
  :func:`~sparkflow_tpu_torch.optimizers.apply_updates` is not used here.
- **Elastic membership** — replicas join/leave via heartbeat + lease: every
  pull/push renews the lease; a replica that goes quiet past
  ``lease_ttl_s`` is evicted and must re-join before its pushes count.
- **Dense vs sparse aggregation split** (Parallax, arXiv:1808.02621) —
  gradients route per-parameter by *density*: embedding-class tensors whose
  gradient touches only a few rows travel as :class:`SparseRows` (row
  indices + values). The nonzero rows are counted on the gradient's device,
  with one host read per push.
- **Deterministic chaos** — workers reach the store through an injectable
  transport; ``resilience.faults`` points ``"elastic.push"`` /
  ``"elastic.pull"`` inject delays and drops, and the virtual-time engine
  (:meth:`ElasticDPEngine.run_virtual`) replays stragglers and mid-step
  preemptions on a simulated clock with no sleeps.

Each replica computes its gradient with ``torch.autograd.grad`` on its own
leaf tensors (never into shared ``.grad`` fields). On the card every
replica thread launches on the current (default) stream, so their kernels
serialize on the one device, as the JAX package's threads do.

Observability: ``elastic/staleness`` histogram, ``elastic/replicas`` gauge,
``elastic/push_{accepted,rejected}`` / ``elastic/evicted`` counters, and a
span per push — all through the standard metrics registry.

Entry points: ``Trainer(strategy="elastic_dp", elastic={...})`` and
``HogwildTrainer``.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import racecheck
from ..core import _unflatten
from ..optimizers import GradientTransformation, tree_leaves, tree_map
from ..resilience import faults

logger = logging.getLogger("sparkflow_tpu_torch")

__all__ = [
    "SparseRows", "encode_grads", "decode_grads",
    "PushResult", "ReplicaView", "ElasticParamStore", "InProcessTransport",
    "ReplicaSpec", "ElasticResult", "ElasticDPEngine",
    "sync_baseline_examples_per_sec",
]


# ---------------------------------------------------------------------------
# dense/sparse gradient codec (the Parallax split)
# ---------------------------------------------------------------------------

class SparseRows:
    """Row-sparse gradient wire format: ``values[i]`` is the gradient of row
    ``indices[i]`` of a ``shape``-shaped dense tensor; untouched rows are
    zero. ``indices`` is an int32 CPU tensor, ``values`` a tensor on the
    gradient's device. A leaf of an encoded tree, never a subtree."""

    __slots__ = ("indices", "values", "shape")

    def __init__(self, indices, values, shape: Tuple[int, ...]):
        self.indices = torch.as_tensor(indices).to("cpu", torch.int32)
        self.values = torch.as_tensor(values)
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return (self.indices.numel() * 4
                + self.values.numel() * self.values.element_size())

    def densify(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        if self.indices.numel():
            out[self.indices.to(out.device, torch.int64)] = self.values
        return out

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (f"SparseRows({self.indices.numel()}/{self.shape[0]} rows, "
                f"shape={self.shape})")


def _is_sparse(leaf) -> bool:
    return isinstance(leaf, SparseRows)


def encode_grads(grads, density_threshold: Optional[float] = 0.25):
    """Split a gradient tree (nested dicts of tensors or numpy arrays) by
    row density: leaves of rank >= 2 whose nonzero-row fraction is <=
    ``density_threshold`` become :class:`SparseRows` (embedding-class params
    — a sparse batch touches few vocabulary rows); everything else stays a
    dense tensor, the all-reduce class. Returns ``(encoded_tree,
    dense_bytes, wire_bytes)`` so callers can account the traffic the split
    saved. ``density_threshold=None`` disables the split (everything dense).

    The rows each candidate leaf touches are found on its device and read
    back to the host in one transfer for the whole tree."""
    leaves = [torch.as_tensor(g) for g in tree_leaves(grads)]
    dense_bytes = sum(a.numel() * a.element_size() for a in leaves)
    cands = [i for i, a in enumerate(leaves)
             if density_threshold is not None and a.dim() >= 2
             and a.shape[0] > 0]
    touched = {}
    if cands:
        rows = [(leaves[i].reshape(leaves[i].shape[0], -1) != 0).any(dim=1)
                for i in cands]
        flags = torch.cat(rows).cpu().numpy()  # the one host read
        off = 0
        for i, r in zip(cands, rows):
            touched[i] = np.flatnonzero(flags[off:off + r.numel()])
            off += r.numel()
    out = []
    wire_bytes = 0
    for i, a in enumerate(leaves):
        idx = touched.get(i)
        if idx is None or idx.size / a.shape[0] > density_threshold:
            wire_bytes += a.numel() * a.element_size()
            out.append(a)
            continue
        sel = torch.from_numpy(idx.astype(np.int64)).to(a.device)
        sp = SparseRows(idx.astype(np.int32), a.index_select(0, sel), a.shape)
        wire_bytes += sp.nbytes
        out.append(sp)
    return _unflatten(grads, iter(out)), dense_bytes, wire_bytes


def decode_grads(encoded):
    """Inverse of :func:`encode_grads`: densify every SparseRows leaf."""
    return tree_map(lambda l: l.densify() if _is_sparse(l)
                    else torch.as_tensor(l), encoded)


# ---------------------------------------------------------------------------
# the versioned parameter store
# ---------------------------------------------------------------------------

@dataclass
class PushResult:
    """Outcome of one gradient push. On acceptance the store piggybacks the
    post-update weights (``params`` at ``version``) so the replica starts
    its next step fresh without a second round-trip; on rejection it
    piggybacks the CURRENT weights — the forced refresh."""
    accepted: bool
    staleness: int
    version: int
    params: Any
    scale: float = 1.0
    reason: str = ""


@dataclass
class ReplicaView:
    """Membership snapshot for one replica (read-only copy)."""
    replica_id: str
    joined_at: float
    last_heartbeat: float
    pushes: int = 0
    rejected: int = 0
    last_staleness: int = 0


class _Lease:
    __slots__ = ("joined_at", "last_beat", "pushes", "rejected",
                 "last_staleness")

    def __init__(self, now: float):
        self.joined_at = now
        self.last_beat = now
        self.pushes = 0
        self.rejected = 0
        self.last_staleness = 0


def _resolve_dampening(dampening) -> Callable[[int], float]:
    if dampening is None or dampening == "none":
        return lambda s: 1.0
    if dampening == "inverse":
        return lambda s: 1.0 / (1.0 + s)
    if callable(dampening):
        return dampening
    raise ValueError(
        f"dampening must be 'inverse', 'none'/None, or a callable "
        f"staleness -> scale; got {dampening!r}")


class ElasticParamStore:
    """Versioned in-process parameter store with bounded-staleness updates
    and lease-based elastic membership.

    The asynchronous replacement for the all-reduce: replicas pull
    ``(version, params)``, compute a gradient, and push it back tagged with
    that basis version. The store serializes updates under one lock (the
    reference's ``acquireLock=True`` path — SURVEY.md notes the lock-free
    races were a misfeature), applies the optimizer update scaled by the
    dampening rule, and bumps the version. Unlike the sync step, nobody
    *waits* for anybody: a slow replica only makes its OWN gradient stale.

    ``clock`` is injectable (the virtual-time engine drives leases on
    simulated seconds); ``fault_sleep`` is the sleep used by injected fault
    delays, swapped for a virtual-time advance in simulation.
    """

    def __init__(self, params, optimizer: GradientTransformation, *,
                 max_staleness: int = 4,
                 dampening="inverse",
                 lease_ttl_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None,
                 publish_to=None,
                 publish_every: int = 0):
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        if metrics is None:
            from ..utils.metrics import default_metrics
            metrics = default_metrics
        self.metrics = metrics
        self.optimizer = optimizer
        self.max_staleness = int(max_staleness)
        self.lease_ttl_s = float(lease_ttl_s)
        self.clock = clock
        self.fault_sleep = time.sleep
        self._damp = _resolve_dampening(dampening)
        self._lock = threading.Lock()
        self._params = tree_map(
            lambda a: (a.detach() if torch.is_tensor(a)
                       else torch.as_tensor(np.asarray(a))).clone(), params)
        self._opt_state = optimizer.init(self._params)
        self._version = 0
        self._replicas: Dict[str, _Lease] = {}
        self._evictions = 0
        # live publication (train→serve): every publish_every ACCEPTED
        # pushes, the current weights go to a serving WeightStore — the
        # pull side of the same versioned-weights idea this store implements
        self.publish_every = int(publish_every)
        if isinstance(publish_to, str):
            from ..serving.weightstore import WeightStore
            publish_to = WeightStore(publish_to)
        self._publish_store = publish_to

    def _apply(self, grads, scale: float):
        """The next version's ``(params, opt_state)``: NEW trees, out of
        place — the current ones may be held by replicas mid-gradient and
        must never change (the JAX store's jitted pure update, in eager
        form). Called under the lock."""
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(
                grads, self._opt_state, self._params)
            # dampening scales the UPDATE, not the raw gradient: adaptive
            # optimizers (adam's second-moment normalization) would cancel
            # a gradient-side scale, leaving stale pushes undampened
            params = tree_map(lambda p, u: p + (u * scale).to(p.dtype),
                              self._params, updates)
        return params, opt_state

    # -- membership ---------------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        dead = [rid for rid, l in self._replicas.items()
                if now - l.last_beat > self.lease_ttl_s]
        for rid in dead:
            del self._replicas[rid]
            self._evictions += 1
            logger.warning("elastic: replica %r lease expired (> %.1fs "
                           "without a heartbeat) — evicted", rid,
                           self.lease_ttl_s)
        if dead:
            self.metrics.incr("elastic/evicted", len(dead))
            self.metrics.gauge("elastic/replicas", len(self._replicas))

    def join(self, replica_id: str):
        """Register (or re-register after eviction/preemption) a replica and
        hand it the current weights. Returns ``(version, params)``."""
        now = self.clock()
        with self._lock:
            self._expire_locked(now)
            rejoin = replica_id in self._replicas
            self._replicas[replica_id] = _Lease(now)
            self.metrics.incr("elastic/join")
            self.metrics.gauge("elastic/replicas", len(self._replicas))
            if not rejoin:
                logger.info("elastic: replica %r joined (now %d alive)",
                            replica_id, len(self._replicas))
            return self._version, self._params

    def leave(self, replica_id: str) -> None:
        """Graceful exit: drop the lease immediately (no ttl wait)."""
        with self._lock:
            if self._replicas.pop(replica_id, None) is not None:
                self.metrics.gauge("elastic/replicas", len(self._replicas))

    def heartbeat(self, replica_id: str) -> bool:
        """Renew a lease. False means the lease already expired (or never
        existed) — the replica must :meth:`join` again."""
        now = self.clock()
        with self._lock:
            self._expire_locked(now)
            lease = self._replicas.get(replica_id)
            if lease is None:
                return False
            lease.last_beat = now
            return True

    def alive_count(self) -> int:
        with self._lock:
            self._expire_locked(self.clock())
            return len(self._replicas)

    def membership(self) -> Dict[str, ReplicaView]:
        with self._lock:
            return {rid: ReplicaView(rid, l.joined_at, l.last_beat,
                                     l.pushes, l.rejected, l.last_staleness)
                    for rid, l in self._replicas.items()}

    # -- weight/gradient exchange ------------------------------------------

    def pull(self, replica_id: str):
        """Fetch ``(version, params)``; renews the replica's lease when it
        holds one (a pull does NOT implicitly re-join — eviction must be
        answered by an explicit :meth:`join`)."""
        faults.fire("elastic.pull", sleep=self.fault_sleep)
        now = self.clock()
        with self._lock:
            self._expire_locked(now)
            lease = self._replicas.get(replica_id)
            if lease is not None:
                lease.last_beat = now
            return self._version, self._params

    def push(self, replica_id: str, grads, basis_version: int) -> PushResult:
        """Offer one gradient computed against ``basis_version``.

        Acceptance rule (the bounded-staleness contract):

        - no live lease (expired mid-compute / never joined) -> rejected,
          ``reason='lease_expired'`` — re-join first;
        - ``staleness = version - basis_version > max_staleness`` ->
          rejected, ``reason='stale'`` — refresh (the result carries the
          current weights) and recompute;
        - otherwise the update applies, scaled by ``dampening(staleness)``,
          and the version increments.

        SparseRows leaves are densified here — the store is where the
        PS-style sparse exchange lands.
        """
        faults.fire("elastic.push", sleep=self.fault_sleep)
        now = self.clock()
        from ..obs import span
        with span("elastic/push", args={"replica": replica_id}):
            with self._lock:
                self._expire_locked(now)
                lease = self._replicas.get(replica_id)
                if lease is None:
                    self.metrics.incr("elastic/push_rejected")
                    return PushResult(False, 0, self._version, self._params,
                                      0.0, "lease_expired")
                lease.last_beat = now
                staleness = self._version - int(basis_version)
                lease.last_staleness = staleness
                self.metrics.observe("elastic/staleness", float(staleness))
                if staleness > self.max_staleness:
                    lease.rejected += 1
                    self.metrics.incr("elastic/push_rejected")
                    return PushResult(False, staleness, self._version,
                                      self._params, 0.0, "stale")
                scale = float(np.float32(self._damp(staleness)))
                dense = tree_map(
                    lambda g, p: g.to(p.device), decode_grads(grads),
                    self._params)
                self._params, self._opt_state = self._apply(dense, scale)
                self._version += 1
                lease.pushes += 1
                self.metrics.incr("elastic/push_accepted")
                result = PushResult(True, staleness, self._version,
                                    self._params, scale)
                do_publish = (self._publish_store is not None
                              and self.publish_every > 0
                              and self._version % self.publish_every == 0)
            # disk IO happens after the lock releases: a slow publication
            # must never stall concurrent pulls/pushes from other replicas
            if do_publish:
                self._publish(result.params)
            return result

    def _publish(self, params) -> None:
        """Best-effort live publication; a failed publish is logged and
        counted but never fails the training push that triggered it (the
        serving side keeps last-good weights either way)."""
        try:
            v = self._publish_store.publish(params)
            self.metrics.gauge("elastic/published_version", float(v))
        except Exception:
            self.metrics.incr("elastic/publish_failed")
            logger.exception("elastic: live weight publication failed")

    def snapshot(self):
        """``(version, params, opt_state)`` under the lock — checkpoint /
        end-of-training read."""
        with self._lock:
            return self._version, self._params, self._opt_state

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def evictions(self) -> int:
        with self._lock:
            return self._evictions


class InProcessTransport:
    """Default transport: direct store calls. Workers only ever talk to a
    transport, so tests (and future multi-host backends) swap in their own —
    the fault points in the store fire for every implementation that
    delegates here."""

    def __init__(self, store: ElasticParamStore):
        self.store = store

    def join(self, rid: str):
        return self.store.join(rid)

    def leave(self, rid: str) -> None:
        self.store.leave(rid)

    def heartbeat(self, rid: str) -> bool:
        return self.store.heartbeat(rid)

    def pull(self, rid: str):
        return self.store.pull(rid)

    def push(self, rid: str, grads, basis_version: int) -> PushResult:
        return self.store.push(rid, grads, basis_version)


# ---------------------------------------------------------------------------
# replica runner: one replica's sequential pull/compute/push state machine
# ---------------------------------------------------------------------------

class _ReplicaRunner:
    """Drives one replica over its data shard. Pure sequential logic — the
    threaded engine gives each runner its own thread, the virtual-time
    engine interleaves runners on a simulated clock; both call the same
    three methods (``join`` / ``compute`` / ``push``)."""

    def __init__(self, rid: str, index: int, transport, grad_fn,
                 x: np.ndarray, y: np.ndarray, batch: int, epochs: int,
                 seed: int, density_threshold: Optional[float],
                 max_stale_retries: int = 1,
                 loss_callback: Optional[Callable] = None,
                 device: Optional[torch.device] = None):
        self.rid = rid
        self.index = index
        self.transport = transport
        self.grad_fn = grad_fn
        self.x, self.y = x, y
        n = x.shape[0]
        self.batch = max(1, min(batch, n))
        self.steps_per_epoch = max(1, n // self.batch)
        self.epochs = epochs
        self.total_steps = epochs * self.steps_per_epoch
        self.density_threshold = density_threshold
        self.max_stale_retries = max_stale_retries
        self.loss_callback = loss_callback
        self._rs = np.random.RandomState(seed)
        # dropout: a generator reseeded per (step, retry), like the JAX
        # runner's key folded with them
        self.seed = int(seed)
        self.device = torch.device("cpu") if device is None else device
        self._gen = torch.Generator(device=self.device)
        self._perm = None
        self._perm_epoch = -1
        self.step = 0
        self.retries_this_batch = 0
        self.version = -1
        self.params = None
        # outcome accounting (read by the engine after the run)
        self.losses: List[Tuple[int, float]] = []  # (epoch, loss) accepted
        self.examples_applied = 0
        self.pushes = 0
        self.accepted = 0
        self.rejected_stale = 0
        self.rejected_lease = 0
        self.dropped_stale = 0
        self.dropped_lease = 0
        self.dropped_fault = 0
        self.dense_bytes = 0
        self.wire_bytes = 0

    def join(self) -> None:
        self.version, self.params = self.transport.join(self.rid)

    @property
    def done(self) -> bool:
        return self.step >= self.total_steps

    def _batch_indices(self) -> np.ndarray:
        e = self.step // self.steps_per_epoch
        if e != self._perm_epoch:
            self._perm = self._rs.permutation(self.x.shape[0])
            self._perm_epoch = e
        i = self.step % self.steps_per_epoch
        return self._perm[i * self.batch:(i + 1) * self.batch]

    def compute(self) -> Optional[dict]:
        """One local gradient on the current basis weights, encoded for the
        wire. None when this replica's work is complete."""
        if self.done:
            return None
        idx = self._batch_indices()
        xb = self.x[idx]
        yb = self.y[idx] if self.y is not None else np.zeros(
            (idx.size, 1), np.float32)
        mask = np.ones((idx.size,), np.float32)
        self._gen.manual_seed((self.seed * 1000003 + self.step * 131071
                               + self.retries_this_batch) % (1 << 62))
        loss, grads = self.grad_fn(self.params, xb, yb, mask, self._gen)
        encoded, db, wb = encode_grads(grads, self.density_threshold)
        self.dense_bytes += db
        self.wire_bytes += wb
        return {"grads": encoded, "basis": self.version,
                "loss": float(loss), "epoch": self.step // self.steps_per_epoch,
                "examples": int(idx.size)}

    def push(self, payload: dict) -> Optional[PushResult]:
        """Push one payload; adopt the piggybacked weights either way.
        Returns None when the push was dropped by an injected fault (the
        gradient is lost; the runner resyncs and moves on — the reference's
        drop-the-update behavior, now counted instead of printed)."""
        self.pushes += 1
        try:
            res = self.transport.push(self.rid, payload["grads"],
                                      payload["basis"])
        except faults.InjectedFault:
            self.dropped_fault += 1
            try:
                self.version, self.params = self.transport.pull(self.rid)
            except faults.InjectedFault:
                pass  # resync on the next successful exchange
            self._advance()
            return None
        self.version, self.params = res.version, res.params
        if res.accepted:
            self.accepted += 1
            self.examples_applied += payload["examples"]
            self.losses.append((payload["epoch"], payload["loss"]))
            if self.loss_callback is not None:
                self.loss_callback(payload["loss"], self.step, self.index)
            self._advance()
        elif res.reason == "lease_expired":
            self.rejected_lease += 1
            self.join()  # re-register (fresh lease + weights) either way
            if self.retries_this_batch >= self.max_stale_retries:
                # a transport delay far beyond the lease TTL re-expires
                # every retry's fresh lease — without a bound the replica
                # re-joins and recomputes forever. Same rule as stale:
                # drop this batch's contribution and move on.
                self.dropped_lease += 1
                self._advance()
            else:
                self.retries_this_batch += 1
        else:  # stale beyond the bound: refresh happened via piggyback
            self.rejected_stale += 1
            if self.retries_this_batch >= self.max_stale_retries:
                # a persistent straggler would livelock recomputing forever
                # (every recompute ages past the bound again) — drop this
                # batch's contribution and move on, like DeepSpark's lagging
                # workers that simply skip ahead
                self.dropped_stale += 1
                self._advance()
            else:
                self.retries_this_batch += 1
        return res

    def _advance(self) -> None:
        self.step += 1
        self.retries_this_batch = 0

    def run_one(self) -> bool:
        """compute+push for the threaded engine; False when done."""
        payload = self.compute()
        if payload is None:
            return False
        self.push(payload)
        return True


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclass
class ReplicaSpec:
    """Virtual-time behavior of one replica: per-step compute cost in
    simulated seconds, when it joins, and an optional mid-run preemption
    window (``preempt_at`` .. ``rejoin_at``; ``rejoin_at=None`` means it
    never comes back)."""
    cost_s: float = 1.0
    join_at: float = 0.0
    preempt_at: Optional[float] = None
    rejoin_at: Optional[float] = None


@dataclass
class ElasticResult:
    """Outcome of an elastic run. ``losses`` is the per-epoch mean over
    accepted pushes (epochs a replica never completed contribute what was
    accepted); ``stats`` carries the push/membership accounting the tests
    and bench pin."""
    params: Any
    opt_state: Any
    losses: List[float]
    examples: int
    wall_s: float
    examples_per_sec: float
    version: int
    stats: Dict[str, Any] = field(default_factory=dict)


def _aggregate_losses(runners: Sequence[_ReplicaRunner]) -> List[float]:
    by_epoch: Dict[int, List[float]] = {}
    for r in runners:
        for e, l in r.losses:
            by_epoch.setdefault(e, []).append(l)
    return [float(np.mean(by_epoch[e])) for e in sorted(by_epoch)]


def _collect_stats(runners: Sequence[_ReplicaRunner],
                   store: ElasticParamStore) -> Dict[str, Any]:
    s = {
        "pushes": sum(r.pushes for r in runners),
        "accepted": sum(r.accepted for r in runners),
        "rejected_stale": sum(r.rejected_stale for r in runners),
        "rejected_lease": sum(r.rejected_lease for r in runners),
        "dropped_stale": sum(r.dropped_stale for r in runners),
        "dropped_lease": sum(r.dropped_lease for r in runners),
        "dropped_fault": sum(r.dropped_fault for r in runners),
        "dense_bytes": sum(r.dense_bytes for r in runners),
        "wire_bytes": sum(r.wire_bytes for r in runners),
        "evictions": store.evictions,
        "final_version": store.version,
        "per_replica_accepted": {r.rid: r.accepted for r in runners},
    }
    s["sparse_bytes_saved"] = s["dense_bytes"] - s["wire_bytes"]
    return s


class ElasticDPEngine:
    """Elastic bounded-staleness data-parallel training over an
    :class:`ElasticParamStore`.

    Two drivers over the same replica state machine:

    - :meth:`run_threads` — one OS thread per replica, real clock. The
      production-shaped path (``Trainer(strategy='elastic_dp')`` /
      ``HogwildTrainer``).
    - :meth:`run_virtual` — a deterministic event-driven simulation on a
      virtual clock: per-replica step costs, joins, mid-step preemptions
      and lease expiries all replay identically every run, with zero
      sleeping. The chaos tests and the straggler bench run here.
    """

    def __init__(self, loss_fn: Callable,
                 optimizer: GradientTransformation, init_params, *,
                 max_staleness: int = 4, dampening="inverse",
                 density_threshold: Optional[float] = 0.25,
                 lease_ttl_s: float = 10.0,
                 metrics=None, transport=None,
                 loss_callback: Optional[Callable] = None,
                 publish_to=None, publish_every: int = 0):
        self.optimizer = optimizer
        leaves = tree_leaves(init_params)
        self.device = (leaves[0].device if leaves and torch.is_tensor(
            leaves[0]) else torch.device("cpu"))
        self.density_threshold = density_threshold
        self.loss_callback = loss_callback
        self.store = ElasticParamStore(
            init_params, optimizer, max_staleness=max_staleness,
            dampening=dampening, lease_ttl_s=lease_ttl_s, metrics=metrics,
            publish_to=publish_to, publish_every=publish_every)
        self.transport = (transport if transport is not None
                          else InProcessTransport(self.store))

        dev = self.device

        def _value_and_grad(params, x, y, mask, generator):
            # the replica's own leaves: a pulled tree is shared by every
            # replica on its version, so nothing is written into it
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            tree = _unflatten(params, iter(leaves))
            x, y, mask = (torch.as_tensor(a, device=dev) for a in (x, y, mask))
            loss = loss_fn(tree, x, y, mask, generator)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), _unflatten(params, iter(grads))

        self.grad_fn = _value_and_grad
        self.membership_trace: List[Tuple[float, int]] = []

    # -- shared setup -------------------------------------------------------

    def _make_runners(self, shards, batch: int, epochs: int, seed: int,
                      max_stale_retries: int = 1) -> List[_ReplicaRunner]:
        runners = []
        for i, (x, y) in enumerate(shards):
            runners.append(_ReplicaRunner(
                f"replica-{i}", i, self.transport, self.grad_fn, x, y,
                batch, epochs, seed + 1000003 * i, self.density_threshold,
                max_stale_retries=max_stale_retries,
                loss_callback=self.loss_callback, device=self.device))
        return runners

    def _warmup(self, runners: List[_ReplicaRunner]) -> None:
        """Prime membership (a join and leave per replica) and run one
        gradient on the first replica's batch shape before concurrency
        starts — on the card this builds and loads the kernel library once,
        outside the threads — then wait for the device."""
        for r in runners:
            _v, params = self.transport.join(r.rid)
            self.transport.leave(r.rid)
        if not runners:
            return
        r = runners[0]
        idx = np.arange(r.batch)
        yb = (r.y[idx] if r.y is not None
              else np.zeros((idx.size, 1), np.float32))
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.grad_fn(params, r.x[idx], yb, np.ones((idx.size,), np.float32),
                     gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _result(self, runners, wall_s: float) -> ElasticResult:
        version, params, opt_state = self.store.snapshot()
        examples = sum(r.examples_applied for r in runners)
        stats = _collect_stats(runners, self.store)
        stats["membership_trace"] = list(self.membership_trace)
        return ElasticResult(
            params=params, opt_state=opt_state,
            losses=_aggregate_losses(runners), examples=examples,
            wall_s=wall_s,
            examples_per_sec=examples / max(wall_s, 1e-9),
            version=version, stats=stats)

    # -- threaded driver ----------------------------------------------------

    def run_threads(self, shards: Sequence[Tuple[np.ndarray,
                                                 Optional[np.ndarray]]],
                    *, epochs: int, batch_size: int,
                    seed: int = 0) -> ElasticResult:
        """Train with one thread per shard. ``shards`` is a list of
        ``(x, y)`` per replica (``y=None`` unsupervised). Returns when every
        replica finished its ``epochs`` over its shard (a replica whose
        pushes keep being dropped still terminates — dropped work is counted,
        not retried forever)."""
        runners = self._make_runners(shards, batch_size, epochs, seed)
        self._warmup(runners)
        # under an active RaceTracker (chaos/test runs), put the store's
        # hot shared state under lockset tracking; no-op (one None check)
        # otherwise
        racecheck.instrument_object(
            self.store,
            fields=("_version", "_params", "_opt_state", "_evictions"))
        errors: List[BaseException] = []

        def worker(r: _ReplicaRunner):
            try:
                r.join()
                while r.run_one():
                    pass
                self.transport.leave(r.rid)
            except BaseException as e:  # surfaced after join() below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(r,),
                                    name=f"elastic-{r.rid}", daemon=True)
                   for r in runners]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return self._result(runners, wall)

    # -- virtual-time driver ------------------------------------------------

    def run_virtual(self, shards, specs: Sequence[ReplicaSpec], *,
                    epochs: int, batch_size: int,
                    seed: int = 0,
                    deadline_s: Optional[float] = None) -> ElasticResult:
        """Deterministic event-driven run on a virtual clock.

        Each replica alternates compute (costing ``spec.cost_s`` virtual
        seconds) and an instantaneous push; the store's lease clock reads
        the same virtual time, so straggling and preemption exercise the
        REAL eviction/rejection paths. A preemption that lands inside a
        compute window discards that in-flight gradient (the mid-step
        preemption case); the replica re-joins at ``rejoin_at`` and
        continues its remaining steps. Injected fault delays
        (``faults.inject(..., delay_ms=...)``) advance virtual time instead
        of sleeping.

        ``deadline_s`` switches from fixed-WORK to fixed-TIME-budget: no
        replica starts a new step at or past the deadline (in-flight steps
        land). This is the sustained-throughput measurement — without it a
        closed step count makes the run's tail "straggler finishing alone",
        which dilutes examples/sec toward the sync barrier number instead
        of measuring what the fleet sustains while elastic."""
        if len(specs) != len(shards):
            raise ValueError(f"{len(shards)} shards but {len(specs)} "
                             f"replica specs")
        runners = self._make_runners(shards, batch_size, epochs, seed,
                                     max_stale_retries=1)
        self._warmup(runners)

        vnow = [0.0]
        self.store.clock = lambda: vnow[0]
        self.store.fault_sleep = lambda s: vnow.__setitem__(0, vnow[0] + s)
        self.membership_trace = []

        # event heap: (time, seq, runner_index, action, payload)
        heap: List[Tuple[float, int, int, str, Any]] = []
        seq = [0]

        def schedule(t: float, i: int, action: str, payload=None):
            heapq.heappush(heap, (t, seq[0], i, action, payload))
            seq[0] += 1

        preempted_done = [False] * len(runners)
        for i, spec in enumerate(specs):
            schedule(max(0.0, spec.join_at), i, "start")

        def preempt_window(i: int, t0: float, t1: float) -> bool:
            """Does replica i's (not yet consumed) preemption land in
            (t0, t1]?"""
            p = specs[i].preempt_at
            return (p is not None and not preempted_done[i]
                    and t0 <= p < t1)

        t_end = 0.0
        while heap:
            t, _s, i, action, payload = heapq.heappop(heap)
            vnow[0] = max(vnow[0], t)
            t = vnow[0]
            t_end = max(t_end, t)
            r, spec = runners[i], specs[i]
            if action == "start":
                r.join()
                self.membership_trace.append((t, self.store.alive_count()))
                schedule(t, i, "compute")
            elif action == "compute":
                out_of_time = (deadline_s is not None
                               and t >= deadline_s - 1e-9)
                if r.done or out_of_time:
                    self.transport.leave(r.rid)
                    self.membership_trace.append(
                        (t, self.store.alive_count()))
                    continue
                payload = r.compute()
                finish = t + spec.cost_s
                if preempt_window(i, t, finish):
                    # preempted MID-STEP: the in-flight gradient dies with
                    # the replica; survivors keep pushing (nothing here
                    # blocks them), the lease expires on its own
                    preempted_done[i] = True
                    if spec.rejoin_at is not None:
                        schedule(max(spec.rejoin_at, finish), i, "start")
                    continue
                schedule(finish, i, "push", payload)
            elif action == "push":
                before = vnow[0]
                r.push(payload)  # may advance vnow via injected delay
                t_end = max(t_end, vnow[0], before)
                self.membership_trace.append(
                    (vnow[0], self.store.alive_count()))
                schedule(vnow[0], i, "compute")

        self.store.clock = time.monotonic
        self.store.fault_sleep = time.sleep
        return self._result(runners, t_end)


def sync_baseline_examples_per_sec(replica_costs: Sequence[float],
                                   batch_size: int) -> float:
    """The synchronous all-reduce throughput bound on the same virtual
    workload: every step waits on the SLOWEST replica (the barrier), so the
    fleet applies ``n * batch`` examples per ``max(cost)`` seconds. This is
    the generous bound for sync — zero collective/dispatch overhead — which
    makes it the conservative denominator for the elastic speedup."""
    costs = list(replica_costs)
    if not costs or min(costs) <= 0:
        raise ValueError("replica_costs must be positive and non-empty")
    return len(costs) * batch_size / max(costs)
