"""Process groups for the mesh paths — the port of the JAX package's
``parallel/distributed.py``, plus the local launcher a single-process
caller gets its ranks from.

Two ways into a mesh fit:

- **In place (SPMD).** The caller already runs one process per rank
  (``torchrun``, or N processes that each call :func:`initialize`): a
  ``Trainer(mesh=...)`` fit then runs on this rank's shard, collectives do
  the rest — the JAX package's multi-host form.
- **Launched.** A single process (one running the estimator, a notebook)
  asks for a mesh outside any process group: :func:`launch` starts
  ``mesh.size`` local rank processes (``spawn``), each joins a fresh group
  over
  ``tcp://127.0.0.1:<free port>``, runs the task and returns; the caller
  gets every rank's result. Rank ``r`` uses card ``r % device_count`` (or
  the CPU with ``device="cpu"``). :class:`RankPool` keeps such ranks alive
  across several tasks (the tests start one pool a module).

A launched rank keeps a line to its caller for the life of a task
(:func:`channel`): it posts to the caller, and the caller sends to each
rank (:meth:`RankPool.send`) while the task runs — a trainer's live
callbacks and verdicts, and the batches of a streaming fit. The line is
made of the queues the pool hands each rank at spawn, since a
``multiprocessing.Queue`` travels only by inheritance, never inside a
task's arguments.

Spawned ranks re-import the caller's main module: a script that launches
ranks keeps its top-level code under ``if __name__ == "__main__":``, else
every rank dies while starting and the pool raises naming that guard.

Backends are chosen up front and reported, never swapped:
:func:`choose_backend` gives NCCL when every rank has a card of its own,
gloo on the CPU, and gloo over CUDA tensors when ranks share a card (NCCL
refuses two ranks on one device) — those collectives stage through pinned
host memory (:mod:`.collectives`). An explicit ``backend="nccl"`` that
cannot be honoured raises. A rank whose task or collective fails fails the
launch: the others are stopped, the error is raised in the caller, and
every join has a timeout, so a hung collective ends the run instead of
hanging it.
"""

from __future__ import annotations

import collections
import datetime
import logging
import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .mesh import Mesh, make_mesh

logger = logging.getLogger("sparkflow_tpu_torch")

_INITIALIZED = False
# a launched rank's line to its caller (set in the rank process only)
_CHANNEL = None
# how a message travels on a rank's task queue, told apart from a task
_MSG = "__msg__"


class RankError(RuntimeError):
    """A launched rank raised, died or outlived its wait while running a
    task (the pool was stopped)."""


def mesh_timeout_s() -> float:
    """Seconds a collective may wait, a rank pool for its ranks to join, and
    a pool's task by default: ``SPARKFLOW_TORCH_MESH_TIMEOUT_S``, else 600.
    A launched rank waits for its caller's messages without a limit.
    Read at each use, so rank processes see what their launcher's
    environment says."""
    return float(os.environ.get("SPARKFLOW_TORCH_MESH_TIMEOUT_S", 600.0))


def determine_master(port: int = 8476) -> str:
    """Resolve a coordinator address like the reference resolved the PS host
    (``HogwildSparkModel.py:145-154``): explicit env first, then hostname."""
    addr = os.environ.get("SPARKFLOW_TPU_COORDINATOR")
    if addr:
        return addr if ":" in addr else f"{addr}:{port}"
    return f"{socket.gethostbyname(socket.gethostname())}:{port}"


def choose_backend(world_size: int, device: str = "cuda",
                   backend: Optional[str] = None,
                   ranks_per_host: Optional[int] = None) -> str:
    """The backend a group of ``world_size`` ranks on ``device`` uses: NCCL
    when each rank on a host has a card of its own, else gloo. An explicit
    ``backend`` is honoured or refused, never replaced."""
    import torch
    import torch.distributed as dist
    kind = str(device).split(":")[0]
    local = int(ranks_per_host or world_size)
    if kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend={backend!r} cannot run ranks on the "
                             f"CPU; gloo is the CPU backend")
        return "gloo"
    cards = torch.cuda.device_count()
    fits = 0 < local <= cards and dist.is_nccl_available()
    if backend is None:
        return "nccl" if fits else "gloo"
    if backend == "nccl" and not fits:
        raise ValueError(
            f"backend='nccl' needs one card per rank: {local} ranks on this "
            f"host, {cards} card(s)"
            + ("" if dist.is_nccl_available() else ", and this torch has no "
               "NCCL")
            + "; NCCL refuses two ranks on one device. Use backend='gloo' "
            "(collectives staged through host memory) or fewer ranks")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl', 'gloo' or None; got "
                         f"{backend!r}")
    return backend


def rank_device(rank: int, device: str = "cuda") -> str:
    """Rank ``r``'s device: card ``r % device_count``, or the CPU."""
    import torch
    if str(device).split(":")[0] == "cpu":
        return "cpu"
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU explicitly")
    return f"cuda:{rank % n}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               retries: Optional[int] = None,
               retry_policy=None, backend: Optional[str] = None,
               device: str = "cuda") -> None:
    """Join the global process group. Arguments default to the environment:
    ``SPARKFLOW_TPU_COORDINATOR`` (else torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``), ``WORLD_SIZE`` and ``RANK``; ``LOCAL_WORLD_SIZE``
    (ranks on this host) decides the backend with :func:`choose_backend`.

    Join resilience: ``timeout_s`` bounds each attempt (env
    ``SPARKFLOW_TPU_COORD_TIMEOUT_S``) and is the collectives' timeout;
    ``retries`` re-attempts a failed join that many extra times with
    exponential backoff (env ``SPARKFLOW_TPU_COORD_RETRIES``, default 0 —
    one attempt, the original exception). A
    :class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy` shapes the
    backoff; a spent budget raises
    :class:`~sparkflow_tpu_torch.resilience.retry.RetryExhausted` naming the
    coordinator address. With nothing to go on (no arguments, no
    environment) it returns without latching, so a later call with
    arguments still forms the group."""
    global _INITIALIZED
    import torch
    import torch.distributed as dist
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return
    addr = coordinator_address
    if addr is None and os.environ.get("SPARKFLOW_TPU_COORDINATOR"):
        addr = determine_master()
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if addr is None and num_processes is None and process_id is None:
        return
    if addr is None or num_processes is None or process_id is None:
        raise ValueError(
            f"initialize needs a coordinator address, the number of "
            f"processes and this process's id (got {addr!r}, "
            f"{num_processes!r}, {process_id!r}); pass them or set "
            f"SPARKFLOW_TPU_COORDINATOR, WORLD_SIZE and RANK")
    if timeout_s is None and os.environ.get("SPARKFLOW_TPU_COORD_TIMEOUT_S"):
        timeout_s = float(os.environ["SPARKFLOW_TPU_COORD_TIMEOUT_S"])
    if retries is None and os.environ.get("SPARKFLOW_TPU_COORD_RETRIES"):
        retries = int(os.environ["SPARKFLOW_TPU_COORD_RETRIES"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    be = choose_backend(num_processes, device, backend, local)
    if be == "nccl" or str(device).split(":")[0] == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                              % max(1, torch.cuda.device_count()))
    timeout = datetime.timedelta(seconds=float(timeout_s or
                                               mesh_timeout_s()))

    def attempt():
        dist.init_process_group(be, init_method=f"tcp://{addr}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)

    if retry_policy is None and not retries:
        attempt()   # single shot: the original exception propagates
        _INITIALIZED = True
        return
    from ..resilience.retry import RetryPolicy
    policy = retry_policy or RetryPolicy(
        max_attempts=int(retries) + 1, base_s=1.0, multiplier=2.0,
        max_s=30.0, jitter=0.5, seed=0)

    def _log_retry(n, delay, err):
        logger.warning(
            "join attempt %d at coordinator %s failed (%s: %s); retrying "
            "in %.1fs", n, addr, type(err).__name__, err, delay)

    policy.call(attempt,
                describe=f"join the process group at coordinator {addr}",
                on_retry=_log_retry)
    _INITIALIZED = True


def global_mesh(axes: Dict[str, int]) -> Mesh:
    """Mesh over every rank of the process group (sizes may use -1)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs an initialised process group: "
                           "call initialize() first")
    return make_mesh(axes, devices=dist.get_world_size())


def process_local_batch(global_batch: int) -> int:
    """Rows this rank should feed per global step."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def local_rows(batch: np.ndarray, index: int, count: int) -> np.ndarray:
    """This rank's block of a global batch: rows ``[index * b, (index + 1)
    * b)`` with ``b = rows / count`` — what ``host_shard_to_global`` hands
    each device of the batch axes in the JAX package."""
    n = batch.shape[0]
    if n % count:
        raise ValueError(f"batch of {n} rows does not divide over {count} "
                         f"ranks")
    b = n // count
    return batch[index * b:(index + 1) * b]


# ---------------------------------------------------------------------------
# Local launcher
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _from_caller(q):
    """The next item on a launched rank's task queue. The wait has no
    limit: the caller sees ranks that die, and a rank whose caller is gone
    ends here."""
    parent = multiprocessing.parent_process()
    while True:
        try:
            return q.get(timeout=1.0)
        except queue_mod.Empty:
            if parent is not None and not parent.is_alive():
                raise SystemExit("the rank's caller has gone") from None


class _Channel:
    """A launched rank's line to its caller, for the task it runs:
    :meth:`post` goes up to the caller, :meth:`recv` takes what the caller
    sent this rank (:meth:`RankPool.send`). A message is a tuple whose
    first item names its kind."""

    def __init__(self, rank: int, inbox, outbox):
        self.rank = rank
        self._in, self._out = inbox, outbox
        self._held: collections.deque = collections.deque()

    def post(self, payload) -> None:
        self._out.put((self.rank, "post", payload))

    def _hold(self, item) -> None:
        if item is None:
            self._in.put(None)      # the task loop still has to see it
            raise RuntimeError(f"rank {self.rank}: the rank pool is closing")
        self._held.append(item[1])

    def _pop(self, kind: Optional[str]):
        for i, msg in enumerate(self._held):
            if kind is None or msg[0] == kind:
                del self._held[i]
                return msg
        return None

    def recv(self, kind: Optional[str] = None):
        """The caller's next message (of ``kind`` when given: those of
        other kinds that come first are held, in order, for later calls).
        Waits as long as the caller takes; raises if the pool is closing."""
        while True:
            msg = self._pop(kind)
            if msg is not None:
                return msg
            self._hold(_from_caller(self._in))

    def take(self, kind: str):
        """A message of ``kind`` that has already arrived, ahead of any
        sent before it, or None — without waiting."""
        while True:
            try:
                item = self._in.get_nowait()
            except queue_mod.Empty:
                return self._pop(kind)
            self._hold(item)


def channel() -> Optional[_Channel]:
    """This launched rank's line to its caller; None in any other
    process."""
    return _CHANNEL


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               device: str, timeout_s: float, tasks, results) -> None:
    """Body of one launched rank: join the group, then run tasks until a
    None arrives. Results and errors go back through ``results``, with
    the task's posts. A CPU rank takes its share of the cores for
    intra-op threads (at most 4)."""
    global _CHANNEL
    try:
        import torch
        import torch.distributed as dist
        if device == "cpu":
            torch.set_num_threads(
                max(1, min(4, (os.cpu_count() or 1) // world)))
        dev = rank_device(rank, device)
        if dev.startswith("cuda"):
            torch.cuda.set_device(torch.device(dev))
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=float(timeout_s)))
        _CHANNEL = _Channel(rank, tasks, results)
        results.put((rank, "ready", None))
    except Exception:  # noqa: BLE001 - reported to the caller
        results.put((rank, "error", traceback.format_exc()))
        return
    try:
        while True:
            task = _from_caller(tasks)
            if task is None:
                break
            if task[0] == _MSG:
                continue    # sent for a task that has ended
            _CHANNEL._held.clear()
            fn, args, kwargs = task
            try:
                results.put((rank, "ok", fn(*args, **kwargs)))
            except Exception:  # noqa: BLE001 - reported to the caller
                results.put((rank, "error", traceback.format_exc()))
    finally:
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 - the process ends anyway
            pass


class RankPool:
    """``world`` local rank processes in one process group, kept alive for
    several tasks. ``run(fn, *args)`` calls ``fn(*args)`` on every rank
    (inside the group; ``fn`` must be importable, its arguments and result
    picklable — return numpy, not CUDA tensors) and returns the per-rank
    results in rank order. A rank that raises or dies, or a task that
    outlives its wait (``run``'s ``timeout_s``, default
    :func:`mesh_timeout_s`), stops the pool and raises :class:`RankError`
    with the rank's traceback. The ranks' collectives and their joining
    time out after :func:`mesh_timeout_s`; ranks that die while starting
    raise ``RuntimeError`` naming the main-module guard.

    ``backend`` / ``device`` as :func:`choose_backend`. Use as a context
    manager, or call :meth:`close`."""

    def __init__(self, world: int, device: str = "cuda",
                 backend: Optional[str] = None):
        import torch.multiprocessing as mp
        self.world = int(world)
        if self.world < 1:
            raise ValueError(f"a rank pool needs at least one rank, got "
                             f"{world}")
        self.device = str(device).split(":")[0]
        if self.device == "cuda":
            rank_device(0, "cuda")      # raises without a card
        self.backend = choose_backend(self.world, self.device, backend)
        self.timeout_s = mesh_timeout_s()
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        init = f"tcp://127.0.0.1:{_free_port()}"
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, init, self.backend, self.device,
                  self.timeout_s, self._tasks[r], self._results))
            for r in range(self.world)]
        self._closed = False
        self._got: Dict[int, Any] = {}
        self._what = "task"
        for p in self._procs:
            p.start()
        try:
            self._collect("ready", self.timeout_s)
        except BaseException:
            self.close()
            raise

    def _next(self, what: str, deadline: float):
        """One item from the ranks, ``(rank, status, payload)``, or None when
        ``deadline`` passes first; raises (and stops the pool) when a rank
        failed or died."""
        while True:
            left = max(0.0, deadline - time.monotonic())
            try:
                rank, status, payload = self._results.get(
                    timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in self._got]
                if dead:
                    codes = [self._procs[r].exitcode for r in dead]
                    self.close()
                    if what == "ready":
                        raise RuntimeError(
                            f"rank pool: rank(s) {dead} exited (codes "
                            f"{codes}) while starting; the pool was "
                            f"stopped. Spawned ranks re-import the caller's "
                            f"main module: a script that launches ranks "
                            f"keeps its top-level code under `if __name__ "
                            f"== \"__main__\":` (each rank's error output "
                            f"is above)")
                    raise RankError(
                        f"rank pool: rank(s) {dead} exited (codes {codes}) "
                        f"during {what}; the pool was stopped")
                if time.monotonic() >= deadline:
                    return None
                continue
            if status == "error":
                self.close()
                cls = RuntimeError if what == "ready" else RankError
                raise cls(f"rank {rank} failed during {what}:\n{payload}")
            return rank, status, payload

    def _collect(self, what: str, timeout_s: float,
                 on_post: Optional[Callable] = None) -> List[Any]:
        """Every rank's result of the running task; each post on the way
        goes to ``on_post(rank, payload)`` (dropped without one)."""
        deadline = time.monotonic() + timeout_s
        while len(self._got) < self.world:
            item = self._next(what, deadline)
            if item is None:
                missing = sorted(set(range(self.world)) - set(self._got))
                self.close()
                cls = RuntimeError if what == "ready" else RankError
                raise cls(
                    f"rank pool: {what} timed out after {timeout_s:.0f} s "
                    f"(ranks {missing} did not answer); the pool was "
                    f"stopped")
            rank, status, payload = item
            if status == "post":
                if on_post is not None:
                    on_post(rank, payload)
                continue
            self._got[rank] = payload
        got, self._got = self._got, {}
        return [got[r] for r in range(self.world)]

    def start(self, fn: Callable, *args, **kwargs) -> None:
        """Begin ``fn(*args, **kwargs)`` on every rank without waiting: the
        caller then talks to the ranks (:meth:`send`, :meth:`poll`) and
        takes the results with :meth:`finish`."""
        if self._closed:
            raise RuntimeError("rank pool is closed")
        self._got = {}
        self._what = getattr(fn, "__name__", "task")
        for q in self._tasks:
            q.put((fn, args, kwargs))

    def send(self, rank: int, payload) -> None:
        """Hand ``payload`` to ``rank``'s running task
        (:meth:`_Channel.recv` there)."""
        self._tasks[rank].put((_MSG, payload))

    def broadcast(self, payload) -> None:
        for r in range(self.world):
            self.send(r, payload)

    def poll(self, timeout_s: float):
        """The next post of the running task, ``(rank, payload)``, or None
        when ``timeout_s`` passes first or a rank has already returned its
        result (see :meth:`done`). Raises :class:`RankError` when a rank
        failed or died."""
        deadline = time.monotonic() + timeout_s
        while True:
            item = self._next(self._what, deadline)
            if item is None:
                return None
            rank, status, payload = item
            if status == "post":
                return rank, payload
            self._got[rank] = payload
            return None

    def done(self) -> bool:
        """Whether a rank has returned from the running task."""
        return bool(self._got)

    def finish(self, timeout_s: Optional[float] = None,
               on_post: Optional[Callable] = None) -> List[Any]:
        """Wait for the running task's results (see :meth:`run`)."""
        return self._collect(self._what, self.timeout_s if timeout_s is None
                             else float(timeout_s), on_post)

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None,
            on_post: Optional[Callable] = None, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; waits ``timeout_s``
        (default :func:`mesh_timeout_s`; ``math.inf`` for none). The task's
        posts go to ``on_post(rank, payload)`` as they come."""
        self.start(fn, *args, **kwargs)
        return self.finish(timeout_s, on_post)

    def close(self) -> None:
        """Stop every rank: ask them to finish, then terminate and kill the
        ones that do not."""
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            try:
                q.put(None)
            except Exception:  # noqa: BLE001 - the rank is going anyway
                pass
        deadline = time.monotonic() + 10.0
        for p in self._procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for q in self._tasks + [self._results]:
            q.cancel_join_thread()   # a dead rank never drains its queue
            q.close()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def launch(fn: Callable, world: int, *args, device: str = "cuda",
           backend: Optional[str] = None, **kwargs) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` once on ``world`` fresh local ranks and
    return their results in rank order (see :class:`RankPool`)."""
    with RankPool(world, device=device, backend=backend) as pool:
        return pool.run(fn, *args, **kwargs)


def current_backend() -> Optional[str]:
    """The initialised process group's backend, or None."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return None
    return str(dist.get_backend()).lower()


__all__ = ["RankError", "RankPool", "channel", "choose_backend",
           "current_backend",
           "determine_master", "global_mesh", "initialize", "launch",
           "local_rows", "mesh_timeout_s", "process_local_batch",
           "rank_device"]
