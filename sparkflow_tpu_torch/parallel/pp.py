"""Pipeline parallelism: transformer blocks split into stages over ``pp`` —
the port of the JAX package's ``parallel/pp.py``, on ``torch.distributed``.

Each rank of the ``pp`` mesh axis holds 1/P of the transformer blocks (its
stage) and a copy of the shared leaves (embed, final layer norm, head), so
model memory scales down with pipeline depth. The layout is JAX's:
:func:`split_stage_params` stacks every block leaf to ``[P, L/P, ...]``
(``stages``) beside the ``shared`` leaves; a rank keeps its ``[1, L/P,
...]`` slice (:class:`StagePlacement`), and a checkpoint holds the whole
stacked layout, as the JAX package's pp fit writes it.

JAX differentiates through its ``ppermute`` ring. Here every schedule walks
JAX's ticks with a backward scheduled by hand, so no collective ever runs
inside autograd (whose CUDA backward runs on its own thread, and whose hops
every rank would have to reach in the same order): a forward keeps only
the stage's INPUT, and a backward recomputes the stage from it with grad
and differentiates by ``torch.autograd.grad`` — ``jax.checkpoint``'s
arithmetic. Activations go forward and cotangents back over
:func:`~.collectives.send_recv`, one exchange after each tick, posted by
both ends from the same table.

- ``'gpipe'`` (default): the fill-drain schedule. Forward ticks ``t = 0 ..
  M + P - 2``, stage ``s`` on microbatch ``t - s``; then the backward in
  reverse tick order. Every stage input of the sweep is kept (M a stage).
- ``'1f1b'``: :func:`_simulate_1f1b`'s tables (carried from JAX unchanged,
  pure Python): at most P stage inputs in flight; the last stage only
  stores its arrivals and runs forward and head in its backward ticks.
- ``'sequential'``: one stage live per tick, a microbatch at a time
  through every stage and back (the numerics baseline, ``M * P`` ticks).
  Its forward keeps the stage's graph instead of recomputing.

The gradient is that of the mean of the microbatches' losses in every
schedule: the shared leaves' gradients (the tied embedding gets its
gradient on the first stage and on the last) sum over ``pp`` and, with a
``dp`` axis, every gradient averages over ``dp`` (each dp replica runs the
pipeline on its rows). The loss, nonzero on the last stage only, sums over
``pp`` for reporting. Tasks: ``'classifier'`` (mean-pool with no mask,
then softmax cross entropy) and ``'lm'`` (``y`` the attention mask as token
weights, per-example normalised next-token NLL) — JAX's ``head_loss``.
Dropout draws from a generator per microbatch and stage, seeded from the
step's seed (folded with the rank's ``dp`` index) and ``m * P + s``; the
recompute draws the same masks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..optimizers import apply_updates, global_norm_sq, tree_leaves, tree_map
from ..sharding import P
from . import collectives as C
from .dp import fold_in

# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------


def _stack(xs):
    return torch.stack([torch.as_tensor(x) for x in xs])


def split_stage_params(model, params, n_stages: int):
    """Repack transformer params into the pipeline layout:

    - ``stages``: every per-block leaf stacked to ``[n_stages,
      blocks_per_stage, ...]``;
    - ``shared``: embed / final_ln / head, copied.
    """
    n_layers = model.num_layers
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} blocks not divisible by {n_stages} stages")
    per = n_layers // n_stages
    blocks = [params[f"block_{i}"] for i in range(n_layers)]
    keys = sorted(blocks[0])
    for i, b in enumerate(blocks):
        if sorted(b) != keys:
            raise ValueError(f"block_{i} holds leaves {sorted(b)}, block_0 "
                             f"{keys}: stages stack blocks of one structure")
    stages = {k: _stack([_stack([blocks[s * per + j][k] for j in range(per)])
                         for s in range(n_stages)]) for k in keys}
    shared = {k: tree_map(lambda a: torch.as_tensor(a).clone(), v)
              for k, v in params.items() if not k.startswith("block_")}
    return {"stages": stages, "shared": shared}


def merge_stage_params(model, pp_params):
    """Inverse of :func:`split_stage_params` (e.g. for checkpoint export)."""
    n_layers = model.num_layers
    stages = pp_params["stages"]
    first = next(iter(stages.values()))
    n_stages, per = first.shape[0], first.shape[1]
    assert n_stages * per == n_layers
    out = dict(pp_params["shared"])
    for i in range(n_layers):
        s, b = divmod(i, per)
        out[f"block_{i}"] = {k: v[s, b] for k, v in stages.items()}
    # the model's own order (an optimizer state's leaves follow it)
    order = [k for k in model.param_specs() if k in out]
    return {k: out[k] for k in order + [k for k in out if k not in order]}


def pp_pspecs(pp_params):
    """PartitionSpecs: stage axis over 'pp', shared replicated."""
    return {"stages": {k: P("pp") for k in pp_params["stages"]},
            "shared": tree_map(lambda x: P(), pp_params["shared"])}


def _is_spec(x) -> bool:
    from ..sharding import PartitionSpec
    return isinstance(x, PartitionSpec)


def split_stage_pspecs(pp_axis: str, block_pspecs, shared_pspecs):
    """PartitionSpecs for the :func:`split_stage_params` layout that KEEP
    per-block leaf sharding: every stage leaf becomes ``P(pp_axis, None,
    *block_leaf_spec)`` — the stage axis over ``pp_axis``, the
    blocks-per-stage axis replicated, the block's own axes (e.g. megatron
    ``tp`` columns) behind. ``block_pspecs`` is the spec tree of ONE
    block; ``shared_pspecs`` passes through."""
    def one(sp):
        if _is_spec(sp):
            return P(pp_axis, None, *tuple(sp))
        return {k: one(v) for k, v in sp.items()}

    return {"stages": one(block_pspecs), "shared": shared_pspecs}


def stage_blocks(stages) -> List[Dict[str, torch.Tensor]]:
    """The blocks of a rank's ``stages`` tree (``[1, per, ...]`` leaves) as
    per-block views — gradients of a loss of them reach the stacked
    leaves."""
    per = next(iter(stages.values())).shape[1]
    return [{k: v[0, j] for k, v in stages.items()} for j in range(per)]


# ---------------------------------------------------------------------------
# The 1F1B tables (pure Python, carried from the JAX package unchanged)
# ---------------------------------------------------------------------------

_OP_NONE, _OP_FWD, _OP_BWD = 0, 1, 2


def _simulate_1f1b(P: int, M: int):
    """Tick-by-tick 1F1B schedule tables (pure python; P, M static).

    Greedy rule per stage: backward when a cotangent is ready and either the
    in-flight limit ``P - s`` is hit or no forward is possible; otherwise
    forward when an activation is ready. Yields the classic warmup /
    steady-1F1B / cooldown shape. Returns:

    - ``ops[t, s]``   — executed op (NONE/FWD/BWD); the LAST stage's FWD is
      rewritten to NONE (its input is already stored by the arrival write,
      and its BWD tick recomputes forward through the head anyway)
    - ``mbs[t, s]``   — microbatch index of the op
    - ``arrf[t, s]``  — 1 when a forward activation arrives at stage s this
      tick (stage s-1 ran FWD at t-1); ``arrm[t, s]`` its microbatch.

    Invariants (asserted): per-stage live-slot window never exceeds P and
    in-window microbatches stay distinct mod P — so one ``[P, ...]`` ring
    buffer keyed ``m % P`` is both the arrival queue and the bwd input store.
    Cotangents always arrive exactly on their consumption tick (bwd has
    priority), so they need no buffer at all.
    """
    ops, mbs = [], []
    fwd_done = [0] * P
    bwd_done = [0] * P
    act_ready = [dict() for _ in range(P)]
    cot_ready = [dict() for _ in range(P)]
    for m in range(M):
        act_ready[0][m] = 0
    t = 0
    while any(b < M for b in bwd_done):
        if t > 4 * (M + P) + 16:
            raise AssertionError("1f1b schedule failed to converge")
        row_op, row_mb = [_OP_NONE] * P, [0] * P
        for s in range(P):
            in_flight = fwd_done[s] - bwd_done[s]
            m_b, m_f = bwd_done[s], fwd_done[s]
            can_bwd = m_b < M and cot_ready[s].get(m_b, 1 << 30) <= t
            can_fwd = m_f < M and act_ready[s].get(m_f, 1 << 30) <= t
            if can_bwd and (in_flight >= P - s or not can_fwd):
                row_op[s], row_mb[s] = _OP_BWD, m_b
            elif can_fwd and in_flight < P - s:
                row_op[s], row_mb[s] = _OP_FWD, m_f
        for s in range(P):
            if row_op[s] == _OP_FWD:
                m = row_mb[s]
                fwd_done[s] += 1
                if s + 1 < P:
                    act_ready[s + 1][m] = t + 1
                else:
                    cot_ready[s][m] = t + 1
            elif row_op[s] == _OP_BWD:
                m = row_mb[s]
                bwd_done[s] += 1
                if s - 1 >= 0:
                    cot_ready[s - 1][m] = t + 1
        ops.append(row_op)
        mbs.append(row_mb)
        t += 1
    ops = np.array(ops, np.int32)
    mbs = np.array(mbs, np.int32)
    T = ops.shape[0]
    arrf = np.zeros((T, P), np.int32)
    arrm = np.zeros((T, P), np.int32)
    for tt in range(1, T):
        for s in range(1, P):
            if ops[tt - 1, s - 1] == _OP_FWD:
                arrf[tt, s] = 1
                arrm[tt, s] = mbs[tt - 1, s - 1]
    # check the ring-buffer invariants (see docstring)
    for s in range(1, P):
        live = set()
        for tt in range(T):
            if arrf[tt, s]:
                live.add(int(arrm[tt, s]))
            if ops[tt, s] == _OP_BWD:
                live.discard(int(mbs[tt, s]))
            if len(live) > 1:
                ms = sorted(live)
                assert len(live) <= P and ms[-1] - ms[0] < P, (s, tt, ms)
    # last stage executes nothing at its FWD ticks (timing only — see doc)
    ops_exec = ops.copy()
    ops_exec[:, P - 1] = np.where(ops_exec[:, P - 1] == _OP_FWD, _OP_NONE,
                                  ops_exec[:, P - 1])
    return ops_exec, mbs, arrf, arrm


def schedule_ticks(schedule: str, n_stages: int, n_microbatches: int) -> int:
    """Serial forward span in stage-times, JAX's ``schedule_ticks``: ``M +
    P - 1`` (gpipe), the 1F1B table's length (combined forward and
    backward slots), or ``M * P`` (sequential)."""
    if schedule == "gpipe":
        return n_microbatches + n_stages - 1
    if schedule == "1f1b":
        return int(_simulate_1f1b(n_stages, n_microbatches)[0].shape[0])
    return n_microbatches * n_stages


# ---------------------------------------------------------------------------
# Optimizer state across layouts
# ---------------------------------------------------------------------------


def _paths(tree, prefix=()) -> list:
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_paths(like, values: dict, prefix=()):
    if isinstance(like, dict):
        return {k: _set_paths(v, values, prefix + (k,))
                for k, v in like.items()}
    return values[prefix]


def _meta_tree(tree):
    return tree_map(lambda a: torch.empty(tuple(a.shape), dtype=a.dtype,
                                          device="meta"), tree)


def state_owners(optimizer, template) -> list:
    """For each leaf of ``optimizer.init(params)`` (``template``'s
    structure), the key path of the param it belongs to (a param-shaped
    leaf), or None (a counter): the state is initialised over meta params
    tagged by their index."""
    from ..optimizers_sharded import state_leaves
    paths = _paths(template)
    tagged = _set_paths(template, {p: torch.empty((i + 1,), device="meta")
                                   for i, p in enumerate(paths)})
    own = []
    for x in state_leaves(optimizer.init(tagged)):
        ok = (torch.is_tensor(x) and x.device.type == "meta" and x.dim() == 1
              and 1 <= x.shape[0] <= len(paths))
        own.append(paths[x.shape[0] - 1] if ok else None)
    return own


def relayout_state(optimizer, src_template, dst_template, state, convert):
    """An optimizer state over ``src_template``'s layout -> the same state
    over ``dst_template``'s: each param-shaped group of leaves (adam's mu,
    its nu, an EMA) becomes a tree of ``src_template``'s structure,
    ``convert`` relays it out, and the result fills the destination state's
    leaves of that group; counters pass in order."""
    from ..optimizers_sharded import _state_rebuild, state_leaves
    src_own = state_owners(optimizer, src_template)
    groups: List[dict] = []
    seen: Dict[tuple, int] = {}
    counters = []
    for o, x in zip(src_own, state_leaves(state)):
        if o is None:
            counters.append(x)
            continue
        k = seen.get(o, 0)
        seen[o] = k + 1
        if k == len(groups):
            groups.append({})
        groups[k][o] = x
    moved = [convert(_set_paths(src_template, g)) for g in groups]
    dst_own = state_owners(optimizer, dst_template)
    skeleton = optimizer.init(_set_paths(
        dst_template, {p: torch.empty((i + 1,), device="meta") for i, p in
                       enumerate(_paths(dst_template))}))
    c_it = iter(counters)
    seen = {}
    out = []
    for o in dst_own:
        if o is None:
            out.append(next(c_it))
            continue
        k = seen.get(o, 0)
        seen[o] = k + 1
        out.append(_get(moved[k], o))
    return _state_rebuild(skeleton, iter(out))


def split_stage_state(optimizer, model, std_template, state, n_stages: int):
    """A standard-layout optimizer state -> the stage layout (what a pp
    fit's checkpoint holds)."""
    stage_template = split_stage_params(model, _meta_tree(std_template),
                                        n_stages)
    return relayout_state(optimizer, _meta_tree(std_template),
                          stage_template, state,
                          lambda t: split_stage_params(model, t, n_stages))


def merge_stage_state(optimizer, model, stage_template, state):
    """A stage-layout optimizer state -> the standard layout."""
    meta = _meta_tree(stage_template)
    return relayout_state(optimizer, meta, merge_stage_params(model, meta),
                          state, lambda t: merge_stage_params(model, t))


# ---------------------------------------------------------------------------
# A fit's placement: the standard and checkpoint layouts <-> this rank's
# ---------------------------------------------------------------------------


class StagePlacement:
    """A pp fit's placement on one rank: its stage's ``[1, L/P, ...]``
    block leaves beside the shared leaves, ``{"stages", "shared"}``. The
    checkpoint layout is the whole stacked tree (:func:`split_stage_params`,
    as the JAX package's pp fit saves); the standard layout the model's.
    ``template`` is a tree of the standard shapes. :meth:`to_ckpt`,
    :meth:`gather` and :meth:`state_to_ckpt` are collectives (inside the
    bound mesh)."""

    def __init__(self, model, mesh, template, pp_axis: str = "pp"):
        self.model, self.mesh, self.axis = model, mesh, pp_axis
        self.n_stages = mesh.shape[pp_axis]
        self.template = _meta_tree(template)
        self.ckpt_template = split_stage_params(model, self.template,
                                                self.n_stages)
        ct = self.ckpt_template
        self.local_template = {
            "stages": {k: torch.empty((1,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device="meta")
                       for k, v in ct["stages"].items()},
            "shared": ct["shared"]}

    def stage(self) -> int:
        return C.axis_index(self.axis)

    # -- params --------------------------------------------------------------

    def from_ckpt(self, tree):
        """The checkpoint (stacked) layout -> this rank's slice, fresh
        tensors."""
        s = self.stage()
        return {"stages": {k: v[s:s + 1].clone()
                           for k, v in tree["stages"].items()},
                "shared": tree_map(lambda a: a.clone(), tree["shared"])}

    def place(self, params):
        """Standard params -> this rank's slice."""
        return self.from_ckpt(split_stage_params(self.model, params,
                                                 self.n_stages))

    def to_ckpt(self, local):
        """This rank's slice -> the stacked layout (a collective)."""
        return {"stages": {k: C.all_gather(v.detach().contiguous(), self.axis,
                                           axis=0)
                           for k, v in local["stages"].items()},
                "shared": tree_map(lambda a: a.detach(), local["shared"])}

    def gather(self, local):
        """This rank's slice -> the standard params (a collective)."""
        return merge_stage_params(self.model, self.to_ckpt(local))

    # -- optimizer state -----------------------------------------------------

    def state_to_ckpt(self, optimizer, state):
        """This rank's optimizer state -> the stacked layout's (a
        collective)."""
        return relayout_state(optimizer, self.local_template,
                              self.ckpt_template, state, self.to_ckpt)

    def state_from_ckpt(self, optimizer, state):
        """A stacked-layout optimizer state -> this rank's."""
        return relayout_state(optimizer, self.ckpt_template,
                              self.local_template, state, self.from_ckpt)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def make_pp_train_step(model, optimizer, mesh, n_microbatches: int = 1,
                       pp_axis: str = "pp", schedule: str = "gpipe",
                       dp_axis: str = "dp", task: str = "classifier"):
    """Pipeline-parallel train step for the transformer families, the
    per-rank body of JAX's ``make_pp_train_step``:
    ``step(stage_params, opt_state, ids, y, seed) -> (stage_params,
    opt_state, loss)`` with ``stage_params`` this rank's
    :class:`StagePlacement` slice (leaves requiring a gradient, updated in
    place), ``opt_state`` built on it, ``ids`` / ``y`` this rank's rows (its
    dp block of the batch), ``seed`` an integer and ``loss`` the batch's
    mean loss, equal on every rank. ``task``:

    - ``'classifier'`` — ``y`` one-hot labels [B, C] (or class indices);
      mean-pool + softmax cross entropy;
    - ``'lm'`` — causal next-token NLL; ``y`` the attention mask [B, S]
      (token weights of the loss; blocks run causal).

    With a ``dp_axis`` of size > 1 each dp replica runs the pipeline on its
    rows and gradients average over dp. Runs inside ``with mesh.bind():``
    on every rank. The returned callable exposes ``schedule_ticks``."""
    if schedule not in ("gpipe", "1f1b", "sequential"):
        raise ValueError(f"unknown pp schedule {schedule!r}")
    if schedule == "1f1b" and mesh.shape[pp_axis] < 2:
        # the last-stage arrival-store optimization leaves a 1-stage table
        # with no forward ops at all — a degenerate pipeline anyway
        raise ValueError("schedule='1f1b' needs a pp axis of size >= 2")
    if task not in ("classifier", "lm"):
        raise ValueError(f"unknown pp task {task!r}")
    from ..models.base import softmax_xent
    from ..models.transformer import _dense, _layer_norm
    has_dp = dp_axis in mesh.axis_names and mesh.shape[dp_axis] > 1
    causal = task == "lm"
    n_stages = mesh.shape[pp_axis]
    M = int(n_microbatches)
    if schedule == "1f1b":
        # the op table alone decides every hop: stage s - 1's FWD at tick
        # t is an arrival here, stage s + 1's BWD a cotangent
        ops_t, mbs_t, _arrf, _arrm = _simulate_1f1b(n_stages, M)
    all_axes = (pp_axis, dp_axis) if has_dp else (pp_axis,)

    def head_loss(shared, x, ids_m, y_m):
        """Mean loss of one microbatch from the last stage's output."""
        x = _layer_norm(x, shared["final_ln"]["scale"],
                        shared["final_ln"]["bias"])
        if task == "lm":
            w = y_m[:, 1:].float()
            logits = torch.matmul(x.float(),
                                  shared["embed"]["tok"].float().t())
            logp = F.log_softmax(logits[:, :-1], dim=-1)
            nll = -logp.gather(-1, ids_m[:, 1:, None].long())[..., 0]
            per_ex = (nll * w).sum(-1) / w.sum(-1).clamp_min(1e-6)
            return per_ex.mean()
        pooled = x.mean(dim=1).float()
        logits = _dense(pooled, shared["head"]["kernel"],
                        shared["head"]["bias"])
        return softmax_xent(logits, y_m).mean()

    def step(params, opt_state, ids, y, seed):
        b = ids.shape[0]
        if b % M or b < M:
            raise ValueError(f"batch {b} must be a positive multiple of "
                             f"n_microbatches={M}")
        s = C.axis_index(pp_axis)
        last = s == n_stages - 1
        dev = ids.device
        ids = ids.long()
        mb = b // M
        seq = ids.shape[1]
        base = fold_in(int(seed), C.axis_index(dp_axis)) if has_dp \
            else int(seed)
        shared = params["shared"]
        blocks = stage_blocks(params["stages"])
        leaves = tree_leaves(params)
        grads = [torch.zeros_like(p) for p in leaves]
        act_dtype = model.compute_dtype or torch.float32
        act_shape = (mb, seq, model.hidden)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)

        def rows(a, m):
            return a[m * mb:(m + 1) * mb]

        def gen(m):
            return torch.Generator(device=dev).manual_seed(
                fold_in(base, m * n_stages + s))

        def forward(m, x_in):
            """This stage on microbatch ``m``: ``x_in`` the received
            activation (None on stage 0, which embeds)."""
            x = (model.prefill_embed(shared, rows(ids, m)) if s == 0
                 else x_in)
            return model.stage_apply(blocks, x, None, causal, True, gen(m))

        def backward(m, x_in, g_out, graph=None):
            """Recompute (or take ``graph``) and differentiate microbatch
            ``m`` on this stage; accumulate the param gradients and return
            the input's cotangent (None on stage 0) and the loss."""
            nonlocal loss_sum
            with torch.enable_grad():
                xi = None
                if s > 0:
                    xi = (graph[0] if graph is not None
                          else x_in.detach().requires_grad_(True))
                out = graph[1] if graph is not None else forward(m, xi)
                wrt = leaves + ([xi] if xi is not None else [])
                if last:
                    lval = head_loss(shared, out, rows(ids, m), rows(y, m))
                    got = torch.autograd.grad(lval, wrt, allow_unused=True)
                    loss_sum = loss_sum + lval.detach().float()
                else:
                    got = torch.autograd.grad(out, wrt, grad_outputs=g_out,
                                              allow_unused=True)
            for acc, gi in zip(grads, got[:len(leaves)]):
                if gi is not None:
                    acc.add_(gi)
            return got[len(leaves)] if xi is not None else None

        def hop(send_f=None, send_b=None, recv_f=False, recv_b=False):
            """One exchange: an activation to s + 1 and / or a cotangent
            to s - 1, and what the neighbours send here."""
            sends = []
            if send_f is not None:
                sends.append((send_f.to(act_dtype).contiguous(), s + 1))
            if send_b is not None:
                sends.append((send_b.to(act_dtype).contiguous(), s - 1))
            recvs = []
            if recv_f:
                recvs.append((act_shape, act_dtype, s - 1))
            if recv_b:
                recvs.append((act_shape, act_dtype, s + 1))
            got = C.send_recv(sends, recvs, pp_axis, dev)
            it = iter(got)
            return (next(it) if recv_f else None), (next(it) if recv_b
                                                   else None)

        if schedule == "gpipe":
            T = M + n_stages - 1
            inputs: Dict[int, torch.Tensor] = {}
            x_arr = None
            for t in range(T):
                m = t - s
                live = 0 <= m < M
                if live:
                    inputs[m] = x_arr
                    with torch.no_grad():
                        out = forward(m, x_arr) if not last else None
                # a hop from s - 1 at tick t arrives for tick t + 1
                m_up = t - (s - 1)
                recv = s > 0 and 0 <= m_up < M
                x_arr, _ = hop(send_f=out if live and not last else None,
                               recv_f=recv)
            g_arr = None
            for t in reversed(range(T)):
                m = t - s
                dx = None
                if 0 <= m < M:
                    dx = backward(m, inputs.pop(m), g_arr)
                # what stage s + 1 differentiates at this tick arrives for
                # the next one
                m_down = t - (s + 1)
                recv = not last and 0 <= m_down < M
                _, g_arr = hop(send_b=dx, recv_b=recv)
        elif schedule == "1f1b":
            store: Dict[int, torch.Tensor] = {}
            cot: Optional[torch.Tensor] = None
            for t in range(ops_t.shape[0]):
                op, m = int(ops_t[t, s]), int(mbs_t[t, s])
                send_f = send_b = None
                if op == _OP_FWD:
                    with torch.no_grad():
                        send_f = forward(m, store.get(m))
                elif op == _OP_BWD:
                    send_b = backward(m, store.pop(m, None), cot)
                # what the neighbours send this tick (their table rows)
                recv_f = s > 0 and int(ops_t[t, s - 1]) == _OP_FWD
                recv_b = (not last and int(ops_t[t, s + 1]) == _OP_BWD)
                x_in, cot = hop(send_f=send_f,
                                send_b=send_b if s > 0 else None,
                                recv_f=recv_f, recv_b=recv_b)
                if recv_f:
                    store[int(mbs_t[t, s - 1])] = x_in
        else:  # sequential
            for m in range(M):
                x_in, graph = None, None
                if s > 0:
                    x_in, _ = hop(recv_f=True)
                with torch.enable_grad():
                    xi = (x_in.detach().requires_grad_(True) if s > 0
                          else None)
                    out = forward(m, xi)
                graph = (xi, out)
                if not last:
                    hop(send_f=out.detach())
                    _, g = hop(recv_b=True)
                else:
                    g = None
                dx = backward(m, x_in, g, graph=graph)
                if s > 0:
                    hop(send_b=dx)

        with torch.no_grad():
            grads = [g / M for g in grads]
            n_stage = len(tree_leaves(params["stages"]))
            # the shared leaves' gradients sum over the stages (and average
            # over dp); the stage leaves' average over dp only
            sh = C.psum({str(i): g for i, g in
                         enumerate(grads[n_stage:])}, all_axes)
            grads[n_stage:] = [sh[str(i)] for i in range(len(sh))]
            if has_dp:
                st = C.psum({str(i): g for i, g in
                             enumerate(grads[:n_stage])}, dp_axis)
                grads[:n_stage] = [st[str(i)] for i in range(n_stage)]
                dp_n = mesh.shape[dp_axis]
                grads = [g / dp_n for g in grads]
            loss = C.psum({"l": loss_sum / M}, all_axes)["l"]
            if has_dp:
                loss = loss / mesh.shape[dp_axis]

            def norm_sq(us):
                part = sum((u.float() * u.float()).sum()
                           for u in us[:n_stage])
                rep = sum((u.float() * u.float()).sum()
                          for u in us[n_stage:])
                return C.psum({"s": part}, pp_axis)["s"] + rep

            it = iter(grads)
            gtree = tree_map(lambda _: next(it), params)
            with global_norm_sq(norm_sq):
                updates, opt_state = optimizer.update(gtree, opt_state,
                                                      params)
            apply_updates(params, updates)
        return params, opt_state, loss

    step.schedule_ticks = schedule_ticks(schedule, n_stages, M)
    return step


__all__ = ["StagePlacement", "make_pp_train_step", "merge_stage_params",
           "merge_stage_state", "pp_pspecs", "relayout_state",
           "schedule_ticks", "split_stage_params", "split_stage_pspecs",
           "split_stage_state", "stage_blocks", "state_owners"]
