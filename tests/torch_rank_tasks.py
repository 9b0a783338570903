"""Rank bodies for the port's multi-rank tests (``tests/test_torch_{mesh,
zero,ring}.py`` and the card tests).

Each function runs on every rank of a
:class:`sparkflow_tpu_torch.parallel.distributed.RankPool` (inside its
initialised process group), takes numpy / plain-Python arguments and
returns numpy, so it pickles both ways. The module imports no JAX: spawned
ranks re-import the module that defines their task, and JAX would cost
every rank its import time.
"""

import contextlib
import functools
import os

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def rank_pool(world, device="cpu", timeout_s=180):
    """A ``RankPool`` whose collectives, joining and tasks time out after
    ``timeout_s`` (``SPARKFLOW_TORCH_MESH_TIMEOUT_S`` for the pool's life),
    so a hang fails one test instead of the whole run."""
    from sparkflow_tpu_torch.parallel.distributed import RankPool
    key = "SPARKFLOW_TORCH_MESH_TIMEOUT_S"
    old = os.environ.get(key)
    os.environ[key] = str(timeout_s)
    try:
        with RankPool(world, device=device) as pool:
            yield pool
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def _mesh(axes):
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    return Mesh(axes)


def _np(t):
    return t.detach().float().cpu().numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _tree_t(tree, device="cpu", grad=False):
    if isinstance(tree, dict):
        return {k: _tree_t(v, device, grad) for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree), dtype=torch.float32, device=device)
    return t.requires_grad_(True) if grad else t


def rank():
    return dist.get_rank()


# -- collectives --------------------------------------------------------------


def collectives(axes, xs):
    """Each named collective on this rank's ``xs[rank]`` over the ``dp``
    axis of a ``{"dp": n}`` mesh."""
    from sparkflow_tpu_torch.parallel import collectives as C
    m = _mesh(axes)
    x = torch.tensor(xs[dist.get_rank()])
    with m.bind():
        return {
            "psum": _np(C.psum({"a": x}, "dp")["a"]),
            "psum_mean": _np(C.psum_mean({"a": x}, "dp")["a"]),
            "all_gather0": _np(C.all_gather(x, "dp", axis=0)),
            "all_gather1": _np(C.all_gather(x, "dp", axis=1)),
            "all_gather_stack": _np(C.all_gather(x, "dp", tiled=False)),
            "reduce_scatter": _np(C.reduce_scatter(x, "dp", axis=0)),
            "ppermute": _np(C.ppermute_ring(x, "dp", 1)),
            "ppermute_back": _np(C.ppermute_ring(x, "dp", -1)),
            "axis_index": C.axis_index("dp"),
            "stats": C.stats(),
        }


def hierarchical(axes, trees):
    """``hierarchical_psum_mean`` of this rank's tree (``trees[rank]``) over
    (``dp``, ``dcn``), and the flat mean over both axes."""
    from sparkflow_tpu_torch.parallel import collectives as C
    m = _mesh(axes)
    t = _tree_t(trees[dist.get_rank()])
    with m.bind():
        return {"two_level": _tree_np(C.hierarchical_psum_mean(t, "dp",
                                                               "dcn")),
                "flat": _tree_np(C.psum_mean(t, ("dcn", "dp")))}


def fail_on(bad_rank):
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return dist.get_rank()


def hang(seconds):
    import time
    time.sleep(seconds)
    return dist.get_rank()


# -- ZeRO steps ---------------------------------------------------------------


def dp_steps(axes, spec, opt_name, stage, p0, x, y, steps=2, dcn_axis=None,
             lr=1e-2):
    """``steps`` per-rank steps of ``make_dp_train_step`` at ``stage`` from
    the standard params ``p0``; each rank feeds its block of the rows.
    Returns the losses and the standard-layout params."""
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.optimizers_sharded import (
        gather_rows, gather_zero3_params, place_zero1_state,
        shard_zero3_params, sharded_update)
    from sparkflow_tpu_torch.parallel.dp import make_dp_train_step
    from sparkflow_tpu_torch.sharding import ShardingConfig
    m = _mesh(axes)
    model = model_from_json(spec, device="cpu")
    opt = build_optimizer(opt_name, lr, None)
    cfg = ShardingConfig(zero_stage=stage, dcn_axis=dcn_axis)
    batch_axes = cfg.batch_axes(m)
    with m.bind():
        n = m.shape["dp"]
        count = m.axis_size(batch_axes)
        idx = m.axis_index(batch_axes)
        b = x.shape[0] // count
        xl = torch.tensor(x[idx * b:(idx + 1) * b])
        yl = torch.tensor(y[idx * b:(idx + 1) * b])
        ml = torch.ones(b)
        params = _tree_t(p0, grad=True)
        if stage == 0:
            state = opt.init(params)
        else:
            with torch.no_grad():
                state = place_zero1_state(
                    sharded_update(opt, n, "dp").init(params), m, n, "dp")
        if stage >= 3:
            with torch.no_grad():
                params = place_zero1_state(shard_zero3_params(
                    _tree_t(p0), n), m, n, "dp")
            params = {k: {kk: t.requires_grad_(True) for kk, t in d.items()}
                      for k, d in params.items()}
        step = make_dp_train_step(model, opt, m, "x:0", "y:0", sharding=cfg)
        losses = []
        for i in range(steps):
            params, state, loss = step(params, state, xl, yl, ml, i)
            losses.append(float(loss))
        if stage >= 3:
            params = gather_zero3_params(gather_rows(
                {k: {kk: t.detach() for kk, t in d.items()}
                 for k, d in params.items()}, n, "dp"), _tree_t(p0))
        return {"losses": losses, "params": _tree_np(params)}


def fx_j106(axes, spec, declared, built, opt_name="adam"):
    """GC-J106 (``analysis.fx_lint.lint_dp_train_step``) on this rank: the
    dp step built at zero stage ``built``, held to the declared stage
    ``declared``. Returns the findings' rules and messages."""
    from sparkflow_tpu_torch.analysis.fx_lint import lint_dp_train_step
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.sharding import ShardingConfig
    fs = lint_dp_train_step(
        model_from_json(spec, device="cpu"), opt_name, mesh=_mesh(axes),
        sharding=ShardingConfig(zero_stage=declared),
        built=ShardingConfig(zero_stage=built))
    return [(f.rule, f.message) for f in fs]


def dp_all_stages(axes, spec, opt_name, p0, x, y, dcn_axis=None):
    return {s: dp_steps(axes, spec, opt_name, s, p0, x, y,
                        dcn_axis=dcn_axis) for s in (0, 1, 2, 3)}


# -- trainer fits in place ----------------------------------------------------


def trainer_fit(spec, axes, trainer_kw, x, y, init_params=None):
    """A ``Trainer(mesh=...)`` fit in place on this rank (the group is
    initialised): its losses, standard params, zero stage and stats."""
    from sparkflow_tpu_torch.sharding import ShardingConfig
    from sparkflow_tpu_torch.trainer import Trainer
    kw = dict(trainer_kw)
    if isinstance(kw.get("sharding"), int):
        kw["sharding"] = ShardingConfig(zero_stage=kw["sharding"])
    inputs = kw.pop("inputs", ("x:0", "y:0"))
    t = Trainer(spec, inputs[0], inputs[1], mesh=_mesh(axes), device="cpu",
                **kw)
    r = t.fit(x if not isinstance(x, list) else tuple(x), y,
              init_params=init_params)
    return {"losses": r.losses, "params": _tree_np(r.params),
            "zero_stage": t._zero_stage, "stop": r.stop_reason,
            "stats": t.last_mesh_stats}


def _trainer(spec, axes, trainer_kw):
    from sparkflow_tpu_torch.sharding import ShardingConfig
    from sparkflow_tpu_torch.trainer import Trainer
    kw = dict(trainer_kw)
    if isinstance(kw.get("sharding"), int):
        kw["sharding"] = ShardingConfig(zero_stage=kw["sharding"])
    elif isinstance(kw.get("sharding"), dict):
        kw["sharding"] = ShardingConfig(**kw["sharding"])
    return Trainer(spec, "x:0", "y:0", mesh=_mesh(axes), device="cpu", **kw)


def _opt_np(state):
    """An optimizer state's tensor leaves as numpy, in order."""
    from sparkflow_tpu_torch.optimizers_sharded import state_leaves
    return [_np(a) for a in state_leaves(state) if torch.is_tensor(a)]


def stream_fit(spec, axes, trainer_kw, x, y, init_params=None, epochs=1,
               chunk=64):
    """``Trainer(mesh=...).fit_stream`` in place on this rank over the rows
    ``(x[i], y[i])``: every rank reads the same stream and keeps its own
    rows of each global batch."""
    from sparkflow_tpu_torch.optimizers_sharded import state_leaves
    t = _trainer(spec, axes, trainer_kw)
    r = t.fit_stream(lambda: zip(list(x), list(y)), init_params=init_params,
                     epochs=epochs, chunk=chunk)
    return {"losses": r.losses, "params": _tree_np(r.params),
            "zero_stage": t._zero_stage, "stop": r.stop_reason,
            "offload": t._offload_active, "stats": t.last_mesh_stats,
            "opt_state": _opt_np(t._last_opt_state),
            "opt_on_host": all(not a.is_cuda for a in state_leaves(
                t._last_opt_state) if torch.is_tensor(a))}


def offload_pair(spec, axes, trainer_kw, x, y, init_params, stream):
    """The same fit (``fit`` or ``fit_stream``) without and with
    ``offload_opt_state``: losses, params and the final optimizer state of
    each."""
    out = {}
    for off in (False, True):
        kw = dict(trainer_kw, sharding=dict(
            zero_stage=trainer_kw["sharding"], offload_opt_state=off))
        if stream:
            out[off] = stream_fit(spec, axes, kw, x, y, init_params)
        else:
            t = _trainer(spec, axes, kw)
            r = t.fit(x, y, init_params=init_params)
            out[off] = {"losses": r.losses, "params": _tree_np(r.params),
                        "offload": t._offload_active,
                        "opt_state": _opt_np(t._last_opt_state)}
    return out


def checkpoint_matrix(spec, save_stage, directory, x, y, trainer_kw):
    """Fit at ``save_stage`` into ``directory``, then a fit at every stage
    on the same directory (which resumes at the last epoch and trains
    nothing): the params of each."""
    kw = dict(trainer_kw, checkpoint_dir=directory, checkpoint_every=1)
    saved = trainer_fit(spec, {"dp": 2}, dict(kw, sharding=save_stage), x, y)
    restored = {s: trainer_fit(spec, {"dp": 2}, dict(kw, sharding=s), x,
                               y)["params"] for s in (0, 1, 2, 3)}
    return {"saved": saved["params"], "restored": restored}


def gating(spec, x, y):
    """Which fits turn ZeRO on (``weight_update_sharding='auto'``)."""
    out = {}
    for name, kw in (("adam", {"optimizer": "adam"}),
                     ("sgd", {"optimizer": "gradient_descent"}),
                     ("clip", {"optimizer": "adam",
                               "optimizer_options": {"clip_norm": 1.0}}),
                     ("off", {"optimizer": "adam",
                              "weight_update_sharding": "off"}),
                     ("on", {"optimizer": "gradient_descent",
                             "weight_update_sharding": "on"})):
        out[name] = trainer_fit(spec, {"dp": 2}, dict(
            kw, iters=1, mini_batch_size=32), x, y)["zero_stage"]
    return out


# -- ring attention -----------------------------------------------------------


class _Spy:
    """Counts calls of one kernel wrapper of ``ops.attention``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _backward_on_a_thread(out, grad):
    """``out.backward(grad)`` on a fresh thread, where autograd runs a
    CUDA backward (a context variable set on this thread is not seen
    there)."""
    import threading
    err = []

    def run():
        try:
            out.backward(grad)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if err:
        raise err[0]


def ring(seed, causal, masked, shape, device="cpu", dtype="float32",
         count_visits=False, backward_thread=False):
    """``ring_attention`` and ``ring_flash_attention`` on this rank's
    sequence shard: outputs and q/k/v gradients, and the per-visit calls of
    the flash wrappers (``count_visits``, spied) or else their kernels'
    launch counters."""
    from sparkflow_tpu_torch.ops import attention as A
    b, h, s, d = shape
    m = _mesh({"sp": dist.get_world_size()})
    r, n = dist.get_rank(), dist.get_world_size()
    sl = s // n
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(4))
    mask = ((rs.rand(b, s) > 0.3).astype(np.float32) if masked else None)
    dev = torch.device(device if device == "cpu"
                       else f"cuda:{torch.cuda.current_device()}")
    dt = getattr(torch, dtype)

    def local(a, grad=True):
        t = torch.tensor(a[:, :, r * sl:(r + 1) * sl], device=dev, dtype=dt)
        return t.requires_grad_(grad)

    ml = (torch.tensor(mask[:, r * sl:(r + 1) * sl], device=dev)
          if masked else None)
    out = {}
    spies = {}
    if count_visits:
        for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
            spies[name] = _Spy(getattr(A, name))
            setattr(A, name, spies[name])
    try:
        with m.bind():
            for name, fn in (("plain", A.ring_attention),
                             ("flash", A.ring_flash_attention)):
                ql, kl, vl = local(q), local(k), local(v)
                if count_visits:
                    for sp in spies.values():
                        sp.calls = 0
                else:
                    A.reset_launch_counts()
                o = fn(ql, kl, vl, "sp", causal=causal, kv_mask=ml)
                if backward_thread:
                    _backward_on_a_thread(o, local(do, False))
                else:
                    o.backward(local(do, False))
                out[name] = [_np(t) for t in (o, ql.grad, kl.grad, vl.grad)]
                if count_visits:
                    out[name + "_calls"] = {k2: sp.calls
                                            for k2, sp in spies.items()}
                else:
                    out[name + "_launches"] = A.launch_counts()
    finally:
        for name, sp in spies.items():
            setattr(A, name, sp.fn)
    return out


def sp_step(spec, axes, p0, ids, mask, lr=1.0, optimizer="gradient_descent",
            steps=1, attention=None):
    """``steps`` of ``make_sp_train_step`` from ``p0`` on this rank's block
    of ``ids`` / ``mask`` (rows of its dp index, columns of its sp index):
    the losses and the updated params."""
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import ring_attention
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.parallel.sp import make_sp_train_step
    m = _mesh(axes)
    model = model_from_json(spec, device="cpu")
    opt = build_optimizer(optimizer, lr, {"epsilon": 1e-6}
                          if optimizer == "adam" else None)
    att = (functools.partial(ring_attention, axis_name="sp")
           if attention == "plain" else None)
    with m.bind():
        dpn = m.shape.get("dp", 1)
        di = m.axis_index("dp") if "dp" in m.shape else 0
        si, spn = m.axis_index("sp"), m.shape["sp"]
        rows = ids.shape[0] // dpn
        sl = ids.shape[1] // spn
        blk = (slice(di * rows, (di + 1) * rows),
               slice(si * sl, (si + 1) * sl))
        params = _tree_t(p0, grad=True)
        state = opt.init(params)
        step = make_sp_train_step(model, opt, m, attention=att)
        losses = []
        for i in range(steps):
            params, state, loss = step(params, state,
                                       torch.tensor(ids[blk]).long(),
                                       torch.tensor(mask[blk]), i)
            losses.append(float(loss))
        return {"losses": losses, "params": _tree_np(params)}


def sp_forward(spec, p0, ids):
    """The sp model's logits on this rank's sequence shard (ring attention
    over a ``{"sp": n}`` mesh)."""
    import copy
    from sparkflow_tpu_torch.models import model_from_json
    m = _mesh({"sp": dist.get_world_size()})
    model = copy.copy(model_from_json(spec, device="cpu"))
    model.sp_axis = "sp"
    r, n = dist.get_rank(), dist.get_world_size()
    sl = ids.shape[1] // n
    with m.bind(), torch.no_grad():
        out = model.apply(_tree_t(p0), {"input_ids": torch.tensor(
            ids[:, r * sl:(r + 1) * sl]).long()}, ["logits"])["logits"]
    return _np(out)


# -- tensor parallelism and fsdp ----------------------------------------------


def _placed(model, m, specs, p0):
    """This rank's trainable slices of the standard ``p0`` under ``specs``,
    and the placement that maps them back."""
    from sparkflow_tpu_torch.parallel.tp import ParamPlacement
    std = _tree_t(p0)
    place = ParamPlacement(model, m, specs, std)
    local = place.place(std)
    return place, {k: {kk: t.requires_grad_(True) for kk, t in d.items()}
                   for k, d in local.items()}


def _specs(model, m, fsdp_min_size):
    from sparkflow_tpu_torch.parallel.tp import (derive_param_pspecs,
                                                 fsdp_pspecs)
    if fsdp_min_size is not None:
        return fsdp_pspecs(model.param_specs(), min_size=fsdp_min_size)
    return derive_param_pspecs(model, m)


def sharded_step(spec, axes, p0, x, y, lr=0.1, fsdp_min_size=None,
                 input_name="input_ids", label_name="y"):
    """One gradient-descent step of ``make_param_sharded_train_step`` at
    ``lr`` from the standard ``p0`` (tp specs from the model, or fsdp
    specs at ``fsdp_min_size``), on this rank's dp block of the rows: the
    loss, the gathered standard params, and this rank's param bytes."""
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.parallel.dp import make_param_sharded_train_step
    m = _mesh(axes)
    model = model_from_json(spec, device="cpu")
    specs = _specs(model, m, fsdp_min_size)
    opt = build_optimizer("gradient_descent", lr, None)
    with m.bind():
        place, params = _placed(model, m, specs, p0)
        state = opt.init(params)
        step = make_param_sharded_train_step(model, opt, m, input_name,
                                             label_name, specs, place.template)
        dpn = m.shape.get("dp", 1)
        di = m.axis_index("dp") if "dp" in m.shape else 0
        b = x.shape[0] // dpn
        rows = slice(di * b, (di + 1) * b)
        params, state, loss = step(params, state, torch.tensor(x[rows]),
                                   torch.tensor(y[rows]), torch.ones(b), 0)
        local_bytes = sum(t.numel() * t.element_size()
                          for d in params.values() for t in d.values())
        return {"loss": float(loss), "params": _tree_np(place.gather(params)),
                "local_bytes": local_bytes}


def public_sharded_step(spec, axes, p0, x, y, lr=0.1):
    """One gradient-descent step of ``parallel.tp.make_sharded_train_step``
    (the model's own specs) from the standard ``p0``, on this rank's dp
    block of the rows: the loss and the gathered standard params."""
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer, tree_map
    from sparkflow_tpu_torch.parallel.tp import make_sharded_train_step
    m = _mesh(axes)
    model = model_from_json(spec, device="cpu")
    opt = build_optimizer("gradient_descent", lr, None)
    with m.bind():
        step = make_sharded_train_step(model, opt, m, "input_ids", "y")
        params = tree_map(lambda t: t.requires_grad_(True),
                          step.placement.place(_tree_t(p0)))
        dpn = m.shape.get("dp", 1)
        di = m.axis_index("dp") if "dp" in m.shape else 0
        b = x.shape[0] // dpn
        rows = slice(di * b, (di + 1) * b)
        params, _, loss = step(params, opt.init(params),
                               torch.tensor(x[rows]), torch.tensor(y[rows]),
                               torch.ones(b), 0)
        return {"loss": float(loss),
                "params": _tree_np(step.placement.gather(params))}


def tp_grads(spec, axes, p0, feeds):
    """The masked-mean loss and its gradient (standard layout) through the
    Megatron forward on this rank's tp slices — no optimizer, no dp sum."""
    import copy
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import tree_leaves
    m = _mesh(axes)
    model = model_from_json(spec, device="cpu")
    specs = _specs(model, m, None)
    with m.bind():
        place, params = _placed(model, m, specs, p0)
        tp_model = copy.copy(model)
        tp_model.tp_axis = "tp"
        lv = tp_model.loss_vector(params, {k: torch.tensor(v) for k, v in
                                           feeds.items()}, train=False)
        loss = lv.mean()
        leaves = tree_leaves(params)
        grads = iter(torch.autograd.grad(loss, leaves))
        gtree = {k: {kk: next(grads) for kk in d} for k, d in params.items()}
        return {"loss": float(loss),
                "grads": _tree_np(place.gather(gtree))}


def tp_trainer_fit(spec, axes, trainer_kw, x, y, init_params=None):
    """``trainer_fit`` for a model with named inputs: ``trainer_kw`` carries
    ``inputs=(input_name, label_name)``; also the final optimizer state."""
    from sparkflow_tpu_torch.trainer import Trainer
    kw = dict(trainer_kw)
    inputs = kw.pop("inputs")
    t = Trainer(spec, inputs[0], inputs[1], mesh=_mesh(axes), device="cpu",
                **kw)
    r = t.fit(x, y, init_params=init_params)
    return {"losses": r.losses, "params": _tree_np(r.params),
            "stop": r.stop_reason, "stats": t.last_mesh_stats,
            "opt_state": _opt_np(t._last_opt_state),
            "resumed_from": t._resumed_from}


def tp_stream_fit(spec, axes, trainer_kw, x, y, init_params=None):
    """``fit_stream`` in place for a model with named inputs (``inputs`` in
    ``trainer_kw``) over the rows ``(x[i], y[i])``."""
    from sparkflow_tpu_torch.trainer import Trainer
    kw = dict(trainer_kw)
    inputs = kw.pop("inputs")
    t = Trainer(spec, inputs[0], inputs[1], mesh=_mesh(axes), device="cpu",
                **kw)
    rows = list(zip(list(x), list(y))) if inputs[1] else list(x)
    r = t.fit_stream(lambda: iter(rows), init_params=init_params, chunk=64)
    return {"losses": r.losses, "params": _tree_np(r.params),
            "stats": t.last_mesh_stats}


# -- pipeline parallelism -----------------------------------------------------


def pp_steps(spec, axes, p0, ids, y, schedule="gpipe", microbatches=2,
             task="classifier", optimizer="gradient_descent", lr=0.1,
             steps=1, opt_kw=None, device="cpu"):
    """``steps`` of ``make_pp_train_step`` from the standard ``p0`` on this
    rank's dp block of the rows (seed 0, the step index): the losses, the
    standard params (gathered), this rank's param bytes and hop bytes.
    ``device="cuda"``: the rank's card, TF32 off."""
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.parallel import collectives as C
    from sparkflow_tpu_torch.parallel.pp import (StagePlacement,
                                                 make_pp_train_step)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        device = f"cuda:{torch.cuda.current_device()}"
    m = _mesh(axes)
    model = model_from_json(spec, device=device)
    opt = build_optimizer(optimizer, lr, opt_kw)
    with m.bind():
        std = _tree_t(p0, device)
        place = StagePlacement(model, m, std)
        params = tree_grad(place.place(std))
        state = opt.init(params)
        step = make_pp_train_step(model, opt, m, n_microbatches=microbatches,
                                  schedule=schedule, task=task)
        dpn = m.shape.get("dp", 1)
        di = m.axis_index("dp") if "dp" in m.shape else 0
        b = ids.shape[0] // dpn
        rows = slice(di * b, (di + 1) * b)
        C.reset_stats()
        losses = []
        for i in range(steps):
            params, state, loss = step(params, state,
                                       torch.tensor(ids[rows], device=device),
                                       torch.tensor(y[rows], device=device),
                                       i)
            losses.append(float(loss))
        local_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(params))
        return {"losses": losses, "params": _tree_np(place.gather(params)),
                "local_bytes": local_bytes, "ticks": step.schedule_ticks,
                "moved": C.stats()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def tree_grad(tree):
    if isinstance(tree, dict):
        return {k: tree_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


# -- expert parallelism -------------------------------------------------------


def ep_collectives(axes, xs, gs):
    """``all_to_all`` and ``psum_grad`` over ``ep`` on this rank's
    ``xs[rank]`` [n, ...]: the values and the gradients of ``sum(out *
    gs[rank])``."""
    from sparkflow_tpu_torch.parallel import collectives as C
    m = _mesh(axes)
    r = dist.get_rank()
    g = torch.tensor(gs[r])
    with m.bind():
        x = torch.tensor(xs[r], requires_grad=True)
        a2a = C.all_to_all(x, "ep")
        (dx_a2a,) = torch.autograd.grad((a2a * g).sum(), x)
        x = torch.tensor(xs[r], requires_grad=True)
        ps = C.psum_grad(x, "ep")
        (dx_ps,) = torch.autograd.grad((ps * g).sum(), x)
        return {"a2a": _np(a2a), "a2a_grad": _np(dx_a2a), "psum": _np(ps),
                "psum_grad": _np(dx_ps), "stats": C.stats()}


def moe_ffn(axes, x, mask, params, gy, top_k, cf, aux_w):
    """``all_to_all_moe_ffn`` over ``ep`` on this rank's block of the rows
    of ``x`` [B, S, H] (and ``mask``), with this rank's slice of the expert
    bank: the output, aux, overflow and the gradients of ``sum(y * gy) +
    aux_w * aux`` for x, the router and the rank's expert slices."""
    from sparkflow_tpu_torch.ops.moe_dispatch import all_to_all_moe_ffn
    m = _mesh(axes)
    n = m.shape["ep"]
    r = dist.get_rank()
    b = x.shape[0] // n
    rows = slice(r * b, (r + 1) * b)
    e_loc = params["experts_fc1"].shape[0] // n
    loc = {k: torch.tensor(v[r * e_loc:(r + 1) * e_loc] if k.startswith(
        "experts") else v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x[rows], requires_grad=True)
    mt = None if mask is None else torch.tensor(mask[rows])
    with m.bind():
        y, aux, over = all_to_all_moe_ffn(
            xt, loc["router"], loc["experts_fc1"], loc["experts_b1"],
            loc["experts_fc2"], loc["experts_b2"], "ep",
            params["router"].shape[1], cf, mt, top_k=top_k,
            return_overflow=True)
        loss = (y * torch.tensor(gy[rows])).sum() + aux_w * aux
        names = ["router", "experts_fc1", "experts_b1", "experts_fc2",
                 "experts_b2"]
        grads = torch.autograd.grad(loss, [xt] + [loc[k] for k in names])
    return {"y": _np(y), "aux": float(aux), "overflow": float(over),
            "grads": {k: _np(g) for k, g in zip(["x"] + names, grads)}}


def moe_shardmap_steps(spec, axes, p0, ids, mask, opt_name, lr, steps,
                       opt_options=None):
    """``steps`` steps of ``make_moe_shardmap_train_step`` from ``p0`` on
    this rank's block of the rows: the losses and the gathered params."""
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer
    from sparkflow_tpu_torch.parallel.ep import (make_moe_shardmap_train_step,
                                                 place_moe_params)
    from sparkflow_tpu_torch.parallel.tp import gather_params
    m = _mesh(axes)
    model = model_from_json(spec, device="cpu")
    opt = build_optimizer(opt_name, lr, opt_options)
    with m.bind():
        n = m.shape["ep"]
        r = m.axis_index("ep")
        b = ids.shape[0] // n
        std = _tree_t(p0)
        params = place_moe_params(model, std, m)
        params = {k: {kk: t.requires_grad_(True) for kk, t in d.items()}
                  for k, d in params.items()}
        state = opt.init(params)
        step = make_moe_shardmap_train_step(model, opt, m)
        losses = []
        for i in range(steps):
            params, state, loss = step(
                params, state, torch.tensor(ids[r * b:(r + 1) * b]).long(),
                torch.tensor(mask[r * b:(r + 1) * b]), i)
            losses.append(float(loss))
        full = gather_params({k: {kk: t.detach() for kk, t in d.items()}
                              for k, d in params.items()}, m,
                             model.param_pspecs(), std)
        return {"losses": losses, "params": _tree_np(full)}
