"""Optimizer registry: the reference's 10 named optimizers, functional.

The port of the JAX package's ``optimizers.py``, which builds them on optax.
Here each optimizer is a :class:`GradientTransformation` like optax's — a
pair ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)`` over a params tree (``{layer: {name: tensor}}``) — and
:func:`apply_updates` adds the updates to the parameters. The update rules,
option keys, defaults and wrappers (clipping, decoupled weight decay,
gradient accumulation, learning-rate schedules, weight EMA) follow the JAX
package and the optax functions it calls, operation for operation, so a
fit in either package takes the same steps.

Differences from optax that do not change a number:

- ``update`` returns NEW state tensors and leaves the old state as it was,
  as optax does; :func:`apply_updates` adds the updates to the parameter
  tensors IN PLACE (under ``torch.no_grad``), so the trainer keeps one
  parameter tree on the card instead of a second copy per step;
- step counters are Python ints; scalar factors (bias corrections, schedule
  values) are computed in float32 like optax's;
- unknown optimizer names fall back to gradient_descent, as the reference
  does; ``use_locking`` is accepted and ignored.

ZeRO weight-update sharding lives in :mod:`.optimizers_sharded`; its
``sharded_update``, ``zero1_state_specs``, ``place_zero1_state``,
``gather_zero1_state``, ``shard_zero1_state`` and ``has_per_param_state``
are re-exported here, as the JAX module does.
"""

from __future__ import annotations

import contextlib
import json
import math
from contextvars import ContextVar
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

Tree = Any
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``."""
    init: Callable
    update: Callable


# ---------------------------------------------------------------------------
# Tree helpers (params trees are nested dicts of tensors)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over dicts of tensors with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params += updates`` leaf by leaf, in place; returns ``params``."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params


def _f32(x: float) -> float:
    """``x`` rounded to float32, as optax holds its hyperparameters."""
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32 (optax ``tree_bias_correction``)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _zeros(params: Tree, dtype=None) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)


def _full(params: Tree, value: float) -> Tree:
    return tree_map(lambda p: torch.full_like(p, value), params)


def _scale(step: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: (),
        lambda g, state, params=None: (tree_map(lambda u: u * step, g), state))


def _chain(*ts: GradientTransformation) -> GradientTransformation:
    """optax.chain: the transformations in order, their states as a tuple."""
    def init(params):
        return tuple(t.init(params) for t in ts)

    def update(g, state, params=None):
        new = []
        for t, s in zip(ts, state):
            g, s = t.update(g, s, params)
            new.append(s)
        return g, tuple(new)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# Base transformations (optax's, as the JAX package uses them)
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


def _scale_by_adam(b1: float, b2: float, eps: float,
                   mu_dtype=None) -> GradientTransformation:
    b1, b2 = _f32(b1), _f32(b2)

    def init(params):
        return AdamState(0, _zeros(params, mu_dtype), _zeros(params))

    def update(g, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda u, m: (1 - b1) * u + b1 * m.float(), g, state.mu)
        nu = tree_map(lambda u, n: (1 - b2) * u * u + b2 * n, g, state.nu)
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        upd = tree_map(lambda m, n: (m / c1) / (torch.sqrt(n / c2) + eps),
                       mu, nu)
        if mu_dtype is not None:
            mu = tree_map(lambda m: m.to(mu_dtype), mu)
        return upd, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def _trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax.trace: momentum ``t = g + decay * t`` (Nesterov: ``g + decay *
    t_new``)."""
    def update(g, state, params=None):
        t = tree_map(lambda u, tr: u + decay * tr, g, state)
        out = tree_map(lambda u, tr: u + decay * tr, g, t) if nesterov else t
        return out, t

    return GradientTransformation(_zeros, update)


class RmsState(NamedTuple):
    mu: Tree    # None unless centered
    nu: Tree


def _scale_by_rms(decay: float, eps: float,
                  centered: bool) -> GradientTransformation:
    def init(params):
        return RmsState(_zeros(params) if centered else None, _zeros(params))

    def update(g, state, params=None):
        nu = tree_map(lambda u, n: (1 - decay) * u * u + decay * n, g,
                      state.nu)
        if centered:
            mu = tree_map(lambda u, m: (1 - decay) * u + decay * m, g,
                          state.mu)
            upd = tree_map(lambda u, m, n: u * torch.rsqrt(n - m * m + eps),
                           g, mu, nu)
        else:
            mu = None
            upd = tree_map(lambda u, n: u * torch.rsqrt(n + eps), g, nu)
        return upd, RmsState(mu, nu)

    return GradientTransformation(init, update)


class AdadeltaState(NamedTuple):
    e_g: Tree
    e_x: Tree


def _scale_by_adadelta(rho: float, eps: float) -> GradientTransformation:
    def init(params):
        return AdadeltaState(_zeros(params), _zeros(params))

    def update(g, state, params=None):
        e_g = tree_map(lambda u, e: (1 - rho) * u * u + rho * e, g, state.e_g)
        upd = tree_map(lambda u, eg, ex: torch.sqrt(ex + eps)
                       / torch.sqrt(eg + eps) * u, g, e_g, state.e_x)
        e_x = tree_map(lambda u, e: (1 - rho) * u * u + rho * e, upd,
                       state.e_x)
        return upd, AdadeltaState(e_g, e_x)

    return GradientTransformation(init, update)


def _scale_by_rss(initial: float, eps: float = 1e-7) -> GradientTransformation:
    """optax.scale_by_rss (adagrad's accumulator)."""
    def update(g, state, params=None):
        acc = tree_map(lambda u, a: u * u + a, g, state)
        upd = tree_map(lambda u, a: torch.where(a > 0, torch.rsqrt(a + eps),
                                                0.0) * u, g, acc)
        return upd, acc

    return GradientTransformation(lambda p: _full(p, initial), update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, mu_dtype=None):
    return _chain(_scale_by_adam(b1, b2, eps, mu_dtype), _scale(-lr))


def rmsprop(lr, decay=0.9, eps=1e-10, centered=False, momentum=0.0):
    return _chain(_scale_by_rms(decay, eps, centered), _scale(-lr),
                  _trace(momentum) if momentum is not None else _chain())


def sgd(lr, momentum=None, nesterov=False):
    return _chain(_trace(momentum, nesterov) if momentum is not None
                  else _chain(), _scale(-lr))


def adadelta(lr, rho=0.95, eps=1e-8):
    return _chain(_scale_by_adadelta(rho, eps), _scale(-lr))


def adagrad(lr, initial_accumulator_value=0.1):
    return _chain(_scale_by_rss(initial_accumulator_value), _scale(-lr))


# ---------------------------------------------------------------------------
# The TF1 optimizers optax does not ship (the JAX package's custom ones)
# ---------------------------------------------------------------------------


class FtrlState(NamedTuple):
    n: Tree   # sum of squared gradients
    z: Tree   # ftrl dual variable


def ftrl(learning_rate: float = 0.001, learning_rate_power: float = -0.5,
         initial_accumulator_value: float = 0.1,
         l1_regularization_strength: float = 0.0,
         l2_regularization_strength: float = 0.0) -> GradientTransformation:
    """FTRL-Proximal (McMahan et al.), TF1 ``tf.train.FtrlOptimizer``."""
    lr, p = learning_rate, -learning_rate_power
    l1, l2 = l1_regularization_strength, l2_regularization_strength

    def init(params):
        return FtrlState(_full(params, initial_accumulator_value),
                         _zeros(params))

    def update(grads, state, params):
        def leaf(g, n, z, w):
            n_new = n + g * g
            sigma = (torch.pow(n_new, p) - torch.pow(n, p)) / lr
            z_new = z + g - sigma * w
            w_new = torch.where(
                z_new.abs() <= l1, torch.zeros_like(w),
                -(z_new - torch.sign(z_new) * l1)
                / (torch.pow(n_new, p) / lr + 2.0 * l2))
            return w_new - w, n_new, z_new

        out = tree_map(leaf, grads, state.n, state.z, params)
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), FtrlState(pick(1), pick(2))

    return GradientTransformation(init, _needs_params("ftrl", update))


class AdagradDAState(NamedTuple):
    step: int
    g_acc: Tree
    gg_acc: Tree


def adagrad_da(learning_rate: float = 0.001,
               initial_gradient_squared_accumulator_value: float = 0.1,
               l1_regularization_strength: float = 0.0,
               l2_regularization_strength: float = 0.0
               ) -> GradientTransformation:
    """Adagrad Dual Averaging (Xiao 2010), TF1 ``AdagradDAOptimizer``."""
    lr = learning_rate
    l1, l2 = l1_regularization_strength, l2_regularization_strength

    def init(params):
        return AdagradDAState(
            0, _zeros(params),
            _full(params, initial_gradient_squared_accumulator_value))

    def update(grads, state, params):
        t = float(state.step + 1)

        def leaf(g, ga, gg, w):
            ga_new = ga + g
            gg_new = gg + g * g
            clipped = torch.sign(ga_new) * torch.clamp_min(
                ga_new.abs() - l1 * t, 0.0)
            w_new = -lr * clipped / (torch.sqrt(gg_new) + l2 * t * lr)
            return w_new - w, ga_new, gg_new

        out = tree_map(leaf, grads, state.g_acc, state.gg_acc, params)
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), AdagradDAState(state.step + 1, pick(1), pick(2))

    return GradientTransformation(init, _needs_params("adagrad_da", update))


def _prox(w, step_size, l1, l2):
    """Proximal operator for l1/l2 (TF1 proximal_* semantics)."""
    shrunk = torch.sign(w) * torch.clamp_min(w.abs() - step_size * l1, 0.0)
    return shrunk / (1.0 + step_size * l2)


class ProximalAdagradState(NamedTuple):
    accum: Tree


def proximal_adagrad(learning_rate: float = 0.001,
                     initial_accumulator_value: float = 0.1,
                     l1_regularization_strength: float = 0.0,
                     l2_regularization_strength: float = 0.0
                     ) -> GradientTransformation:
    lr = learning_rate
    l1, l2 = l1_regularization_strength, l2_regularization_strength

    def update(grads, state, params):
        def leaf(g, a, w):
            a_new = a + g * g
            step = lr / torch.sqrt(a_new)
            return _prox(w - step * g, step, l1, l2) - w, a_new

        out = tree_map(leaf, grads, state.accum, params)
        return (tree_map(lambda o: o[0], out),
                ProximalAdagradState(tree_map(lambda o: o[1], out)))

    return GradientTransformation(
        lambda p: ProximalAdagradState(_full(p, initial_accumulator_value)),
        _needs_params("proximal_adagrad", update))


def proximal_gradient_descent(learning_rate: float = 0.001,
                              l1_regularization_strength: float = 0.0,
                              l2_regularization_strength: float = 0.0
                              ) -> GradientTransformation:
    lr = learning_rate
    l1, l2 = l1_regularization_strength, l2_regularization_strength

    def update(grads, state, params):
        return tree_map(lambda g, w: _prox(w - lr * g, lr, l1, l2) - w,
                        grads, params), state

    return GradientTransformation(
        lambda p: (), _needs_params("proximal_gradient_descent", update))


def _needs_params(name: str, update: Callable) -> Callable:
    def checked(grads, state, params=None):
        if params is None:
            raise ValueError(f"{name} requires params")
        return update(grads, state, params)
    return checked


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _clip(max_delta: float) -> GradientTransformation:
    return GradientTransformation(
        lambda p: (),
        lambda g, s, params=None: (
            tree_map(lambda u: u.clamp(-max_delta, max_delta), g), s))


_NORM_SQ: ContextVar = ContextVar("sparkflow_torch_global_norm_sq",
                                   default=None)


@contextlib.contextmanager
def global_norm_sq(fn: Callable):
    """Within the block, ``clip_norm``'s squared global norm is ``fn(leaves)``
    of the gradient tree's leaves (in ``tree_leaves`` order) — a sharded
    step's rule: the squares of its sharded leaves summed over their axes,
    its replicated leaves counted once."""
    tok = _NORM_SQ.set(fn)
    try:
        yield
    finally:
        _NORM_SQ.reset(tok)


def _clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(g, state, params=None):
        fn = _NORM_SQ.get()
        leaves = tree_leaves(g)
        norm = torch.sqrt(fn(leaves) if fn is not None
                          else sum((u * u).sum() for u in leaves))
        keep = norm < max_norm
        return tree_map(lambda u: torch.where(
            keep, u, (u / norm.to(u.dtype)) * max_norm), g), state

    return GradientTransformation(lambda p: (), update)


def _with_decoupled_decay(inner: GradientTransformation, weight_decay: float,
                          lr: float) -> GradientTransformation:
    """Add ``-lr * weight_decay * param`` to the inner update (AdamW-style
    decoupled decay)."""
    def update(g, state, params=None):
        if params is None:
            raise ValueError("weight_decay needs params at update time")
        u, s = inner.update(g, state, params)
        return tree_map(lambda du, p: du - lr * weight_decay * p, u,
                        params), s

    return GradientTransformation(inner.init, update)


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner: Any
    acc_grads: Tree


def _multi_steps(inner: GradientTransformation,
                 every_k: int) -> GradientTransformation:
    """optax.MultiSteps: average the gradients of ``every_k`` mini-steps
    (Welford mean) and apply the inner update on the last one; zero updates
    in between."""
    def init(params):
        return MultiStepsState(0, 0, inner.init(params), _zeros(params))

    def update(g, state, params=None):
        n = state.mini_step
        acc = tree_map(lambda u, a: a + (u - a) / (n + 1), g, state.acc_grads)
        if n != every_k - 1:
            return (tree_map(torch.zeros_like, g),
                    MultiStepsState(n + 1, state.gradient_step, state.inner,
                                    acc))
        u, s = inner.update(acc, state.inner, params)
        return u, MultiStepsState(0, state.gradient_step + 1, s,
                                  tree_map(torch.zeros_like, acc))

    return GradientTransformation(init, update)


def _scale_by_schedule(schedule: Schedule) -> GradientTransformation:
    def update(g, count, params=None):
        step = _f32(schedule(count))
        return tree_map(lambda u: u * step, g), count + 1

    return GradientTransformation(lambda p: 0, update)


class WeightEmaState(NamedTuple):
    inner: Any
    ema: Tree
    count: int
    decay: float  # kept in the state so extraction needs no config


def _with_weight_ema(inner: GradientTransformation, decay: float,
                     skip_zero_updates: bool = False
                     ) -> GradientTransformation:
    """Maintain an exponential moving average of the POST-update weights in
    the optimizer state (Polyak averaging); :func:`extract_ema_params`
    recovers the debiased average."""
    decay32 = _f32(decay)

    def init(params):
        return WeightEmaState(inner.init(params), _zeros(params), 0, decay32)

    def update(g, state, params=None):
        if params is None:
            raise ValueError("ema_decay needs params at update time")
        u, s = inner.update(g, state.inner, params)
        changed = 1.0
        if skip_zero_updates:
            # blend only on applied (nonzero) updates: under accumulation
            # the mini-steps between boundaries emit zeros
            changed = float(sum(x.abs().sum() for x in tree_leaves(u)) > 0)
        d_eff = _f32(1.0 - (1.0 - state.decay) * changed)
        ema = tree_map(lambda e, p, du: d_eff * e + (1.0 - d_eff) * (p + du),
                       state.ema, params, u)
        return u, WeightEmaState(s, ema, state.count + int(changed),
                                 state.decay)

    return GradientTransformation(init, update)


def extract_ema_params(opt_state) -> Optional[Tree]:
    """The debiased EMA weight tree from an ``ema_decay``-enabled optimizer
    state, or None when EMA is not enabled or never updated."""
    def find(s):
        if isinstance(s, WeightEmaState):
            return s
        if isinstance(s, tuple):
            for child in s:
                got = find(child)
                if got is not None:
                    return got
        return None

    st = find(opt_state)
    if st is None or st.count == 0:
        return None
    corr = max(_bias_correction(st.decay, st.count), 1e-12)
    return tree_map(lambda e: e / corr, st.ema)


def build_schedule(cfg) -> Schedule:
    """JSON-friendly schedule spec -> ``count -> factor`` of the configured
    learning rate (1.0 = unchanged); the JAX package's ``build_schedule``:

    ``{"type": "warmup_cosine", "warmup_steps": W, "decay_steps": D,
       "end_factor": a}`` — linear 0->1 over W, cosine 1->a over D;
    ``"cosine"``, ``"linear"`` (``decay_steps``, ``end_factor``),
    ``"exponential"`` (``decay_steps``, ``decay_rate``), ``"warmup"``
    (``warmup_steps``)."""
    if callable(cfg):
        return cfg
    if isinstance(cfg, str):
        cfg = {"type": cfg}
    if not isinstance(cfg, dict):
        raise ValueError(
            f"schedule spec must be a dict like {{'type': 'warmup_cosine', "
            f"...}}, a type name string, or a callable; got {cfg!r}")
    kind = cfg.get("type", "warmup_cosine")
    warm = int(cfg.get("warmup_steps", 0))
    decay = int(cfg.get("decay_steps", 0))
    end = float(cfg.get("end_factor", 0.0))
    if kind == "warmup":
        return _linear(0.0, 1.0, max(1, warm))
    if kind == "linear":
        return _linear(1.0, end, max(1, decay))
    if kind == "exponential":
        return _exponential(max(1, decay), float(cfg.get("decay_rate", 0.96)))
    if kind == "cosine":
        return _cosine(max(1, decay), end)
    if kind == "warmup_cosine":
        if not warm:
            return _cosine(max(1, decay), end)
        warmup = _linear(0.0, 1.0, warm)
        cos = _cosine(max(warm + 1, warm + decay) - warm, end)
        return lambda c: warmup(c) if c < warm else cos(c - warm)
    raise ValueError(f"unknown schedule type {kind!r}; known: warmup, "
                     f"linear, exponential, cosine, warmup_cosine")


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    def f(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _exponential(steps: int, rate: float) -> Schedule:
    """optax.exponential_decay from 1.0 (no staircase, no end value)."""
    if rate == 0:
        return lambda count: 1.0
    return lambda count: 1.0 if count <= 0 else rate ** (count / steps)


def _cosine(steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule from 1.0 to ``alpha``."""
    def f(count):
        c = min(count, steps)
        cos = 0.5 * (1 + math.cos(math.pi * c / steps))
        return (1 - alpha) * cos + alpha
    return f


# ---------------------------------------------------------------------------
# Registry / factory
# ---------------------------------------------------------------------------


def _pop(options: Dict[str, Any], *names, default=None):
    for n in names:
        if n in options:
            return options.pop(n)
    return default


def build_optimizer(optimizer_name: str, learning_rate: Optional[float] = None,
                    optimizer_options: Optional[Dict[str, Any]] = None
                    ) -> GradientTransformation:
    """Name + TF1-style options dict -> transformation; the JAX package's
    ``build_optimizer``: without options, ``learning_rate`` with TF-like
    defaults; unknown names fall back to gradient_descent. Extra keys:
    ``clip_value``, ``clip_norm`` (on the raw gradient), ``weight_decay``
    (decoupled), ``grad_accum_steps``, ``schedule`` (counted in mini-steps)
    and ``ema_decay`` (outermost)."""
    opts = dict(optimizer_options or {})
    opts.pop("use_locking", None)
    lr = _pop(opts, "learning_rate",
              default=learning_rate if learning_rate is not None else 0.001)
    schedule = opts.pop("schedule", None)
    accum = int(opts.pop("grad_accum_steps", 0) or 0)
    clip_norm = opts.pop("clip_norm", None)
    clip_value = opts.pop("clip_value", None)
    weight_decay = float(opts.pop("weight_decay", 0.0) or 0.0)
    ema_decay = float(opts.pop("ema_decay", 0.0) or 0.0)

    base = _build_base_optimizer(optimizer_name, lr, opts)
    if weight_decay > 0.0:
        base = _with_decoupled_decay(base, weight_decay, lr)
    pre = []
    if clip_value is not None:
        pre.append(_clip(float(clip_value)))
    if clip_norm is not None:
        pre.append(_clip_by_global_norm(float(clip_norm)))
    if pre:
        base = _chain(*pre, base)
    if accum > 1:
        base = _multi_steps(base, accum)
    if schedule is not None:
        base = _chain(base, _scale_by_schedule(build_schedule(schedule)))
    if ema_decay:
        if not (0.0 < ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        base = _with_weight_ema(base, ema_decay, skip_zero_updates=accum > 1)
    return base


def _build_base_optimizer(optimizer_name: str, lr, opts
                          ) -> GradientTransformation:
    if optimizer_name == "adam":
        mu_dtype = _pop(opts, "mu_dtype", default=None)
        if isinstance(mu_dtype, str):
            mu_dtype = getattr(torch, mu_dtype)
        return adam(lr, b1=_pop(opts, "beta1", "b1", default=0.9),
                    b2=_pop(opts, "beta2", "b2", default=0.999),
                    eps=_pop(opts, "epsilon", "eps", default=1e-8),
                    mu_dtype=mu_dtype)
    if optimizer_name == "rmsprop":
        return rmsprop(lr, decay=_pop(opts, "decay", default=0.9),
                       eps=_pop(opts, "epsilon", "eps", default=1e-10),
                       centered=bool(_pop(opts, "centered", default=False)),
                       momentum=_pop(opts, "momentum", default=0.0))
    if optimizer_name == "momentum":
        return sgd(lr, momentum=_pop(opts, "momentum", default=0.9),
                   nesterov=bool(_pop(opts, "use_nesterov", default=False)))
    if optimizer_name == "adadelta":
        return adadelta(lr, rho=_pop(opts, "rho", default=0.95),
                        eps=_pop(opts, "epsilon", "eps", default=1e-8))
    if optimizer_name == "adagrad":
        return adagrad(lr, initial_accumulator_value=_pop(
            opts, "initial_accumulator", "initial_accumulator_value",
            default=0.1))
    l1 = lambda: _pop(opts, "l1_regularization_strength", default=0.0)  # noqa: E731
    l2 = lambda: _pop(opts, "l2_regularization_strength", default=0.0)  # noqa: E731
    if optimizer_name == "ftrl":
        return ftrl(lr, learning_rate_power=_pop(
                        opts, "learning_rate_power", default=-0.5),
                    initial_accumulator_value=_pop(
                        opts, "initial_accumulator_value", default=0.1),
                    l1_regularization_strength=l1(),
                    l2_regularization_strength=l2())
    if optimizer_name == "adagrad_da":
        return adagrad_da(lr, initial_gradient_squared_accumulator_value=_pop(
                              opts, "initial_gradient_squared_accumulator_value",
                              default=0.1),
                          l1_regularization_strength=l1(),
                          l2_regularization_strength=l2())
    if optimizer_name == "proximal_adagrad":
        return proximal_adagrad(lr, initial_accumulator_value=_pop(
                                    opts, "initial_accumulator_value",
                                    default=0.1),
                                l1_regularization_strength=l1(),
                                l2_regularization_strength=l2())
    if optimizer_name == "proximal_gradient_descent":
        return proximal_gradient_descent(lr, l1_regularization_strength=l1(),
                                         l2_regularization_strength=l2())
    # gradient_descent + unknown-name fallback (reference behaviour)
    return sgd(lr)


AVAILABLE_OPTIMIZERS = (
    "adam", "rmsprop", "momentum", "adadelta", "adagrad", "gradient_descent",
    "adagrad_da", "ftrl", "proximal_adagrad", "proximal_gradient_descent",
)

#: name -> ``lr -> transformation`` with optax's defaults, as the JAX
#: package's ``OPTIMIZER_BUILDERS`` builds each under
#: ``inject_hyperparams`` (the vmapped sweep, :mod:`.parallel.hyper`);
#: unknown names fall back to sgd there
OPTIMIZER_BUILDERS = {
    "adam": adam,
    "rmsprop": lambda lr: rmsprop(lr, decay=0.9, eps=1e-8, momentum=None),
    "momentum": lambda lr: sgd(lr, momentum=0.9),
    "adadelta": lambda lr: adadelta(lr, rho=0.9, eps=1e-6),
    "adagrad": lambda lr: adagrad(lr, initial_accumulator_value=0.1),
    "gradient_descent": sgd,
    "ftrl": ftrl,
    "adagrad_da": adagrad_da,
    "proximal_adagrad": proximal_adagrad,
    "proximal_gradient_descent": proximal_gradient_descent,
}


def build_optimizer_from_json(optimizer_name: str,
                              learning_rate: Optional[float],
                              optimizer_options_json: Optional[str]
                              ) -> GradientTransformation:
    opts = (json.loads(optimizer_options_json) if optimizer_options_json
            else None)
    return build_optimizer(optimizer_name, learning_rate, opts)


# ZeRO-1 weight-update sharding lives in its own module to keep this one a
# pure registry; re-exported here so "wrap any registry optimizer" reads as
# one import site (see optimizers_sharded for layout + checkpoint interop).
from .optimizers_sharded import (  # noqa: E402
    sharded_update,
    zero1_state_specs,
    place_zero1_state,
    gather_zero1_state,
    shard_zero1_state,
    has_per_param_state,
)
