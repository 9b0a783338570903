"""Hyperparameter parallelism: train K learning rates in ONE program — the
port of the JAX package's ``parallel/hyper.py``.

The JAX package ``jax.vmap``s one training run over the rate axis, with
the rate as data (``optax.inject_hyperparams``). Here the same run is
``torch.func.vmap`` over ``torch.func.grad`` of the model's loss and the
port's functional optimizers, the rate a tensor: every replica's
parameters and optimizer state are stacked on a leading K axis, and every
step is one batched call, so the products run over all K replicas at once
and the flash kernels launch once per layer and step for all of them
(:class:`~sparkflow_tpu_torch.ops.attention.FlashAttentionFunction`'s
batching rule folds K into the batch).

Every configuration sees the same batches: one shuffle per epoch from
``seed``, shared, as JAX shares its epoch keys. Dropout draws one mask for
all replicas (``randomness="same"``), as JAX's shared step keys do.
Configurations that change the model's structure need separate fits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import optimizers as O
from ..core import make_loss_fn, pad_to_batches
from .dp import fold_in


class HyperResult:
    """Outcome of a vmapped sweep, sorted views included."""

    __slots__ = ("learning_rates", "final_losses", "loss_curves",
                 "best_index", "best_learning_rate", "best_params")

    def __init__(self, learning_rates, final_losses, loss_curves, best_index,
                 best_params):
        self.learning_rates = list(learning_rates)
        self.final_losses = list(final_losses)
        self.loss_curves = loss_curves
        self.best_index = int(best_index)
        self.best_learning_rate = self.learning_rates[self.best_index]
        self.best_params = best_params


#: the JAX package's ``OPTIMIZER_BUILDERS``: each name's optax constructor
#: with optax's defaults, as ``inject_hyperparams`` builds it
OPTIMIZER_BUILDERS = {
    "adam": O.adam,
    "rmsprop": lambda lr: O.rmsprop(lr, decay=0.9, eps=1e-8, momentum=None),
    "momentum": lambda lr: O.sgd(lr, momentum=0.9),
    "adadelta": lambda lr: O.adadelta(lr, rho=0.9, eps=1e-6),
    "adagrad": lambda lr: O.adagrad(lr, initial_accumulator_value=0.1),
    "gradient_descent": O.sgd,
    "ftrl": O.ftrl,
    "adagrad_da": O.adagrad_da,
    "proximal_adagrad": O.proximal_adagrad,
    "proximal_gradient_descent": O.proximal_gradient_descent,
}


def _injectable(optimizer_name: str):
    """The constructor ``lr -> transformation`` of ``optimizer_name``;
    unknown names fall back to SGD, as the reference's ``build_optimizer``
    does."""
    return OPTIMIZER_BUILDERS.get(optimizer_name, O.sgd)


def _model_of(graph, device):
    from ..graphdef import GraphDef, GraphModel
    if isinstance(graph, str):
        from ..models import model_from_json
        return model_from_json(graph, device=device)
    if isinstance(graph, GraphDef):
        return GraphModel(graph, device=device)
    if hasattr(graph, "loss_vector"):
        return graph
    raise TypeError(f"graph must be a spec JSON string, a GraphDef, or a "
                    f"model; got {type(graph).__name__}")


def _stack(trees):
    return {ln: {k: torch.stack([t[ln][k].detach() for t in trees])
                 for k in trees[0][ln]} for ln in trees[0]}


def hyperparameter_search(graph, input_name: str, label_name: Optional[str],
                          features: np.ndarray,
                          labels: Optional[np.ndarray],
                          learning_rates: Sequence[float],
                          optimizer: str = "adam",
                          iters: int = 10,
                          mini_batch_size: int = 128,
                          seed: int = 0,
                          same_init: bool = True,
                          device=None) -> HyperResult:
    """Train ``len(learning_rates)`` replicas of the model concurrently, one
    per learning rate, and return per-config loss curves + the best params.

    ``same_init=True`` gives every replica identical initial weights
    (isolates the learning-rate effect); ``False`` gives each its own init
    seed. ``graph`` is a spec JSON string, a ``GraphDef`` or a model (whose
    ``init(seed=)`` draws the initial weights). ``device``: the CUDA card
    unless ``"cpu"`` is asked for.
    """
    model = _model_of(graph, device)
    dev = model.device
    lrs = np.asarray(np.asarray(learning_rates, np.float64), np.float32)
    k = lrs.shape[0]
    loss_fn = make_loss_fn(model, input_name, label_name)

    x = np.ascontiguousarray(features, dtype=np.float32)
    n = x.shape[0]
    if labels is not None:
        y = np.ascontiguousarray(labels, dtype=np.float32)
        if y.ndim == 1:
            y = y[:, None]
    else:
        y = np.zeros((n, 1), np.float32)
    batch = min(mini_batch_size if mini_batch_size > 0 else n, n)
    num_batches = -(-n // batch)
    x_pad, mask = pad_to_batches(x, batch, num_batches)
    y_pad, _ = pad_to_batches(y, batch, num_batches)
    # the data is staged on the device once
    xp = torch.as_tensor(x_pad, device=dev)
    yp = torch.as_tensor(y_pad, device=dev)
    mk = torch.as_tensor(mask, device=dev)

    ctor = _injectable(optimizer)
    seeds = ([seed] * k if same_init
             else [fold_in(fold_in(seed, 1), i) for i in range(k)])
    params = _stack([model.init(seed=s) for s in seeds])
    rates = torch.as_tensor(lrs, device=dev)
    state_leaves, state_spec = pytree.tree_flatten(
        ctor(rates[0]).init(params))
    is_t = [torch.is_tensor(v) for v in state_leaves]
    # the state's non-tensor leaves (step counts) are the same in every
    # replica and follow from the step count alone: the host advances them
    # with the optimizer's own update on a tree of scalars, and the mapped
    # step takes them unmapped
    ghost = O.tree_map(lambda v: torch.zeros(()), params)
    ghost_opt = ctor(float(lrs[0]))
    ghost_state = ghost_opt.init(ghost)

    def consts_of(state):
        return [v for v, t in zip(pytree.tree_leaves(state), is_t) if not t]

    def train_one(p, tensors, consts, lr, xb, yb, mb):
        opt = ctor(lr)
        it, ic = iter(tensors), iter(consts)
        state = pytree.tree_unflatten(
            [next(it) if t else next(ic) for t in is_t], state_spec)
        grads, loss = torch.func.grad_and_value(
            lambda q: loss_fn(q, xb, yb, mb))(p)
        updates, state = opt.update(grads, state, p)
        p = O.tree_map(lambda a, u: a + u.to(a.dtype), p, updates)
        return p, [v for v, t in zip(pytree.tree_leaves(state), is_t)
                   if t], loss

    step = torch.func.vmap(train_one,
                           in_dims=(0, 0, None, 0, None, None, None),
                           randomness="same")
    tensors = [v for v, t in zip(state_leaves, is_t) if t]
    shuffle = torch.Generator().manual_seed(int(fold_in(seed, 2)))
    curves = []
    with torch.no_grad():
        for _ in range(int(iters)):
            perm = torch.randperm(num_batches * batch,
                                  generator=shuffle).to(dev)
            xs, ys, ms = xp[perm], yp[perm], mk[perm]
            losses = []
            for b in range(num_batches):
                rows = slice(b * batch, (b + 1) * batch)
                params, tensors, loss = step(params, tensors,
                                             consts_of(ghost_state), rates,
                                             xs[rows], ys[rows], ms[rows])
                _, ghost_state = ghost_opt.update(ghost, ghost_state, ghost)
                losses.append(loss)
            curves.append(torch.stack(losses).mean(0))
    curves = torch.stack(curves, 1).float().cpu().numpy()          # [K, iters]
    final = curves[:, -1]
    best = int(np.nanargmin(final))
    best_params = {ln: {kk: v[best].clone() for kk, v in layer.items()}
                   for ln, layer in params.items()}
    return HyperResult(list(lrs), list(final), curves, best, best_params)


__all__ = ["HyperResult", "OPTIMIZER_BUILDERS", "hyperparameter_search"]
