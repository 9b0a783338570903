"""Expert parallelism through all_to_all (the communicating form) — the
port of the JAX package's ``parallel/ep.py``.

Two forms coexist, as in JAX:

1. The local bank (JAX's GSPMD default): the expert banks carry
   ``P('ep', ...)`` specs, a rank holds ``E/ep`` experts and its dp group's
   rows, and each MoE layer serves its experts' slots and sums over ``ep``
   (``models/moe.py``; the trainer's step is
   :func:`~.dp.make_param_sharded_train_step`).
2. This module: the batch AND the expert bank shard over ONE axis — every
   rank holds a batch shard plus ``E/n`` experts, and MoE layers exchange
   tokens with :func:`~.collectives.all_to_all`
   (:func:`~..ops.moe_dispatch.all_to_all_moe_ffn`), the GShard pipeline.

Gradients fall out of the layout: an expert leaf's gradient is complete on
its owner (it ran its experts over every token routed there); every other
leaf is replicated, so its gradient sums over the axis. The loss is the
ranks' summed per-example losses over the global row count.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..optimizers import apply_updates, tree_leaves
from . import collectives as C
from .dp import _leaf_specs, _unflatten, rank_generator
from .tp import filtered_pspecs, shard_params, spec_axes


def make_moe_shardmap_train_step(model, optimizer, mesh,
                                 ep_axis: str = "ep"):
    """Train step for an ``ep_axis``-enabled MoE LM (see
    ``transformer_moe_lm``'s ``ep_axis`` config), run on every rank inside
    ``with mesh.bind():``.

    Signature: ``step(params, opt_state, ids, mask, rng) -> (params,
    opt_state, loss)`` — ``ids`` / ``mask`` this rank's block of the global
    rows (the rows divide over the axis); ``params`` placed by
    :func:`place_moe_params` (expert leaves sliced over ``ep_axis``,
    everything else whole) and updated in place; ``rng`` an integer seed
    folded with the rank's index on the axis (JAX's ``fold_in(rng,
    axis_index)``) or a ``torch.Generator``; ``loss`` the global mean,
    equal on every rank.
    """
    if getattr(model, "ep_axis", None) != ep_axis:
        raise ValueError(
            f"model.ep_axis={getattr(model, 'ep_axis', None)!r}; build the "
            f"model with ep_axis={ep_axis!r} so its MoE layers dispatch via "
            f"all_to_all inside shard_map")
    specs = filtered_pspecs(model.param_pspecs(), mesh)

    def step(params, opt_state, ids, mask, rng):
        gen = rank_generator(rng, (ep_axis,), mask.device)
        lv = model.loss_vector(params, {"input_ids": ids,
                                        "attention_mask": mask},
                               train=True, generator=gen)
        s = lv.sum()
        leaves = tree_leaves(params)
        grads = list(torch.autograd.grad(s, leaves))
        tot = C.psum({"s": s.detach().float(),
                      "n": torch.tensor(float(ids.shape[0]),
                                        device=s.device)}, ep_axis)
        n_glob = tot["n"].clamp_min(1.0)
        loss = tot["s"] / n_glob
        with torch.no_grad():
            # an expert slice is complete on its owner; every other leaf
            # sums over the axis
            rep = [i for i, (_n, sp) in enumerate(_leaf_specs(params, specs))
                   if ep_axis not in spec_axes(sp)]
            if rep:
                summed = C.psum({str(i): grads[i] for i in rep}, ep_axis)
                for i in rep:
                    grads[i] = summed[str(i)]
            grads = [g / n_glob for g in grads]
            updates, opt_state = optimizer.update(
                _unflatten(params, grads), opt_state, params)
            apply_updates(params, updates)
        return params, opt_state, loss

    return step


def place_moe_params(model, params, mesh, rank: Optional[int] = None):
    """This rank's placement of a standard-layout MoE tree: the expert bank
    sliced over the mesh per ``model.param_pspecs()``, everything else
    whole (fresh tensors; JAX's convenience over ``shard_params``)."""
    return shard_params(params, mesh, model.param_pspecs(), rank)


__all__ = ["make_moe_shardmap_train_step", "place_moe_params"]
