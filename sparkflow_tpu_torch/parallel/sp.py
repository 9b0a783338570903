"""Sequence parallelism: training with ring attention over ``sp`` — the
port of the JAX package's ``parallel/sp.py``.

Activations shard along the sequence across the mesh's ``sp`` axis, every
block's attention runs
:func:`~sparkflow_tpu_torch.ops.ring_flash_attention` (K/V rotating around
the axis, kernels 1-3 per visit on the card), and the loss and gradients
merge with token-weighted all-reduces. Attention is exact (the ring visits
every K/V block); the next-token loss excludes the ``n_shards - 1``
shard-boundary targets per example (each shard predicts only its own
tokens 1..S_local-1), so loss and gradients differ from unsharded training
by that small, fixed exclusion — the JAX package's documented rule, kept so
the two packages agree.

Works for the causal LM family (``transformer_lm``); the batch can shard
over ``dp`` at the same time (mesh ``{"dp": a, "sp": b}``).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from ..optimizers import apply_updates, tree_leaves, tree_map
from . import collectives as C
from .dp import fold_in


def make_sp_train_step(model, optimizer, mesh, dp_axis: Optional[str] = "dp",
                       sp_axis: str = "sp",
                       attention: Optional[Callable] = None):
    """The per-rank sequence-parallel LM train step: ``step(params,
    opt_state, ids, mask, rng) -> (params, opt_state, loss)`` with ``ids`` /
    ``mask`` this rank's [B_local, S_local] block (rows of its dp index,
    positions of its sp index) and params / opt_state replicated (updated
    in place). ``rng`` is an integer seed folded with the rank's indices
    (dp, then sp, as JAX's ``fold_in``), or a ``torch.Generator``.

    The loss is the global token-weighted NLL: each rank computes (sum_nll,
    token_count) over its local tokens and both all-reduce over the mesh.
    ``attention`` overrides the ring (``functools.partial(ring_attention,
    axis_name="sp")`` runs the plain one). Runs inside ``with
    mesh.bind():``."""
    # private copy: setting sp_axis on the caller's model would break its
    # later use outside a mesh (ring attention needs a bound axis)
    model = copy.copy(model)
    model.sp_axis = sp_axis
    axes = tuple(a for a in (dp_axis, sp_axis) if a and a in mesh.axis_names)
    extra = {} if attention is None else {"attention": attention}

    def step(params, opt_state, ids, mask, rng):
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            # decorrelate dropout across shards
            seed = fold_in(int(rng), C.axis_index(axes[0]) if axes else 0)
            if sp_axis in mesh.axis_names:
                seed = fold_in(seed, C.axis_index(sp_axis))
            gen = torch.Generator(device=model.device).manual_seed(seed)
        feeds = {"input_ids": ids, "attention_mask": mask}
        lv = model.loss_vector(params, feeds, train=True, generator=gen,
                               **extra)                       # [B_local]
        if mask is not None:
            w = torch.as_tensor(mask, device=lv.device)[:, 1:].float().sum(-1)
        else:
            w = torch.full((ids.shape[0],), ids.shape[1] - 1,
                           dtype=torch.float32, device=lv.device)
        snll = (lv * w).sum()
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(snll, leaves)
        tot = C.psum({"nll": snll.detach(), "cnt": w.sum()}, axes)
        with torch.no_grad():
            it = iter(grads)
            gsum = C.psum(tree_map(lambda _: next(it), params), axes)
            gsum = tree_map(lambda g: g / tot["cnt"], gsum)
            loss = tot["nll"] / tot["cnt"]
            updates, opt_state = optimizer.update(gsum, opt_state, params)
            apply_updates(params, updates)
        return params, opt_state, loss

    return step


__all__ = ["make_sp_train_step"]
