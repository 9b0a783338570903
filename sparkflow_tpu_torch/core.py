"""Train and predict steps: the compute core — the port of the JAX package's
``core.py`` for one device.

- :func:`make_loss_fn` — masked mean of the model's per-example loss;
- :func:`make_train_step` — one optimizer step: the loss's gradient with
  respect to the parameter tree (``torch.autograd.grad``), the optimizer
  update, and the update added to the parameters in place;
- :func:`make_epoch_fn` — one epoch of steps in the reference's three
  batching modes (``sweep``, ``stochastic``, ``full``);
- :func:`make_predict_fn` / :func:`predict_in_chunks` — fixed-size chunked
  inference, dp-sharded (and tp-split) over a mesh in one process with
  ``mesh=``.

Batches keep a fixed size: the dataset is padded to whole batches and a
0/1 row mask weights the loss, so padded rows add zero loss and zero
gradient, as in the JAX package. PyTorch runs eagerly, so there is no
compiled epoch program and no fused multi-epoch path here: an epoch is a
Python loop of steps (a mesh rank's step comes from :mod:`.parallel`).
Shuffles and batch draws come from a CPU ``torch.Generator`` (the same
indices on any device), dropout from a generator on the model's device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .optimizers import GradientTransformation, apply_updates, tree_leaves


def _masked_mean(loss_vec: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (loss_vec * mask).sum() / mask.sum().clamp_min(1.0)


def _rows(x) -> int:
    """Row count of a features value (one tensor or a tuple of tensors)."""
    return (x[0] if isinstance(x, (tuple, list)) else x).shape[0]


def make_feeds_builder(input_name, label_name: Optional[str]) -> Callable:
    """``(x, y) -> feeds dict``: strips ``:0`` suffixes, zips multi-input
    tuples, omits the label when unsupervised."""
    multi = isinstance(input_name, (list, tuple))
    in_keys = ([n.split(":")[0] for n in input_name] if multi
               else [input_name.split(":")[0]])
    lbl_key = label_name.split(":")[0] if label_name else None

    def build_feeds(x, y):
        feeds = dict(zip(in_keys, tuple(x) if multi else (x,)))
        if lbl_key is not None:
            feeds[lbl_key] = y
        return feeds

    return build_feeds


def make_loss_fn(model, input_name, label_name: Optional[str]) -> Callable:
    """``loss_fn(params, x, y, mask, generator) -> scalar``: the masked mean
    of ``model.loss_vector`` in training mode. ``label_name=None`` is the
    unsupervised path (the LM's labels are its own shifted inputs)."""
    build_feeds = make_feeds_builder(input_name, label_name)

    def loss_fn(params, x, y, mask, generator=None):
        lv = model.loss_vector(params, build_feeds(x, y), train=True,
                               generator=generator)
        return _masked_mean(lv, mask)

    return loss_fn


def make_train_step(loss_fn: Callable,
                    optimizer: GradientTransformation) -> Callable:
    """``step(params, opt_state, x, y, mask, generator) -> (params,
    opt_state, loss)``. The parameter leaves must require a gradient; they
    are updated in place (the returned tree is the same tensors), the
    returned loss is a detached device scalar (no host sync)."""

    def step(params, opt_state, x, y, mask, generator=None):
        leaves = tree_leaves(params)
        loss = loss_fn(params, x, y, mask, generator)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grad_tree = _unflatten(params, it)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grad_tree, opt_state, params)
            apply_updates(params, updates)
        return params, opt_state, loss.detach()

    return step


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(v, it) for k, v in like.items()}
    return next(it)


def _take(data, idx):
    if isinstance(data, (tuple, list)):
        return tuple(a.index_select(0, idx) for a in data)
    return data.index_select(0, idx)


def _epoch_indices(mode: str, shuffle: bool, n_rows: int, batch_size: int,
                   num_batches: int, n_real: int,
                   generator: torch.Generator) -> Optional[torch.Tensor]:
    """Row order of one epoch, ``num_batches * batch_size`` long (None: the
    rows in order). ``stochastic``: each batch drawn without replacement
    from the ``n_real`` real rows (padding fills a batch only when it
    exceeds the dataset); ``shuffle``: one permutation of all rows."""
    if mode == "stochastic":
        parts = []
        for _ in range(num_batches):
            perm = torch.randperm(n_real, generator=generator)
            if batch_size <= n_real:
                parts.append(perm[:batch_size])
            else:
                parts.append(torch.cat([perm, torch.arange(n_real,
                                                           batch_size)]))
        return torch.cat(parts)
    if shuffle:
        return torch.randperm(n_rows, generator=generator)
    return None


def make_epoch_fn(loss_fn: Callable, optimizer: GradientTransformation,
                  batch_size: int, num_batches: int, mode: str,
                  shuffle: bool, n_real: Optional[int] = None,
                  step_fn: Optional[Callable] = None,
                  rows: Optional[Tuple[int, int]] = None) -> Callable:
    """One epoch: ``epoch(params, opt_state, data, labels, mask,
    shuffle_gen, dropout_gen) -> (params, opt_state, losses [num_batches])``.

    ``mode``: ``sweep`` (sequential slices), ``stochastic`` (``num_batches``
    batches, each sampled without replacement), ``full`` (one batch of the
    whole padded set). ``data`` is one tensor (or a tuple for multi-input
    models) of ``[num_batches * batch_size, ...]`` padded rows on the
    model's device; ``shuffle_gen`` is a CPU generator.

    On a mesh ``step_fn`` replaces the one-device step (same signature; it
    receives ``dropout_gen`` as it is) and ``rows = (index, count)`` feeds it
    only block ``index`` of ``count`` equal blocks of every batch — this
    rank's rows; the epoch's row order is the same on every rank."""
    step = step_fn or make_train_step(loss_fn, optimizer)
    r_idx, r_cnt = rows or (0, 1)
    local = batch_size // r_cnt

    def epoch(params, opt_state, data, labels, mask, shuffle_gen,
              dropout_gen=None):
        nr = n_real if n_real is not None else _rows(data)
        idx = _epoch_indices(mode, shuffle, _rows(data), batch_size,
                             num_batches, nr, shuffle_gen)
        if idx is not None:
            idx = idx.to(mask.device)
            data, labels, mask = (_take(data, idx), labels.index_select(0, idx),
                                  mask.index_select(0, idx))
        losses = []
        for i in range(num_batches):
            lo = i * batch_size + r_idx * local
            sl = slice(lo, lo + local)
            x = (tuple(a[sl] for a in data)
                 if isinstance(data, (tuple, list)) else data[sl])
            params, opt_state, loss = step(params, opt_state, x, labels[sl],
                                           mask[sl], dropout_gen)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return epoch


def pad_to_batches(x: np.ndarray, batch_size: int,
                   num_batches: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows so len == num_batches*batch_size; return (padded, mask)."""
    n = x.shape[0]
    if num_batches is None:
        num_batches = max(1, -(-n // batch_size))
    total = num_batches * batch_size
    mask = np.zeros((total,), np.float32)
    mask[:n] = 1.0
    if total == n:
        return x, mask
    pad = np.zeros((total - n,) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0), mask


def make_predict_fn(model, input_name, output_name: str,
                    dropout_name: Optional[str] = None,
                    dropout_value: float = 1.0, mesh=None,
                    sharding=None) -> Callable:
    """``predict(params, x) -> out`` (a tensor on the model's device), in
    inference mode; ``input_name`` may be a sequence of names, ``x`` then a
    tuple. ``dropout_name`` feeds the graph-DSL keep-probability
    placeholder, as in the JAX package.

    With ``mesh`` (a :class:`~.parallel.mesh.Mesh` or a dict of sizes) the
    batch shards over the config's batch axes in this process, by the
    serving rule of :mod:`.parallel.mesh`: one parameter copy per dp shard
    (made once for each params tree a call gets, and kept while that tree
    is unchanged), any batch size padded up to a dp multiple, split into
    contiguous row blocks, each block's output concatenated and trimmed.
    On a ``tp`` axis a model with megatron rules (``param_pspecs``) splits
    each copy into tp shards and sums each block half's partials; on an
    ``ep`` axis an MoE model splits each bank into ep shards and sums their
    outputs; a model without rules holds whole copies, as JAX's replicated
    program does. An ``fsdp`` or ``sp`` axis holds whole copies. An MoE
    model keeps its batch on one copy: its routing couples the rows, and
    JAX's program routes the whole batch."""
    multi = isinstance(input_name, (list, tuple))
    in_keys = ([n.split(":")[0] for n in input_name] if multi
               else [input_name.split(":")[0]])
    drop_key = dropout_name.split(":")[0] if dropout_name else None

    def apply_on(m, params, xs):
        feeds = {k: torch.as_tensor(a, device=m.device)
                 for k, a in zip(in_keys, xs)}
        if drop_key is not None:
            feeds[drop_key] = torch.tensor(dropout_value,
                                           dtype=torch.float32)
        with torch.inference_mode():
            return m.apply(params, feeds, [output_name],
                           train=False)[output_name]

    def predict(params, x):
        return apply_on(model, params, tuple(x) if multi else (x,))

    if mesh is None:
        return predict
    from .parallel import mesh as pmesh
    dp, tp_axis, tp, ep_axis, ep = pmesh.serving_layout(mesh, sharding)
    pspecs = None
    if tp * ep > 1:
        from .parallel.tp import serving_pspecs
        pspecs = serving_pspecs(model, pmesh.as_mesh(mesh),
                                tp_axis if tp > 1 else None,
                                ep_axis if ep > 1 else None)
    if pspecs is None:
        tp = ep = 1     # no megatron rules: each copy holds the whole tree
    if getattr(model, "num_experts", None):
        dp = 1          # an MoE layer routes the whole batch, as in JAX
    if dp <= 1 and tp * ep <= 1:
        return predict
    grid = pmesh.serving_grid(dp, tp, model.device, ep=ep)
    experts = pmesh.expert_grid(dp, tp, ep, model.device)
    models = [pmesh.model_on(model, g[0]) for g in grid]
    held: dict = {"key": None}

    def place(params):
        if tp * ep <= 1:
            return pmesh.dp_copies(params, [g[0] for g in grid])
        from .parallel.tp import serving_tree
        return [serving_tree(model, params, pspecs,
                             tp_axis if tp > 1 else None, g,
                             ep_axis if ep > 1 else None, x)
                for g, x in zip(grid, experts)]

    def copies(params):
        # the per-shard copies of the tree this call got, made again only
        # when another tree comes or one of its tensors changed in place
        key = (id(params), tuple((id(t), getattr(t, "_version", 0))
                                 for t in tree_leaves(params)))
        if held["key"] != key:
            held.update(key=key, src=params, copies=place(params))
        return held["copies"]

    def padded_predict(params, x):
        xs = tuple(torch.as_tensor(a) for a in (tuple(x) if multi else (x,)))
        n = xs[0].shape[0]
        pad = (-n) % dp if n else dp
        if pad:
            xs = tuple(torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                       for a in xs)
        return pmesh.dp_apply(
            lambda r, p, block: apply_on(models[r], p, block),
            copies(params), xs)[:n]

    return padded_predict


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def predict_in_chunks(predict_fn: Callable, params, x,
                      chunk_size: int = 4096) -> np.ndarray:
    """Run fixed-size chunks over arbitrary-length input (pad and trim the
    tail); ``x`` is one array or a tuple of arrays. Returns numpy."""
    multi = isinstance(x, (list, tuple))
    if multi:
        xs = tuple(np.asarray(a) for a in x)
        n = xs[0].shape[0]
        zeros = lambda m: tuple(np.zeros((m,) + a.shape[1:], a.dtype)  # noqa: E731
                                for a in xs)
        sl = lambda i, j: tuple(a[i:j] for a in xs)  # noqa: E731
        cat = lambda parts, pad: tuple(  # noqa: E731
            np.concatenate([p, z], axis=0) for p, z in zip(parts, pad))
    else:
        xs = np.asarray(x)
        n = xs.shape[0]
        zeros = lambda m: np.zeros((m,) + xs.shape[1:], xs.dtype)  # noqa: E731
        sl = lambda i, j: xs[i:j]  # noqa: E731
        cat = lambda part, pad: np.concatenate([part, pad], axis=0)  # noqa: E731
    if n == 0:
        return _to_numpy(predict_fn(params, zeros(1)))[:0]
    chunk = min(chunk_size, max(1, 1 << (n - 1).bit_length()))
    outs: List[np.ndarray] = []
    i = 0
    while i < n:
        part = sl(i, i + chunk)
        have = (part[0] if multi else part).shape[0]
        if have < chunk:
            out = _to_numpy(predict_fn(params, cat(part, zeros(chunk - have))))
            out = out[:have]
        else:
            out = _to_numpy(predict_fn(params, part))
        outs.append(out)
        i += chunk
    return np.concatenate(outs, axis=0)


__all__: Sequence[str] = (
    "make_feeds_builder", "make_loss_fn", "make_train_step", "make_epoch_fn",
    "pad_to_batches", "make_predict_fn", "predict_in_chunks")
