"""Carry weights between the JAX package and this port.

The counterpart of the JAX package's ``graphdef.params_to_list`` /
``list_to_params``. Parameters keep the JAX names and layouts
(``qkv_kernel [hidden, 3*hidden]`` and so on), so the carry is a copy with
no transposes. Arrays cross as numpy: this module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


def params_from_jax(model, params: Union[Dict[str, Dict[str, Any]],
                                         Sequence[Any]],
                    *, device=None, dtype: Optional[torch.dtype] = None
                    ) -> Params:
    """JAX params — a nested ``{layer: {name: array}}`` dict of numpy (or
    numpy-convertible) arrays, or the flat list in ``model.param_specs()``
    order — as this port's tree of tensors on ``device`` (default: the
    model's device) in ``dtype`` (default: the arrays' own float type).
    Shapes are checked against ``param_specs()``."""
    specs = model.param_specs()
    if isinstance(params, (list, tuple)):
        needed = sum(len(p) for p in specs.values())
        if len(params) != needed:
            raise ValueError(f"weight list has {len(params)} arrays; model "
                             f"needs {needed}")
        it = iter(params)
        params = {ln: {pn: next(it) for pn in ps} for ln, ps in specs.items()}
    dev = model.device if device is None else resolve_device(device)
    out: Params = {}
    for lname, pspec in specs.items():
        layer = {}
        for pname, (shape, _init) in pspec.items():
            a = np.asarray(params[lname][pname])
            if tuple(a.shape) != tuple(shape):
                raise ValueError(f"{lname}/{pname} has shape {a.shape}, "
                                 f"expected {tuple(shape)}")
            t = torch.from_numpy(np.array(a, copy=True))
            layer[pname] = t.to(device=dev, dtype=dtype or t.dtype)
        out[lname] = layer
    return out


def params_to_list(model, params: Params) -> List[np.ndarray]:
    """Flatten a port tree to float32 numpy arrays in ``param_specs()``
    order — the JAX package's flat weight-list wire format."""
    return [params[ln][pn].detach().to("cpu", torch.float32).numpy()
            for ln, ps in model.param_specs().items() for pn in ps]


def list_to_params(model, weights: Sequence[Any], *, device=None,
                   dtype: Optional[torch.dtype] = None) -> Params:
    """Inverse of :func:`params_to_list` (same as :func:`params_from_jax`
    on a list)."""
    return params_from_jax(model, list(weights), device=device, dtype=dtype)


def params_tree(model, params, device) -> Params:
    """Any accepted params form — the port's tree of tensors, a tree of
    numpy arrays (JAX params), or the flat weight list — as the port's tree
    on ``device``, shapes checked against ``model.param_specs()``; ``None``
    is the model's own parameters."""
    if params is None:
        return model.params()
    if isinstance(params, (list, tuple)) or any(
            not isinstance(t, torch.Tensor)
            for layer in params.values() for t in layer.values()):
        return params_from_jax(model, params, device=device)
    specs = model.param_specs()
    if set(specs) != set(params):
        raise ValueError("params tree does not match the model's "
                         "param_specs() layers")
    out = {}
    for ln, ps in specs.items():
        if set(ps) != set(params[ln]):
            raise ValueError(f"params[{ln!r}] does not match the model's "
                             f"param_specs()")
        layer = {}
        for pn, (shape, _init) in ps.items():
            t = params[ln][pn]
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{ln}/{pn} has shape {tuple(t.shape)}, "
                                 f"expected {tuple(shape)}")
            layer[pn] = t.to(device)
        out[ln] = layer
    return out


def shape_template(tree: Params) -> Params:
    """The shape/dtype template of a tree: the same structure with
    ``meta``-device tensors (no storage) for leaves — the port's
    ``jax.ShapeDtypeStruct`` tree, what an engine's hot swap checks a new
    tree against and a ``WeightStore`` load pins shapes to."""
    return {ln: {pn: torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for pn, t in layer.items()} for ln, layer in tree.items()}


def check_template(tree: Params, template: Params) -> None:
    """Raise ``ValueError`` unless ``tree`` matches ``template`` leaf for
    leaf in shape and dtype (a hot swap keeps every shape)."""
    for ln, layer in template.items():
        for pn, want in layer.items():
            t = tree[ln][pn]
            if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
                raise ValueError(
                    f"swapped params {ln}/{pn} is {tuple(t.shape)}/{t.dtype}"
                    f", expected {tuple(want.shape)}/{want.dtype}: hot swap "
                    f"requires unchanged shapes")


def sorted_leaves(tree) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``(path, leaf)`` pairs of a nested tree in ``jax.tree.leaves`` order:
    dict keys sorted (so ``block_10`` comes before ``block_2``), lists and
    tuples in order, ``None`` an empty subtree; anything else is a leaf.
    This is the leaf order of the JAX package's on-disk trees (the
    ``WeightStore``'s ``l_{i}``, an npz checkpoint's ``state.npz``), which
    neither ``param_specs()`` order nor insertion order follows."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def unflatten_sorted(like, leaves: Sequence[Any]):
    """Inverse of :func:`sorted_leaves`: ``leaves`` placed into the structure
    of ``like`` (dicts keep ``like``'s keys, lists, tuples and named tuples
    their type). Raises ``ValueError`` when the count of ``leaves`` is not
    the template's."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else type(node)(vals))
        try:
            return next(it)
        except StopIteration:
            raise ValueError(f"{len(leaves)} leaves for a template that "
                             f"holds more") from None

    out = build(like)
    if next(it, it) is not it:
        raise ValueError(f"{len(leaves)} leaves for a template that holds "
                         f"fewer")
    return out
