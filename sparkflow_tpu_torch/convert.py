"""Carry weights between the JAX package and this port.

The counterpart of the JAX package's ``graphdef.params_to_list`` /
``list_to_params``. Parameters keep the JAX names and layouts
(``qkv_kernel [hidden, 3*hidden]`` and so on), so the carry is a copy with
no transposes. Arrays cross as numpy: this module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

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
