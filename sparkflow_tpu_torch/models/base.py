"""Shared plumbing for registry models.

The port of the JAX package's ``models/base.py``. A registry model keeps
the JAX surface — ``param_specs()`` (ordered, for the flat weight-list wire
format), ``init``, ``apply(params, feeds, outputs)`` and functional methods
that take a ``params`` tree as their first argument, so the serving engine
can hot-swap weights — and is an ``nn.Module`` whose registered parameters
are the tree ``init``/``load_params`` last installed, under the JAX names
(``block_0.qkv_kernel``, ``embed.tok``, ...).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ..device import as_dtype, resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


class RegistryModel(nn.Module):
    """Base for registry models. Subclasses define ``TENSORS``,
    ``param_specs()`` (ordered ``{layer: {name: (shape, init)}}``) and
    ``_forward(params, feeds) -> dict of named tensors``."""

    TENSORS: Sequence[str] = ()

    def __init__(self, compute_dtype: Optional[Any] = None, device=None):
        super().__init__()
        self.compute_dtype = as_dtype(compute_dtype)
        self.device = resolve_device(device)
        self._tree: Optional[Params] = None

    # -- parameters ----------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0) -> Params:
        """Draw float32 parameters following ``param_specs()`` —
        ``normal(std)``, ``ones``, ``zeros`` — from ``generator`` (a CPU
        ``torch.Generator``; default one seeded with ``seed``), install them
        on this module and return the tree. The draws are made on the CPU so
        a seed gives the same weights on every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        tree: Params = {}
        for lname, pspec in self.param_specs().items():
            layer = {}
            for pname, (shape, init_name) in pspec.items():
                layer[pname] = _initialize(init_name, shape, generator).to(
                    self.device)
            tree[lname] = layer
        return self.load_params(tree)

    def load_params(self, tree: Params) -> Params:
        """Install ``tree`` as this module's parameters (frozen: this package
        only serves) and make it the default for ``params=None`` calls."""
        for lname, layer in tree.items():
            pd = nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                   for k, v in layer.items()})
            setattr(self, lname, pd)
        self._tree = {ln: {k: getattr(self, ln)[k] for k in layer}
                      for ln, layer in tree.items()}
        return self._tree

    def params(self) -> Params:
        if self._tree is None:
            raise RuntimeError("model has no parameters yet: call init() or "
                               "load_params()")
        return self._tree

    # -- GraphModel-compatible surface ---------------------------------------

    def apply(self, params: Optional[Params], feeds: Dict[str, Any],
              outputs: Sequence[str], **kw) -> Dict[str, Any]:
        params = self.params() if params is None else params
        feeds = {k.split(":")[0]: v for k, v in feeds.items()}
        vals = self._forward(params, feeds, **kw)
        out = {}
        for o in outputs:
            key = o.split(":")[0]
            if key not in vals:
                raise KeyError(f"tensor {o!r} not produced; have {sorted(vals)}")
            out[o] = vals[key]
        return out

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self._forward(self.params(), {"input_ids": input_ids})["logits"]

    # -- helpers --------------------------------------------------------------

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x


def _initialize(name: str, shape, generator: torch.Generator) -> torch.Tensor:
    if name == "zeros":
        return torch.zeros(shape, dtype=torch.float32)
    if name == "ones":
        return torch.ones(shape, dtype=torch.float32)
    if name.startswith("normal"):
        std = 0.05
        if "(" in name:
            std = float(name[name.index("(") + 1:name.index(")")])
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32) * std
    raise ValueError(f"initializer {name!r} is not yet ported")
