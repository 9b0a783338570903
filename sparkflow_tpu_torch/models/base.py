"""Shared plumbing for registry models.

The port of the JAX package's ``models/base.py``. A registry model keeps
the JAX surface — ``param_specs()`` (ordered, for the flat weight-list wire
format), ``init``, ``apply(params, feeds, outputs, train, generator)``,
``loss_vector`` and functional methods that take a ``params`` tree as their
first argument, so the serving engine can hot-swap weights and the trainer
can differentiate with respect to the tree — and is an ``nn.Module`` whose
registered parameters are the tree ``init``/``load_params`` last installed,
under the JAX names (``block_0.qkv_kernel``, ``embed.tok``, ...).

Randomness (dropout) comes from an explicit ``torch.Generator`` on the
model's device where the JAX package threads a ``jax.random`` key; the two
streams differ, so parity tests train with dropout 0.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import as_dtype, resolve_device
from ..graphdef import initialize

Params = Dict[str, Dict[str, torch.Tensor]]


class RegistryModel(nn.Module):
    """Base for registry models. Subclasses define ``TENSORS``,
    ``param_specs()`` (ordered ``{layer: {name: (shape, init)}}``) and
    ``_forward(params, feeds) -> dict of named tensors``."""

    TENSORS: Sequence[str] = ()

    # model families whose forwards consume int8-quantized trees set this
    # True (the transformer family); serving refuses quantized trees
    # otherwise instead of silently computing float32
    SUPPORTS_INT8_SERVING = False

    def __init__(self, compute_dtype: Optional[Any] = None, device=None):
        super().__init__()
        self.compute_dtype = as_dtype(compute_dtype)
        self.device = resolve_device(device)
        # 'weight_only' | 'dynamic' when serving a tree from
        # utils.quant.quantize_params (the mode picks the matmul path)
        self.quant_mode: Optional[str] = None
        self._tree: Optional[Params] = None

    # -- parameters ----------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0) -> Params:
        """Draw float32 parameters following ``param_specs()`` — any
        initializer of :func:`~sparkflow_tpu_torch.graphdef.initialize`
        (``normal(std)``, ``ones``, ``zeros``, ``he_normal``, ...) — from
        ``generator`` (a CPU ``torch.Generator``; default one seeded with
        ``seed``), install them on this module and return the tree. The
        draws are made on the CPU so a seed gives the same weights on every
        device."""
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        tree: Params = {}
        for lname, pspec in self.param_specs().items():
            layer = {}
            for pname, (shape, init_name) in pspec.items():
                layer[pname] = initialize(init_name, shape, generator).to(
                    self.device)
            tree[lname] = layer
        return self.load_params(tree)

    def load_params(self, tree: Params, trainable: bool = False) -> Params:
        """Install ``tree`` as this module's parameters and make it the
        default for ``params=None`` calls. Frozen for serving; with
        ``trainable`` every leaf requires a gradient (the trainer's tree,
        which its optimizer then updates in place). The parameters share
        storage with ``tree``'s tensors."""
        for lname, layer in tree.items():
            pd = nn.ParameterDict({k: nn.Parameter(v, requires_grad=trainable)
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

    def resolve(self, tensor_name: str) -> int:
        """Index of ``tensor_name`` (``:0`` suffix optional) in ``TENSORS``;
        KeyError naming the known tensors otherwise — the JAX package's
        ``graphdef.resolve`` check for registry models."""
        name = tensor_name.split(":")[0]
        if name not in self.TENSORS:
            raise KeyError(f"tensor {tensor_name!r} not found; known tensors: "
                           f"{', '.join(sorted(self.TENSORS))}")
        return list(self.TENSORS).index(name)

    def apply(self, params: Optional[Params], feeds: Dict[str, Any],
              outputs: Sequence[str], train: bool = False,
              generator: Optional[torch.Generator] = None,
              **kw) -> Dict[str, Any]:
        """Named outputs of the forward. ``train`` turns dropout on, drawn
        from ``generator`` (a ``torch.Generator`` on the model's device)."""
        params = self.params() if params is None else params
        feeds = {k.split(":")[0]: v for k, v in feeds.items()}
        vals = self._forward(params, feeds, train=train, generator=generator,
                             **kw)
        out = {}
        for o in outputs:
            key = o.split(":")[0]
            if key not in vals:
                raise KeyError(f"tensor {o!r} not produced; have {sorted(vals)}")
            out[o] = vals[key]
        return out

    def loss_vector(self, params: Optional[Params], feeds: Dict[str, Any],
                    train: bool = True,
                    generator: Optional[torch.Generator] = None,
                    **kw) -> torch.Tensor:
        """Per-example loss [B] float32 (the subclass's ``_loss``); ``kw``
        goes to the forward (``attention=`` overrides the kernel)."""
        params = self.params() if params is None else params
        feeds = {k.split(":")[0]: v for k, v in feeds.items()}
        return self._loss(params, feeds, train=train, generator=generator,
                          **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for the model's first input tensor (``input_ids``, or a
        ResNet's ``x``)."""
        return self._forward(self.params(), {self.TENSORS[0]: x})["logits"]

    # -- helpers --------------------------------------------------------------

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x


def softmax_xent(logits: torch.Tensor, y) -> torch.Tensor:
    """Per-example softmax cross entropy [N] accepting one-hot labels
    [N, C] or class-index labels ([N] / [N, 1], what the estimator's scalar
    label column gives) — the JAX package's ``softmax_xent``."""
    y = torch.as_tensor(y, device=logits.device)
    logp = F.log_softmax(logits.float(), dim=-1)
    c = logits.shape[-1]
    if y.dim() == logits.dim() and y.shape[-1] == c:
        return -(y.float() * logp).sum(-1)
    idx = y.reshape(y.shape[0]).long()
    return -logp.gather(-1, idx[:, None])[:, 0]

