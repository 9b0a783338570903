"""Model registry + JSON dispatch.

Carried from the JAX package: the spec wire format is unchanged, so a spec
built here is byte-identical to ``build_registry_spec``'s there and either
package loads the other's. Only the families listed in ``_REGISTRY`` are
ported; the rest of the JAX zoo raises "not yet ported" (ROADMAP.md).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional

REGISTRY_FORMAT = "sparkflow-tpu-model"

_REGISTRY: Dict[str, Callable] = {}

# registry families of the JAX package that this package does not have yet
_NOT_YET_PORTED = ("resnet", "resnet50", "rnn_classifier", "rnn_lm",
                   "transformer_moe_lm")


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.model_name = name
        return cls
    return deco


def _check_known(name: str) -> Callable:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"model family {name!r} is not yet ported to PyTorch; ported: "
            f"{sorted(_REGISTRY)} (see ROADMAP.md)")
    raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")


def build_registry_spec(name: str, **config) -> str:
    """JSON spec for a registry model — the same string the JAX package's
    ``build_registry_spec`` produces for the same arguments."""
    _check_known(name)
    return json.dumps({"format": REGISTRY_FORMAT, "version": 1,
                       "model": name, "config": config})


def model_from_json(spec: str, compute_dtype: Optional[Any] = None,
                    device=None):
    """Dispatch a JSON model spec to its model object. ``compute_dtype`` is
    not a spec field (``"bfloat16"`` or ``torch.bfloat16`` on the card);
    ``device`` defaults to the CUDA card (``"cpu"`` must be asked for)."""
    d = json.loads(spec)
    if d.get("format") != REGISTRY_FORMAT:
        raise NotImplementedError(
            "only registry specs (format 'sparkflow-tpu-model') are ported; "
            "graph-DSL and TF1 specs are not yet (see ROADMAP.md)")
    cls = _check_known(d["model"])
    return cls(compute_dtype=compute_dtype, device=device, **d["config"])
