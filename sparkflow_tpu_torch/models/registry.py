"""Model registry + JSON dispatch.

Carried from the JAX package: the spec wire format is unchanged, so a spec
built here is byte-identical to ``build_registry_spec``'s there and either
package loads the other's. Every registry family of the JAX zoo is ported
(``transformer_lm``, ``transformer_classifier``, ``transformer_moe_lm``,
``resnet``, ``resnet50``, ``rnn_classifier``, ``rnn_lm``).
:func:`model_from_json` dispatches as the JAX package does: a registry
spec, then a TF1 ``MetaGraphDef`` JSON (the reference's wire format, run by
:class:`~..tf1_compat.TF1GraphModel`), then the ``nn`` graph DSL
(:class:`~..graphdef.GraphModel`).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional

from ..tf1_compat import TF1GraphModel, is_tf1_metagraph  # noqa: F401

REGISTRY_FORMAT = "sparkflow-tpu-model"

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.model_name = name
        return cls
    return deco


def _check_known(name: str) -> Callable:
    if name in _REGISTRY:
        return _REGISTRY[name]
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
    if d.get("format") == REGISTRY_FORMAT:
        cls = _check_known(d["model"])
        return cls(compute_dtype=compute_dtype, device=device, **d["config"])
    if is_tf1_metagraph(d):
        return TF1GraphModel(d, compute_dtype, device)
    # default: graph-DSL spec
    from ..graphdef import GraphModel
    return GraphModel.from_json(spec, compute_dtype, device)
