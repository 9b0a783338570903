"""Model registry + JSON dispatch.

Carried from the JAX package: the spec wire format is unchanged, so a spec
built here is byte-identical to ``build_registry_spec``'s there and either
package loads the other's. Only the families listed in ``_REGISTRY`` are
ported; the rest of the JAX zoo raises "not yet ported" (ROADMAP.md).
:func:`model_from_json` dispatches as the JAX package does: a registry
spec, then a TF1 ``MetaGraphDef`` JSON (refused: the TF1 interpreter is not
yet ported), then the ``nn`` graph DSL (:class:`~..graphdef.GraphModel`).
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


def is_tf1_metagraph(graph_json) -> bool:
    """Is this (string or parsed dict) a TF1 ``MetaGraphDef`` JSON — the
    reference's wire format? The JAX package's sniff, carried."""
    if isinstance(graph_json, str):
        try:
            graph_json = json.loads(graph_json)
        except (ValueError, TypeError):
            return False
    return (isinstance(graph_json, dict)
            and ("graphDef" in graph_json or "graph_def" in graph_json))


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
        raise NotImplementedError(
            "TF1 MetaGraphDef specs are not yet ported to PyTorch (the "
            "tf1_compat interpreter, see ROADMAP.md)")
    # default: graph-DSL spec
    from ..graphdef import GraphModel
    return GraphModel.from_json(spec, compute_dtype, device)
