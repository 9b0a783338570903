"""Weight serialization, the per-partition inference kernel, and data
marshalling — the port of the JAX package's ``ml_util.py``.

- weights travel as a JSON list of nested lists in ``param_specs()`` order,
  the JAX package's wire format unchanged, or as an ``npz:<path>`` side
  file (keys ``w_0 .. w_{n-1}``) — so either package reads the other's
  fitted ``modelWeights``;
- :func:`predict_func` rebuilds the model from its spec JSON on the stage's
  device (the CUDA card unless ``device="cpu"``), runs the named output
  tensor in fixed-size chunks and appends the prediction column (a float
  for scalar outputs, ``Vectors.dense`` otherwise). ``quantize`` serves
  int8 weights (``"weight_only"`` / ``"dynamic"``, ``utils/quant.py``),
  quantized once per weights identity and cached.

``mesh_axes`` (``{"dp": N}``, the model stage's ``meshShape``) serves each
partition data-parallel in this process, by the serving rule of
:mod:`~sparkflow_tpu_torch.parallel.mesh`: one weight copy per dp shard,
each batch split into dp row blocks. Other axes are refused with the JAX
package's message.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .compat import Row, Vectors
from .convert import list_to_params, params_to_list
from .core import make_predict_fn, predict_in_chunks
from .device import resolve_device
from .localml.linalg import vector_to_array


def get_weights(model, params) -> List[np.ndarray]:
    """Params tree -> flat weight list (``tensorflow_get_weights`` analog)."""
    return params_to_list(model, params)


def set_weights(model, weights: List[np.ndarray]):
    """Flat weight list -> params tree on the model's device."""
    return list_to_params(model, weights)


def convert_weights_to_json(weights: List[np.ndarray]) -> str:
    return json.dumps([np.asarray(w).tolist() for w in weights])


def convert_json_to_weights(json_weights: str) -> List[np.ndarray]:
    return [np.asarray(x, dtype=np.float32) for x in json.loads(json_weights)]


def save_weights_npz(path: str, weights: List[np.ndarray]) -> None:
    """Save a flat weight list as ``.npz`` (keys ``w_0..w_{n-1}`` keep
    order) — the JAX package's ``model_loader.save_weights_npz`` format."""
    np.savez(path, **{f"w_{i}": w for i, w in enumerate(weights)})


def resolve_weights(weights_str: str) -> List[np.ndarray]:
    """Decode a model's weight Param: inline JSON (the reference's wire
    format) or a side-file reference ``npz:<path>``."""
    if weights_str.startswith("npz:"):
        path = weights_str[4:]
        with np.load(path) as z:
            return [z[k] for k in sorted(z.files, key=lambda s: int(s.split("_")[-1]))]
    return convert_json_to_weights(weights_str)


def params_to_json(model, params) -> str:
    return convert_weights_to_json(params_to_list(model, params))


def json_to_params(model, json_weights: str):
    return list_to_params(model, convert_json_to_weights(json_weights))


def check_serving_mesh(mesh_axes: Dict[str, int]) -> None:
    """A serving mesh shards the batch only: refuse any axis but ``dp``
    (the JAX package's check and message)."""
    bad = [a for a in mesh_axes if a != "dp"]
    if bad:
        # inference shards the BATCH; params serve replicated, so a
        # tp/fsdp/... axis would silently replicate compute instead of
        # parallelizing it — refuse rather than mislead
        raise ValueError(
            "Model meshShape serves data-parallel only ('dp=N'); "
            "axes %s are not inference strategies" % bad)


# ---------------------------------------------------------------------------
# Inference kernel
# ---------------------------------------------------------------------------

# Keyed on the sha256 of the full graph JSON and the device, LRU-bounded so
# long-lived processes serving many models don't keep every model.
_PREDICT_CACHE: "OrderedDict[Tuple, Any]" = OrderedDict()
_PREDICT_CACHE_MAX = 32


def _cached_predict_fn(graph_json: str, tf_output: str, tf_input,
                       tf_dropout: Optional[str], dropout_value: float,
                       quantize: Optional[str] = None, device=None,
                       mesh_axes: Optional[Dict[str, int]] = None):
    """Cache (model, predict_fn) across partitions: the model is rebuilt
    from its spec once per (spec, output, inputs, dropout feed, quantize
    mode, device, mesh). ``quantize`` keys separately: the model's
    ``quant_mode`` picks its matmul path; so does ``mesh_axes`` (a
    dp-sharded predict with its weight copies)."""
    dev = resolve_device(device)
    digest = hashlib.sha256(graph_json.encode()).hexdigest()
    in_key = (tuple(tf_input) if isinstance(tf_input, (list, tuple))
              else tf_input)
    mesh_key = tuple(sorted(mesh_axes.items())) if mesh_axes else None
    key = (digest, tf_output, in_key, tf_dropout, dropout_value, quantize,
           str(dev), mesh_key)
    if key not in _PREDICT_CACHE:
        from .models import model_from_json
        model = model_from_json(graph_json, device=dev)
        if quantize:
            model.quant_mode = quantize
        fn = make_predict_fn(model, tf_input, tf_output, tf_dropout,
                             dropout_value,
                             mesh=dict(mesh_axes) if mesh_axes else None)
        _PREDICT_CACHE[key] = (model, fn)
        while len(_PREDICT_CACHE) > _PREDICT_CACHE_MAX:
            _PREDICT_CACHE.popitem(last=False)
    else:
        _PREDICT_CACHE.move_to_end(key)
    return _PREDICT_CACHE[key]


# quantized weight trees, keyed on the weights identity: quantizing the
# full tree per partition would undo the amortization _PREDICT_CACHE exists
# for
_QUANT_CACHE: "OrderedDict[str, Any]" = OrderedDict()
_QUANT_CACHE_MAX = 8


def _check_quantize(quantize: str) -> None:
    from .utils.quant import MODES
    if quantize not in MODES:
        # predict_func is a documented serving API of its own: a typo'd
        # mode must not silently serve a different path
        raise ValueError(f"quantize must be one of {MODES}, got {quantize!r}")


def _cached_quantized_params(model, graph_weights: str, quantize: str):
    from .graphdef import GraphModel
    from .utils.quant import quantize_params

    _check_quantize(quantize)
    supports = (isinstance(model, GraphModel)
                or getattr(model, "SUPPORTS_INT8_SERVING", False))
    if not supports:
        raise ValueError(
            f"int8 serving (inferenceQuantize) supports graphdef models (the "
            f"nn DSL / build_graph), TF1 metagraphs, and the transformer "
            f"family; got {type(model).__name__} — serve this model without "
            f"quantization")
    # the tree is mode-agnostic (quant.py) but its leaf naming is the
    # MODEL's, so the key pairs the model's param-tree naming with the
    # weights identity (and the device the tree lives on). npz side files
    # key on (path, mtime, size): the string digest would serve stale
    # weights after a refit overwrites the same path
    naming = hashlib.sha256(repr(
        [(scope, sorted(leaves)) for scope, leaves in
         model.param_specs().items()]).encode()).hexdigest()[:16]
    if graph_weights.startswith("npz:"):
        st = os.stat(graph_weights[4:])
        key = f"{naming}:{graph_weights}:{st.st_mtime_ns}:{st.st_size}"
    else:
        key = (naming + ":"
               + hashlib.sha256(graph_weights.encode()).hexdigest())
    key += f":{model.device}"
    if key not in _QUANT_CACHE:
        params = list_to_params(model, resolve_weights(graph_weights))
        _QUANT_CACHE[key] = quantize_params(params)
        while len(_QUANT_CACHE) > _QUANT_CACHE_MAX:
            _QUANT_CACHE.popitem(last=False)
    else:
        _QUANT_CACHE.move_to_end(key)
    return _QUANT_CACHE[key]


def predict_func(rows: Iterable, graph_json: str, prediction: str,
                 graph_weights: str, inp: str, activation: str, tf_input: str,
                 tf_dropout: Optional[str] = None, to_keep_dropout: bool = False,
                 chunk_size: int = 4096, extra_cols: Optional[List[str]] = None,
                 extra_inputs: Optional[List[str]] = None,
                 quantize: Optional[str] = None,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 device=None) -> List:
    """Per-partition inference (the JAX package's signature and meaning;
    ``activation`` is the output tensor name). ``extra_cols`` /
    ``extra_inputs`` feed more columns to more tensors (e.g. an attention
    mask). ``quantize`` serves int8 weights ('weight_only' or 'dynamic',
    ``utils/quant.py``). ``device`` is the card unless ``"cpu"`` is asked
    for; ``mesh_axes`` (``{"dp": N}``) splits each chunk over N weight
    copies in this process."""
    if quantize:
        _check_quantize(quantize)
    if mesh_axes:
        check_serving_mesh(mesh_axes)
    if bool(extra_cols) != bool(extra_inputs) or (
            extra_cols and len(extra_cols) != len(extra_inputs)):
        raise ValueError("extra_cols and extra_inputs must pair up one-to-one")
    row_dicts = [r.asDict() for r in rows]
    if not row_dicts:
        return []
    dropout_v = 1.0 if (tf_dropout is not None and to_keep_dropout) else 0.0
    names = [tf_input] + list(extra_inputs) if extra_cols else tf_input
    model, fn = _cached_predict_fn(graph_json, activation, names,
                                   tf_dropout, dropout_v, quantize, device,
                                   mesh_axes)
    if quantize:
        params = _cached_quantized_params(model, graph_weights, quantize)
    else:
        params = list_to_params(model, resolve_weights(graph_weights))
    cols = [inp] + list(extra_cols) if extra_cols else [inp]
    stacked = tuple(
        np.stack([vector_to_array(rd[c]) for rd in row_dicts]).astype(np.float32)
        for c in cols)
    x = stacked if extra_cols else stacked[0]
    preds = predict_in_chunks(fn, params, x, chunk_size)
    for rd, p in zip(row_dicts, preds):
        arr = np.asarray(p)
        if arr.ndim == 0 or arr.size == 1:
            rd[prediction] = float(arr.reshape(()))
        else:
            rd[prediction] = Vectors.dense(arr)
    return [Row(**rd) for rd in row_dicts]


# ---------------------------------------------------------------------------
# Data marshalling (reference ml_util.py:86-134)
# ---------------------------------------------------------------------------


def handle_features(data: Iterable, is_supervised: bool = False
                    ) -> Tuple[Any, Optional[np.ndarray]]:
    """Materialize an iterator of (features, label) / features into arrays.
    Scalar labels wrap to ``[y]``. A row's features may be a TUPLE of
    vectors (multi-input models); the return is then a matching tuple of
    arrays."""
    def to_arr(x):
        return x if isinstance(x, np.ndarray) else vector_to_array(x)

    features, labels = [], []
    multi = False
    for item in data:
        if is_supervised:
            x, y = item
            if isinstance(y, (int, float)):
                labels.append([y])
            else:
                labels.append(vector_to_array(y))
        else:
            x = item
        if isinstance(x, tuple):
            multi = True
            features.append([to_arr(c) for c in x])
        else:
            features.append(to_arr(x))
    if multi:
        f = tuple(np.asarray([row[i] for row in features], dtype=np.float32)
                  for i in range(len(features[0])))
    else:
        f = np.asarray(features, dtype=np.float32)
    l = np.asarray(labels, dtype=np.float32) if is_supervised else None
    return f, l


def handle_shuffle(features: np.ndarray, labels: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    idx = np.random.permutation(features.shape[0])
    return features[idx], labels[idx] if labels is not None else None
