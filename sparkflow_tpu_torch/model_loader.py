"""Pre-trained model import (reference ``sparkflow/tensorflow_model_loader.py``)
— the port of the JAX package's ``model_loader.py``.

The reference imports TF1 ``Saver`` checkpoints into a ``SparkAsyncDLModel``
(``tensorflow_model_loader.py:8-32``). Here, as in the JAX package:

- :func:`load_checkpoint_model`: an ``.npz`` flat weight list or a
  :class:`~sparkflow_tpu_torch.checkpoint.CheckpointManager` directory (the
  npz layout both packages write);
- :func:`load_tensorflow_model` / :func:`extract_tensorflow_weights`: a TF1
  Saver checkpoint, its ``.meta`` MetaGraphDef run by the
  :mod:`~sparkflow_tpu_torch.tf1_compat` interpreter. TensorFlow is needed
  only to read the checkpoint (and to parse a ``.meta``) and is imported
  only then; batch-norm moving statistics are baked into the graph JSON;
- :func:`load_torch_model` / :func:`extract_torch_weights`: a PyTorch
  ``state_dict``, Linear / conv layouts adapted by shape.

Each returns a fitted stage whose weights the graph's ``param_specs()``
accepted (checked on the CPU). ``device`` is the stage's: the CUDA card
unless ``"cpu"`` is asked for, refused at once when there is no card.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional

import numpy as np

from .convert import list_to_params
from .device import resolve_device
from .ml_util import (convert_weights_to_json, resolve_weights,  # noqa: F401
                      save_weights_npz)
from .spark_async import SparkAsyncDLModel


def _cpu_model(graph_json: str):
    """The graph's model on the CPU: the loaders only read its
    ``param_specs()`` and check shapes, which needs no card."""
    from .models import model_from_json
    return model_from_json(graph_json, device="cpu")


def load_checkpoint_model(checkpoint_path: str,
                          graph_json: str,
                          inputCol: str,
                          tfInput: str,
                          tfOutput: str,
                          predictionCol: str = "predicted",
                          tfDropout: Optional[str] = None,
                          toKeepDropout: bool = False,
                          device=None) -> SparkAsyncDLModel:
    """Load saved weights (an npz weight list or a checkpoint directory) +
    a graph spec into a fitted ``SparkAsyncDLModel`` — the native
    counterpart of the reference's ``load_tensorflow_model``
    (``tensorflow_model_loader.py:8-32``)."""
    resolve_device(device)
    model = _cpu_model(graph_json)
    if os.path.isdir(checkpoint_path):
        from .checkpoint import CheckpointManager
        weights = CheckpointManager.load_weights(checkpoint_path, model)
    else:
        weights = resolve_weights("npz:" + checkpoint_path)
    list_to_params(model, weights)  # count and shapes, before wrapping
    return SparkAsyncDLModel(
        inputCol=inputCol,
        modelJson=graph_json,
        modelWeights=convert_weights_to_json(weights),
        tfInput=tfInput,
        tfOutput=tfOutput,
        tfDropout=tfDropout,
        toKeepDropout=toKeepDropout,
        predictionCol=predictionCol,
        device=device)


# optimizer slot variables a TF1 Saver checkpoint carries alongside the
# trainables; the reference imported tf.trainable_variables() only
# (tensorflow_model_loader.py:23-24). Matched as full path SEGMENTS so a
# legitimate layer scope like "power_head" or "global_step_embed" is kept.
_TF_SLOT_SEGMENTS = frozenset(
    ["Adam", "Adam_1", "Momentum", "RMSProp", "RMSProp_1", "Adadelta",
     "Adagrad", "Ftrl", "Ftrl_1", "beta1_power", "beta2_power",
     "global_step", "save_counter", "_CHECKPOINTABLE_OBJECT_GRAPH",
     # batch-norm moving statistics: never trainable, would otherwise enter
     # the shape-matching import and collide with gamma/beta shapes
     "moving_mean", "moving_variance"])


def _is_tf_slot_variable(name: str) -> bool:
    return any(seg in _TF_SLOT_SEGMENTS for seg in name.split("/"))


def _tf_scope_sort_key(name: str):
    """Creation order of tf.layers-style variable names: ``dense/kernel`` <
    ``dense_1/kernel`` < ``dense_2/bias``; within a scope kernel before bias
    (TF1 layer creation order)."""
    scope = name.rsplit("/", 1)[0]
    leaf = name.rsplit("/", 1)[-1]
    m = re.match(r"^(.*?)(?:_(\d+))?$", scope)
    base, idx = m.group(1), int(m.group(2) or 0)
    leaf_rank = {"kernel": 0, "weights": 0, "w": 0,
                 "bias": 1, "biases": 1, "b": 1}.get(leaf, 2)
    return (base, idx, leaf_rank, leaf)


def _read_tf_variables(checkpoint_path: str):
    """name -> array for a TF checkpoint's non-slot variables, in TF1
    layer-naming order (``dense`` < ``dense_1``, kernel before bias). TF is
    required for reading only; no graph ever executes."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "reading TF1 checkpoints needs TensorFlow installed; for native "
            "checkpoints use load_checkpoint_model (npz)") from e
    reader = tf.train.load_checkpoint(checkpoint_path)
    names = sorted((n for n in reader.get_variable_to_shape_map()
                    if not _is_tf_slot_variable(n)),
                   key=_tf_scope_sort_key)
    return {n: np.asarray(reader.get_tensor(n)) for n in names}


def extract_tensorflow_weights(checkpoint_path: str,
                               var_order: Optional[List[str]] = None
                               ) -> List[np.ndarray]:
    """Read a TF1 Saver (or TF2) checkpoint's variables into a flat weight
    list WITHOUT executing any TF graph — ``tf.train.load_checkpoint`` reads
    tensors straight off the checkpoint shards (reference behavior:
    ``sess.run(tf.trainable_variables())``, ``tensorflow_model_loader.py:
    16-24``). Optimizer slot variables are excluded.

    Order: ``var_order`` (explicit checkpoint variable names) when given,
    else TF1 layer-*naming* order (``dense`` < ``dense_1`` < ..., kernel
    before bias). NOTE: checkpoints record no creation order, so for
    auto-numbered ``tf.layers``-style names this matches
    ``tf.trainable_variables``, but hand-named scopes sort alphabetically —
    use ``var_order`` (or :func:`load_tensorflow_model`'s shape matching)
    for those.
    """
    allv = _read_tf_variables(checkpoint_path)
    if var_order is not None:
        missing = [n for n in var_order if n not in allv]
        if missing:
            raise KeyError(f"variables {missing} not in checkpoint "
                           f"{checkpoint_path} (has: {sorted(allv)})")
        return [allv[n] for n in var_order]
    return list(allv.values())


def _greedy_match(unused, flat_specs, adapt, what: str) -> List[np.ndarray]:
    """Assign named tensors to the graph's flat param slots by SHAPE
    (name order breaks ties); ``adapt(name, arr, shape)`` returns the
    layout-fixed array or None when the tensor can't fill the slot.
    Cross-layer swaps between different-shaped layers are impossible this
    way; same-shape groups keep name order and emit a warning since neither
    source records creation order."""
    if len(unused) != len(flat_specs):
        raise ValueError(
            f"{what} has {len(unused)} tensors; graph needs "
            f"{len(flat_specs)} — pass var_order= to select/pin them")
    out, ambiguous = [], set()
    for lname, pname, shape in flat_specs:
        fits = [(i, adapt(n, a, shape)) for i, (n, a) in enumerate(unused)]
        cands = [(i, arr) for i, arr in fits if arr is not None]
        if not cands:
            raise ValueError(
                f"no {what} tensor fits graph slot {lname}/{pname} "
                f"{shape}; remaining: "
                f"{[(n, a.shape) for n, a in unused]}")
        if len(cands) > 1:
            ambiguous.add(shape)
        i, arr = cands[0]
        unused.pop(i)
        out.append(arr)
    if ambiguous:
        logging.getLogger("sparkflow_tpu_torch").warning(
            "%s import: multiple tensors fit shape(s) %s; assignment within "
            "those groups follows name order, which may not be creation "
            "order — pass var_order= to pin it.", what, sorted(ambiguous))
    return out


def _match_tf_weights_to_graph(allv, model) -> List[np.ndarray]:
    flat_specs = [(lname, pname, tuple(shape))
                  for lname, pspec in model.param_specs().items()
                  for pname, (shape, _init) in pspec.items()]
    return _greedy_match(
        list(allv.items()), flat_specs,
        lambda _n, a, shape: a if a.shape == tuple(shape) else None,
        "TF checkpoint")


def load_tensorflow_model(path: str,
                          inputCol: str,
                          tfInput: str,
                          tfOutput: str,
                          predictionCol: str = "predicted",
                          tfDropout: Optional[str] = None,
                          toKeepDropout: bool = False,
                          graph_json: Optional[str] = None,
                          var_order: Optional[List[str]] = None,
                          device=None) -> SparkAsyncDLModel:
    """Import a TF1 Saver checkpoint into a fitted ``SparkAsyncDLModel``
    (reference ``load_tensorflow_model``, ``tensorflow_model_loader.py:8-32``).

    Like the reference, the checkpoint's own ``.meta`` MetaGraphDef is the
    default serving graph (``tensorflow_model_loader.py:16-17``): it is
    converted to JSON and executed by the
    :mod:`sparkflow_tpu_torch.tf1_compat` interpreter — no TF graph ever
    runs. Alternatively pass ``graph_json`` (a :mod:`sparkflow_tpu_torch.nn`
    re-expression OR a MetaGraphDef JSON string). Weights are read straight
    off the checkpoint shards; TF is required only for reading.
    """
    resolve_device(device)
    if graph_json is None:
        meta = path + ".meta"
        if os.path.exists(meta):
            try:
                import tensorflow as tf
                from google.protobuf import json_format
                mg = tf.compat.v1.MetaGraphDef()
                with open(meta, "rb") as f:
                    mg.ParseFromString(f.read())
                graph_json = json_format.MessageToJson(mg)
            except ImportError:
                pass  # fall through to the explicit error below
            except Exception as e:  # corrupted/truncated .meta
                raise ValueError(
                    f"failed to parse {meta} as a MetaGraphDef ({e}); pass "
                    f"graph_json= explicitly to bypass it") from e
    if graph_json is None:
        raise ValueError(
            "graph_json is required (no readable .meta next to the "
            "checkpoint): pass the model re-expressed with "
            "sparkflow_tpu_torch.nn or a MetaGraphDef JSON string.")
    from .tf1_compat import TF1GraphModel, bake_nontrainable_values
    model = _cpu_model(graph_json)
    if isinstance(model, TF1GraphModel):
        # restore NON-trainable state too (batch-norm moving statistics):
        # the reference imports tf.trainable_variables() only
        # (tensorflow_model_loader.py:23-24), so trained BN models serve
        # with fresh 0/1 stats there — here the checkpoint values are baked
        # into the graph JSON as Const initializers and ride the wire format
        state_names = model.nontrainable_variables()
        if state_names:
            import tensorflow as tf
            reader = tf.train.load_checkpoint(path)
            in_ckpt = reader.get_variable_to_shape_map()
            state = {n: np.asarray(reader.get_tensor(n))
                     for n in state_names if n in in_ckpt}
            if state:
                graph_json = bake_nontrainable_values(graph_json, state)
                model = _cpu_model(graph_json)
    try:
        if var_order is None and isinstance(model, TF1GraphModel):
            # metagraph knows its variables BY NAME in creation order —
            # exact assignment, no heuristics needed
            var_order = list(model._var_order)
        if var_order is not None:
            weights = extract_tensorflow_weights(path, var_order=var_order)
        else:
            # shape-driven assignment: immune to scope names that don't sort
            # in creation order (checkpoints record names, not order)
            weights = _match_tf_weights_to_graph(_read_tf_variables(path),
                                                 model)
        list_to_params(model, weights)  # count and shapes
    except (ValueError, TypeError, KeyError) as e:
        raise ValueError(
            f"checkpoint variables do not match graph_json params: {e}. "
            f"If the checkpoint uses non-standard variable naming, pass "
            f"var_order= with the checkpoint variable names in graph layer "
            f"order.") from e
    return SparkAsyncDLModel(
        inputCol=inputCol,
        modelJson=graph_json,
        modelWeights=convert_weights_to_json(weights),
        tfInput=tfInput,
        tfOutput=tfOutput,
        tfDropout=tfDropout,
        toKeepDropout=toKeepDropout,
        predictionCol=predictionCol,
        device=device)


def attach_pretrained_model_to_pipeline(checkpoint_path: str, graph_json: str,
                                        pipeline_model, inputCol: str,
                                        tfInput: str, tfOutput: str,
                                        predictionCol: str = "predicted",
                                        device=None):
    """Append an imported model to an existing PipelineModel (reference
    ``attach_tensorflow_model_to_pipeline``, ``tensorflow_model_loader.py:35-45``)."""
    from .compat import PipelineModel
    model = load_checkpoint_model(checkpoint_path, graph_json, inputCol,
                                  tfInput, tfOutput, predictionCol,
                                  device=device)
    return PipelineModel(stages=list(pipeline_model.stages) + [model])


# reference-named alias (same role; native checkpoint formats)
attach_tensorflow_model_to_pipeline = attach_pretrained_model_to_pipeline


# ---------------------------------------------------------------------------
# PyTorch state_dict import (capability upgrade: the reference only imports
# TF1 Saver checkpoints, tensorflow_model_loader.py:8-32)
# ---------------------------------------------------------------------------

_TORCH_SKIP_SUFFIXES = ("num_batches_tracked",)


def _torch_state_dict(path: str):
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    out = {}
    for name, t in sd.items():
        if any(name.endswith(suf) for suf in _TORCH_SKIP_SUFFIXES):
            continue
        if not hasattr(t, "detach"):
            raise ValueError(
                f"{path}: entry {name!r} is {type(t).__name__}, not a "
                f"tensor — this looks like a checkpoint wrapper; load it "
                f"yourself and torch.save() just the state_dict (keys: "
                f"{sorted(sd)[:10]})")
        out[name] = np.asarray(t.detach().cpu().numpy())
    return out


def _adapt_torch_layout(name: str, arr: np.ndarray,
                        target_shape) -> Optional[np.ndarray]:
    """Match a torch tensor to a target slot, adapting the layout:

    - 2-D ``*.weight`` -> ``.T`` (torch Linear stores [out, in]; kernels
      here are [in, out])
    - 4-D ``*.weight`` -> OIHW -> HWIO permute (torch conv layout)
    - exact shape otherwise

    SQUARE shapes fit both ways with no shape signal, so the ``.weight``
    name decides: Linear/conv weights transform, everything else (biases,
    norm scales, embeddings accessed by other names) stays as-is. torch
    ``nn.Embedding`` tables also end in ``.weight`` but are [num, dim]
    un-transposed — pass ``var_order`` with explicit names if a SQUARE
    embedding must import (non-square ones disambiguate by shape).
    """
    target_shape = tuple(target_shape)
    is_weight = name.endswith(".weight")
    if is_weight and arr.ndim == 2:
        t = np.ascontiguousarray(arr.T)
        if t.shape == target_shape:
            return t
    if is_weight and arr.ndim == 4:
        hwio = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))
        if hwio.shape == target_shape:
            return hwio
    if arr.shape == target_shape:
        return arr
    if not is_weight and arr.ndim == 2 and arr.T.shape == target_shape:
        # transposed non-.weight 2-D tensors still adapt (unusual naming)
        return np.ascontiguousarray(arr.T)
    return None


def extract_torch_weights(path: str, graph_json: str,
                          var_order: Optional[List[str]] = None
                          ) -> List[np.ndarray]:
    """Read a torch ``state_dict`` into the flat weight list of ``graph_json``
    (any model spec: DSL / registry / TF1 metagraph; read on the CPU).

    With ``var_order`` (state_dict key names), weights map positionally onto
    the graph's flat slots; otherwise assignment is by shape (with automatic
    Linear-transpose / OIHW->HWIO adaptation), name order breaking ties —
    the same contract as the TF1 checkpoint import."""
    model = _cpu_model(graph_json)
    flat_specs = [(lname, pname, tuple(int(d) for d in shape))
                  for lname, pspec in model.param_specs().items()
                  for pname, (shape, _init) in pspec.items()]
    sd = _torch_state_dict(path)

    if var_order is not None:
        missing = [n for n in var_order if n not in sd]
        if missing:
            raise KeyError(f"state_dict keys {missing} not found "
                           f"(has: {sorted(sd)})")
        if len(var_order) != len(flat_specs):
            raise ValueError(f"var_order has {len(var_order)} names; graph "
                             f"needs {len(flat_specs)} weights")
        out = []
        for name, (lname, pname, shape) in zip(var_order, flat_specs):
            fit = _adapt_torch_layout(name, sd[name], shape)
            if fit is None:
                raise ValueError(
                    f"state_dict[{name!r}] shape {sd[name].shape} does not "
                    f"fit graph slot {lname}/{pname} {shape} (even "
                    f"transposed/permuted)")
            out.append(fit)
        return out

    def natural(name):
        # '10.weight' must sort AFTER '2.weight' (torch Sequential numbering)
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", name)]

    unused = sorted(sd.items(), key=lambda kv: natural(kv[0]))
    return _greedy_match(unused, flat_specs, _adapt_torch_layout,
                         "torch state_dict")


def load_torch_model(path: str,
                     graph_json: str,
                     inputCol: str,
                     tfInput: str,
                     tfOutput: str,
                     predictionCol: str = "predicted",
                     var_order: Optional[List[str]] = None,
                     tfDropout: Optional[str] = None,
                     toKeepDropout: bool = False,
                     device=None) -> SparkAsyncDLModel:
    """torch ``state_dict`` -> fitted ``SparkAsyncDLModel`` (the
    :func:`load_tensorflow_model` analog for the torch ecosystem)."""
    resolve_device(device)
    weights = extract_torch_weights(path, graph_json, var_order)
    return SparkAsyncDLModel(
        inputCol=inputCol, modelJson=graph_json,
        modelWeights=convert_weights_to_json(weights),
        tfInput=tfInput, tfOutput=tfOutput, predictionCol=predictionCol,
        tfDropout=tfDropout, toKeepDropout=toKeepDropout, device=device)
