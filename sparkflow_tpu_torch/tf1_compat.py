"""Execute TF1 ``MetaGraphDef`` JSON directly — the reference's wire format —
in PyTorch. The port of the JAX package's ``tf1_compat.py``.

The reference serializes models as ``json_format.MessageToJson(
export_meta_graph())`` (``sparkflow/graph_utils.py:6-15``) and every Param
and pipeline carries that string. :class:`TF1GraphModel` interprets the
``graph_def`` nodes one TF op at a time and exposes the surface of
:class:`~sparkflow_tpu_torch.graphdef.GraphModel` (``init`` /
``load_params`` / ``apply`` / ``loss_vector`` / ordered ``param_specs`` /
``resolve``), so ``SparkAsyncDL(tensorflowGraph=<reference metagraph
JSON>)`` trains on the card with no TensorFlow (and no ``google.protobuf``)
installed.

Scope: the JAX interpreter's op set — dense/conv/pool layers, elementwise
math, reductions, shape plumbing, ``tf.losses``-style loss subgraphs,
random initializers and dropout, ``VariableV2`` and resource variables
(``VarHandleOp`` / ``ReadVariableOp``). Any other op raises
``NotImplementedError`` naming it.

As in the JAX package, parsing and shape plumbing (``Shape`` ->
``StridedSlice`` -> ``Fill`` ...) stay in numpy: a value computed only from
constants and static shapes is a numpy array. Tensor math runs on ``torch``
tensors on the model's device:

- NHWC / HWIO stay the layouts (other ``data_format`` s are refused, as
  there); a convolution or pooling permutes to NCHW around ``F.conv2d`` /
  ``F.max_pool2d`` / ``F.avg_pool2d``, the convolution through
  :func:`~sparkflow_tpu_torch.graphdef._conv2d` (TF32 off, the CPU
  strided-backward crop);
- ``SAME`` padding is TF's, the odd row and column at the end, applied by
  ``F.pad`` (``-inf`` for max-pooling; an average divides by the count of
  real elements; LRN sums over a ``SAME`` channel window);
- ``compute_dtype`` (bf16) casts the operands of products (MatMul,
  BatchMatMul, Conv2D, depthwise) and their result is float32, as the JAX
  evaluator's ``preferred_element_type`` asks;
- float64 / int64 values become float32 / int32 where they meet tensors, as
  JAX does with 64-bit mode off; bf16 and f16 constants are decoded from
  their bits (``halfVal``) with no ``ml_dtypes``;
- ``TopKV2`` and ``ArgMax`` / ``ArgMin`` break ties by the lower index, as
  ``lax.top_k`` / ``jnp.argmax`` do;
- random ops (initializers, dropout) draw from a ``torch.Generator``: the
  distributions are TF's, the draws are not ``jax.random``'s. ``init``
  evaluates each variable's initializer subgraph on the CPU from one seeded
  generator, so a seed gives the same weights on every device.

Gradients come from autograd; ``SoftmaxCrossEntropyWithLogits`` still
returns its backprop tensor as its second output for graphs that read it.
The loss collection's scalar is mapped back to a per-example vector by the
JAX package's walk up the reduction subgraph, so padded rows are masked.
Every node is an eager call: on the card a step is host-paced, one Python
dispatch per node.
"""

from __future__ import annotations

import base64
import json
import math
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .device import as_dtype, resolve_device
from .graphdef import _conv2d, _pad_nchw, _same_pads, _softplus

# TF dtype -> numpy dtype of the parsed (static) value. bfloat16 has no
# numpy type without ml_dtypes: its constants become torch.bfloat16 tensors
_DTYPES = {
    "DT_FLOAT": np.float32, "DT_DOUBLE": np.float64, "DT_INT32": np.int32,
    "DT_INT64": np.int64, "DT_BOOL": np.bool_, "DT_HALF": np.float16,
    "DT_BFLOAT16": "bfloat16",
}

# numpy dtype -> torch dtype of a value that meets the tensors; 64-bit
# types narrow as JAX's do with 64-bit mode off
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32, np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
}

_VAR_OPS = ("VarHandleOp", "VariableV2", "Variable")

# suffix marking a Const node that carries CHECKPOINT-RESTORED state baked
# into the graph JSON by bake_nontrainable_values — the marker suppresses the
# fresh-init warning in the evaluator's non-trainable variable fallback
_BAKED_SUFFIX = "/imported_value"

_NP_TO_DT = {np.dtype(np.float32): "DT_FLOAT", np.dtype(np.float64): "DT_DOUBLE",
             np.dtype(np.int32): "DT_INT32", np.dtype(np.int64): "DT_INT64",
             np.dtype(np.bool_): "DT_BOOL", np.dtype(np.float16): "DT_HALF"}


def bake_nontrainable_values(graph_json, values) -> str:
    """Embed restored non-trainable variable values (batch-norm moving
    statistics and the like) into a MetaGraphDef JSON as Const initializers.

    The reference's wire format carries *trainable* variables only
    (``sparkflow/tensorflow_model_loader.py:23-24`` extracts
    ``tf.trainable_variables()``), so a trained BN model round-trips with
    fresh 0/1 moving stats. Baking the checkpoint tensors into the graph
    keeps the wire format self-contained: the returned JSON serves correctly
    through the interpreter and survives pipeline persistence with no schema
    change. The JSON is the JAX package's, byte for byte.

    ``values``: variable node name -> numpy array. Each variable's
    initializer ``Assign`` is re-pointed at a new Const node holding the
    tensor (created if the graph had no Assign for it).
    """
    d = json.loads(graph_json) if isinstance(graph_json, str) else dict(graph_json)
    gd = d.get("graphDef") or d.get("graph_def")
    if gd is None:
        raise ValueError("not a MetaGraphDef JSON (no graphDef)")
    nodes = gd.setdefault("node", [])
    by_name = {n["name"]: n for n in nodes}
    for vname, arr in values.items():
        node = by_name.get(vname)
        if node is None or node["op"] not in _VAR_OPS:
            raise ValueError(f"{vname!r} is not a variable node in this graph")
        arr = np.ascontiguousarray(arr)
        dt = _NP_TO_DT.get(arr.dtype)
        if dt is None:
            raise ValueError(f"{vname!r}: unsupported dtype {arr.dtype}")
        cname = vname + _BAKED_SUFFIX
        const = {
            "name": cname, "op": "Const",
            "attr": {"dtype": {"type": dt},
                     "value": {"tensor": {
                         "dtype": dt,
                         "tensorShape": {"dim": [{"size": str(s)}
                                                 for s in arr.shape]},
                         "tensorContent": base64.b64encode(
                             arr.astype(arr.dtype.newbyteorder("<"))
                             .tobytes()).decode("ascii")}}},
        }
        if cname in by_name:
            by_name[cname].clear()
            by_name[cname].update(const)
        else:
            nodes.append(const)
            by_name[cname] = const
        # re-point the variable's initializer Assign at the baked Const
        assign = next((n for n in nodes
                       if n.get("op") in ("Assign", "AssignVariableOp")
                       and n.get("input", [None])[0].split(":")[0].lstrip("^")
                       == vname), None)
        if assign is not None:
            ins = list(assign["input"])
            ins[1] = cname
            assign["input"] = ins
        else:
            nodes.append({"name": vname + "/imported_assign", "op": "Assign",
                          "input": [vname, cname]})
    return json.dumps(d)


def is_tf1_metagraph(graph_json) -> bool:
    """Cheap sniff: is this (string or parsed dict) a MetaGraphDef JSON?
    The single source of truth for wire-format dispatch (used by
    ``models.model_from_json``)."""
    if isinstance(graph_json, str):
        try:
            graph_json = json.loads(graph_json)
        except (ValueError, TypeError):
            return False
    return (isinstance(graph_json, dict)
            and ("graphDef" in graph_json or "graph_def" in graph_json))


def _b64str(s: str) -> str:
    return base64.b64decode(s).decode("utf-8", errors="replace")


def _parse_variable_name(raw: bytes) -> Optional[str]:
    """Field 1 (variable_name) of a serialized VariableDef proto — minimal
    varint parse, no protobuf schema needed."""
    if not raw or raw[0] != 0x0A:
        return None
    ln, i = 0, 1
    shift = 0
    while i < len(raw):
        b = raw[i]
        ln |= (b & 0x7F) << shift
        i += 1
        shift += 7
        if not b & 0x80:
            break
    return raw[i:i + ln].decode("utf-8", errors="replace")


def _attr_shape(node: dict, key: str = "shape") -> Tuple[int, ...]:
    sh = node.get("attr", {}).get(key, {}).get("shape", {})
    return tuple(int(d.get("size", -1)) for d in sh.get("dim", []))


def _attr_type(node: dict, key: str = "dtype"):
    t = node.get("attr", {}).get(key, {}).get("type", "DT_FLOAT")
    return _DTYPES.get(t, np.float32)


def _torch_dtype(dt) -> torch.dtype:
    """A ``_DTYPES`` entry as the torch dtype a tensor of it holds."""
    if dt == "bfloat16":
        return torch.bfloat16
    return _TORCH_DTYPES.get(np.dtype(dt), torch.float32)


def _half_bits(vals, shape, n: int, bf16: bool):
    """A ``halfVal`` list (16-bit patterns as ints) decoded to float32:
    bfloat16 bits are the top half of a float32's, float16 bits a numpy
    float16's."""
    bits = np.asarray(vals, dtype=np.uint32)
    if bits.size == 1 and n > 1:
        bits = np.full(n, bits[0], dtype=np.uint32)
    if bf16:
        out = (bits << 16).astype(np.uint32).view(np.float32)
    else:
        out = bits.astype(np.uint16).view(np.float16).astype(np.float32)
    return out.reshape(shape)


def _parse_const(node: dict):
    """A Const node's value: a numpy array (static), or a
    ``torch.bfloat16`` CPU tensor for a bfloat16 constant."""
    t = node["attr"]["value"]["tensor"]
    dtype = _DTYPES.get(t.get("dtype", "DT_FLOAT"), np.float32)
    shape = tuple(int(d.get("size", 0))
                  for d in t.get("tensorShape", {}).get("dim", []))
    n = int(np.prod(shape)) if shape else 1
    if dtype == "bfloat16":
        if "tensorContent" in t:
            raw = np.frombuffer(base64.b64decode(t["tensorContent"]),
                                dtype=np.dtype(np.uint16).newbyteorder("<"))
            f32 = _half_bits(raw, shape, n, bf16=True)
        elif "halfVal" in t:
            f32 = _half_bits(t["halfVal"], shape, n, bf16=True)
        else:
            f32 = np.zeros(shape, np.float32)
        return torch.from_numpy(np.ascontiguousarray(f32)).to(torch.bfloat16)
    if "tensorContent" in t:
        arr = np.frombuffer(base64.b64decode(t["tensorContent"]),
                            dtype=np.dtype(dtype).newbyteorder("<"))
        return arr.reshape(shape).astype(dtype)
    if dtype == np.float16 and "halfVal" in t:
        return _half_bits(t["halfVal"], shape, n, bf16=False).astype(
            np.float16)
    for key, cast in (("floatVal", np.float32), ("doubleVal", np.float64),
                      ("intVal", np.int32), ("int64Val", np.int64),
                      ("boolVal", np.bool_)):
        if key in t:
            vals = np.asarray(t[key], dtype=cast)
            n = int(np.prod(shape)) if shape else max(vals.size, 1)
            if vals.size == 1 and n > 1:
                vals = np.full(n, vals[0], dtype=cast)
            return vals.reshape(shape).astype(dtype)
    return np.zeros(shape, dtype)


def _is_static(*vals) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float, bool))
               for v in vals)


def _axes(axes) -> Optional[Tuple[int, ...]]:
    """A reduction's axes operand as a tuple, or None for "all": an empty
    axes operand reduces everything, as the JAX evaluator does."""
    a = np.asarray(axes)
    if a.size == 0:
        return None
    return tuple(int(v) for v in np.atleast_1d(a))


def _np_reduce(name, x, axes, keepdims):
    fn = {"Sum": np.sum, "Mean": np.mean, "Max": np.max, "Min": np.min,
          "Prod": np.prod, "All": np.all, "Any": np.any}[name]
    return fn(x, axis=_axes(axes), keepdims=keepdims)


def _torch_reduce(name, x, axes, keepdims):
    dims = _axes(axes)
    if dims is None:
        dims = tuple(range(x.dim()))
    dims = tuple(sorted({d % max(x.dim(), 1) for d in dims}))
    if name == "Sum":
        return x.sum(dim=dims, keepdim=keepdims) if dims else x
    if name == "Mean":
        if x.dtype in (torch.int32, torch.int64, torch.bool):
            # jnp.mean of integers is a float mean
            x = x.float()
        return x.mean(dim=dims, keepdim=keepdims) if dims else x
    if name == "Max":
        return x.amax(dim=dims, keepdim=keepdims) if dims else x
    if name == "Min":
        return x.amin(dim=dims, keepdim=keepdims) if dims else x
    fn = {"Prod": torch.prod, "All": torch.all, "Any": torch.any}[name]
    for d in sorted(dims, reverse=True):
        x = fn(x, dim=d, keepdim=keepdims)
    return x


def _index_dims(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` for a tuple of ints and slices, negative steps included
    (torch slicing takes positive steps only)."""
    out = x
    dim = 0
    shrink = []
    for it in idx:
        n = out.shape[dim]
        if isinstance(it, slice):
            start, stop, step = it.indices(n)
            if step > 0:
                out = out[(slice(None),) * dim + (slice(start, stop, step),)]
            else:
                pick = torch.arange(start, stop, step, device=out.device)
                out = out.index_select(dim, pick)
            dim += 1
        else:
            i = int(it)
            out = out.narrow(dim, i % n if n else i, 1)
            shrink.append(dim)
            dim += 1
    for d in reversed(shrink):
        out = out.squeeze(d)
    return out


def _window(attr, key: str) -> Tuple[int, int]:
    """The spatial (H, W) entries of an NHWC ksize/strides attribute; the
    batch and channel entries must be 1."""
    v = [int(s) for s in attr[key]["list"]["i"]]
    if len(v) != 4 or v[0] != 1 or v[3] != 1:
        raise NotImplementedError(
            f"{key}={v}: only windows over the spatial axes of NHWC are "
            f"supported")
    return v[1], v[2]


def _pool_pad(x, kh, kw, sh, sw, padding: str, value: float = 0.0):
    if padding not in ("SAME", "VALID"):
        raise NotImplementedError(f"padding {padding!r}")
    return _pad_nchw(x, kh, kw, sh, sw, padding, value)


class _Names:
    def __init__(self, known):
        self._known = set(known)

    def resolve(self, tensor_name: str) -> str:
        base = tensor_name.split(":")[0]
        if base in self._known:
            return base
        known = ", ".join(sorted(list(self._known))[:20])
        raise KeyError(f"tensor {tensor_name!r} not found in graph; "
                       f"known tensors include: {known}")


class TF1GraphModel:
    """Executable wrapper for a TF1 MetaGraphDef JSON on one device (see the
    module docstring). ``device`` defaults to the CUDA card; ``"cpu"`` must
    be asked for."""

    # quantized serving trees dequantize at the variable read (weight-only
    # regardless of the requested mode — see _param_value)
    SUPPORTS_INT8_SERVING = True

    def __init__(self, graph_json, compute_dtype=None, device=None):
        d = json.loads(graph_json) if isinstance(graph_json, str) else graph_json
        gd = d.get("graphDef") or d.get("graph_def") or {}
        self._nodes: Dict[str, dict] = {n["name"]: n for n in gd.get("node", [])}
        self.compute_dtype = as_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.graphdef = _Names(self._nodes)
        # 'weight_only' | 'dynamic' when serving a quantized tree; TF1
        # graphs serve both as weight-only (see _param_value)
        self.quant_mode: Optional[str] = None
        self._tree = None

        cd = d.get("collectionDef") or d.get("collection_def") or {}
        self._loss_names = list(
            cd.get("losses", {}).get("nodeList", {}).get("value", []))

        # trainable order straight from the collection (= creation order,
        # exactly tf.trainable_variables — the reference's flat weight order)
        self._var_order: List[str] = []
        tv = cd.get("trainable_variables", {}).get("bytesList", {}).get("value", [])
        for raw in tv:
            name = _parse_variable_name(base64.b64decode(raw))
            if name:
                self._var_order.append(name.split(":")[0])
        if not self._var_order:  # no collection: fall back to node scan order
            self._var_order = [n["name"] for n in gd.get("node", [])
                               if n["op"] in _VAR_OPS]
        self._var_shapes = {}
        for vname in self._var_order:
            node = self._nodes.get(vname)
            if node is None:
                raise ValueError(f"trainable variable {vname!r} has no node")
            self._var_shapes[vname] = _attr_shape(node)

        # params are grouped scope/leaf ONLY when scopes appear contiguously
        # in creation order — otherwise grouping would silently permute the
        # flat wire order away from tf.trainable_variables (e.g. reopened
        # variable scopes). Interleaved scopes fall back to one layer per
        # variable, which preserves the flat order unconditionally.
        scopes_seen: List[str] = []
        self._grouped = True
        for vname in self._var_order:
            scope = vname.rsplit("/", 1)[0] if "/" in vname else vname
            if scope in scopes_seen and scopes_seen[-1] != scope:
                self._grouped = False
                break
            if not scopes_seen or scopes_seen[-1] != scope:
                scopes_seen.append(scope)

        # assign node per variable (for init-value subgraph evaluation).
        # Recorded for EVERY variable node, not just trainables: non-trainable
        # variables (batch-norm moving stats) are read via their initializer.
        self._var_init = {}
        for n in self._nodes.values():
            if n["op"] in ("Assign", "AssignVariableOp"):
                ins = n.get("input", [])
                if len(ins) >= 2:
                    target = ins[0].split(":")[0].lstrip("^")
                    tnode = self._nodes.get(target)
                    if (tnode is not None and tnode["op"] in _VAR_OPS
                            and target not in self._var_init):
                        self._var_init[target] = ins[1]

    # -- GraphModel surface --------------------------------------------------

    def resolve(self, tensor_name: str) -> str:
        """The node a tensor name (``:0`` suffix optional) names; KeyError
        listing known names otherwise."""
        return self.graphdef.resolve(tensor_name)

    def nontrainable_variables(self) -> List[str]:
        """Variable nodes outside the trainable collection (batch-norm moving
        statistics etc.) — the state :func:`bake_nontrainable_values` can
        restore from a checkpoint."""
        trainable = set(self._var_order)
        return [n["name"] for n in self._nodes.values()
                if n["op"] in _VAR_OPS and n["name"] not in trainable]

    def _param_key(self, vname: str) -> Tuple[str, str]:
        if self._grouped and "/" in vname:
            return tuple(vname.rsplit("/", 1))
        return vname, "value"

    def param_specs(self):
        """Ordered specs; flattening them yields EXACTLY the trainable
        collection order (= ``tf.trainable_variables``, the reference's flat
        wire format)."""
        specs: Dict[str, Dict[str, tuple]] = {}
        for vname in self._var_order:
            scope, leaf = self._param_key(vname)
            specs.setdefault(scope, {})[leaf] = (self._var_shapes[vname], "zeros")
        return specs

    def _param_value(self, params, vname: str):
        scope, leaf = self._param_key(vname)
        layer = params[scope]
        if leaf not in layer and f"{leaf}_q8" in layer:
            # int8-quantized serving tree (utils/quant.py): TF1 graphs
            # dequantize at the variable read — weight-only semantics, so
            # every downstream op is untouched (the interpreter can't know
            # which consumer is a matmul, so the dynamic int8 path doesn't
            # apply here)
            from .utils.quant import dequantize_tensor
            return dequantize_tensor(layer[f"{leaf}_q8"],
                                     layer[f"{leaf}_scale"])
        return layer[leaf]

    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0):
        """Evaluate each trainable variable's initializer subgraph (the
        graph's own ``glorot_uniform`` / ``zeros`` / ... ops) on the CPU,
        drawing from ``generator`` (a CPU ``torch.Generator``; default one
        seeded with ``seed``) in creation order; install the tree on the
        model's device and return it."""
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        cpu = torch.device("cpu")
        params: Dict[str, Dict[str, Any]] = {}
        for vname in self._var_order:
            init_node = self._var_init.get(vname)
            if init_node is not None:
                ev = _Evaluator(self, params={}, feeds={}, train=False,
                                generator=generator, device=cpu)
                val = ev.tensor(ev.value(init_node))
            else:
                val = torch.zeros(self._var_shapes[vname], dtype=torch.float32)
            scope, leaf = self._param_key(vname)
            params.setdefault(scope, {})[leaf] = val.to(self.device)
        return self.load_params(params)

    def load_params(self, tree, trainable: bool = False):
        """Make ``tree`` the default for ``params=None`` calls; with
        ``trainable`` every leaf requires a gradient (the trainer's tree,
        which its optimizer updates in place)."""
        self._tree = {ln: {pn: t.detach().requires_grad_(trainable)
                           for pn, t in layer.items()}
                      for ln, layer in tree.items()}
        return self._tree

    def params(self):
        if self._tree is None:
            raise RuntimeError("model has no parameters yet: call init() or "
                               "load_params()")
        return self._tree

    def quantize_for_serving(self, params, mode: str = "weight_only",
                             min_size: int = 4096):
        """int8-quantize a trained params tree for inference
        (``utils/quant.py``). TF1 graphs always serve weight-only — the
        interpreter dequantizes at the variable read, so a 'dynamic'
        request is accepted but behaves as weight-only."""
        from .utils.quant import quantize_for_serving
        return quantize_for_serving(self, params, mode, min_size)

    def apply(self, params, feeds: Dict[str, Any], outputs: Sequence[str],
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Evaluate the named tensors (``:N`` picks a node's N-th output).
        ``generator`` (on the model's device) feeds the random ops; without
        one they draw from a generator seeded 0, as the JAX evaluator's
        default key."""
        params = self.params() if params is None else params
        ev = _Evaluator(self, params, feeds, train, generator)
        return {o: ev.tensor(ev.value(o)) for o in outputs}

    def loss_vector(self, params, feeds: Dict[str, Any], train: bool = True,
                    generator: Optional[torch.Generator] = None):
        """Per-example loss [batch]: the first LOSSES-collection entry walked
        back to its batch-shaped node, plus every further entry (scalars
        spread per example, batch-shaped ones reduced per example)."""
        if not self._loss_names:
            raise ValueError("metagraph has no losses collection "
                             "(tf.GraphKeys.LOSSES) — reference contract")
        params = self.params() if params is None else params
        target = self._per_example_loss_node(self._loss_names[0].split(":")[0])
        ev = _Evaluator(self, params, feeds, train, generator)
        val = ev.tensor(ev.value(target))
        for name in self._loss_names[1:]:
            extra = ev.tensor(ev.value(name.split(":")[0]))
            if extra.dim() > 1:
                extra = extra.reshape(extra.shape[0], -1).mean(dim=-1)
            val = val + extra
        if val.dim() == 0:
            # irreducibly scalar loss: broadcast (padding correctness is then
            # the caller's concern; reference losses all pass the walk above)
            b = None
            for v in feeds.values():
                if hasattr(v, "shape") and len(v.shape) >= 1:
                    b = v.shape[0]
                    break
            return val.expand(b or 1)
        if val.dim() > 1:
            val = val.reshape(val.shape[0], -1).mean(dim=-1)
        return val

    def _node_batch_shaped(self, name: str) -> bool:
        node = self._nodes.get(name)
        if node is None:
            return False
        shapes = (node.get("attr", {}).get("_output_shapes", {})
                  .get("list", {}).get("shape", []))
        if not shapes:
            return False
        dims = shapes[0].get("dim", [])
        return bool(dims) and int(dims[0].get("size", 0)) == -1

    def _per_example_loss_node(self, name: str) -> str:
        """Walk up scalar-reduction plumbing (DivNoNan/Sum/Mean/Mul/weights)
        to the last node that still carries the batch dimension."""
        seen = 0
        cur = name
        while not self._node_batch_shaped(cur) and seen < 32:
            node = self._nodes.get(cur)
            if node is None or node["op"] not in (
                    "DivNoNan", "RealDiv", "Sum", "Mean", "Mul", "Identity",
                    "Neg", "AddV2", "Add", "Squeeze"):
                break
            ins = [i for i in node.get("input", []) if not i.startswith("^")]
            if not ins:
                break
            # prefer a batch-shaped input; else follow input 0
            nxt = None
            for i in ins:
                if self._node_batch_shaped(i.split(":")[0]):
                    nxt = i.split(":")[0]
                    break
            cur = nxt if nxt is not None else ins[0].split(":")[0]
            seen += 1
        return cur

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x


# elementwise tables: (numpy fn for static operands, torch fn)
_BINARY = {
    "AddV2": (np.add, torch.add), "Add": (np.add, torch.add),
    "Sub": (np.subtract, torch.sub),
    "Mul": (np.multiply, torch.mul),
    "RealDiv": (np.divide, torch.true_divide),
    "Div": (np.divide, torch.true_divide),
    "Maximum": (np.maximum, torch.maximum),
    "Minimum": (np.minimum, torch.minimum),
    "SquaredDifference": (lambda a, b: np.square(a - b),
                          lambda a, b: torch.square(a - b)),
    "Pow": (np.power, torch.pow),
    "FloorDiv": (np.floor_divide, torch.floor_divide),
    "Equal": (np.equal, torch.eq), "NotEqual": (np.not_equal, torch.ne),
    "Greater": (np.greater, torch.gt),
    "GreaterEqual": (np.greater_equal, torch.ge),
    "Less": (np.less, torch.lt), "LessEqual": (np.less_equal, torch.le),
    "LogicalAnd": (np.logical_and, torch.logical_and),
    "LogicalOr": (np.logical_or, torch.logical_or),
    "FloorMod": (np.mod, torch.remainder),
    "Mod": (np.fmod, torch.fmod),
    "TruncateMod": (np.fmod, torch.fmod),
    "Atan2": (np.arctan2, torch.atan2),
}

_UNARY = {
    "Neg": (np.negative, torch.neg), "Log": (np.log, torch.log),
    "Log1p": (np.log1p, torch.log1p), "Exp": (np.exp, torch.exp),
    "Sqrt": (np.sqrt, torch.sqrt),
    "Rsqrt": (lambda x: 1 / np.sqrt(x), lambda x: 1 / torch.sqrt(x)),
    "Square": (np.square, torch.square), "Abs": (np.abs, torch.abs),
    "Sign": (np.sign, torch.sign), "Floor": (np.floor, torch.floor),
    "Ceil": (np.ceil, torch.ceil), "Round": (np.round, torch.round),
    "Sigmoid": (None, torch.sigmoid), "Tanh": (np.tanh, torch.tanh),
    "Relu": (lambda x: np.maximum(x, 0), torch.relu),
    "Relu6": (lambda x: np.clip(x, 0, 6), lambda x: torch.clamp(x, 0, 6)),
    "Elu": (None, F.elu), "Selu": (None, F.selu),
    "Softplus": (None, _softplus),
    "LogicalNot": (np.logical_not, torch.logical_not),
    "Erf": (None, torch.erf),
    "IsFinite": (np.isfinite, torch.isfinite),
    "ZerosLike": (np.zeros_like, torch.zeros_like),
    "OnesLike": (np.ones_like, torch.ones_like),
    "Reciprocal": (lambda x: 1 / x, lambda x: 1 / x),
    "Inv": (lambda x: 1 / x, lambda x: 1 / x),
    "Sin": (np.sin, torch.sin), "Cos": (np.cos, torch.cos),
    "Tan": (np.tan, torch.tan), "Atan": (np.arctan, torch.atan),
    "Expm1": (np.expm1, torch.expm1),
    "Softsign": (None, lambda x: x / (1 + torch.abs(x))),
}

_REDUCTIONS = ("Sum", "Mean", "Max", "Min", "Prod", "All", "Any")


class _Evaluator:
    """Memoized single-pass interpreter over graph_def nodes. Static values
    are numpy arrays; everything that touches a parameter or a feed is a
    tensor on ``device``."""

    def __init__(self, model: TF1GraphModel, params, feeds, train,
                 generator=None, device=None):
        self.m = model
        self.params = params
        self.device = model.device if device is None else device
        self.feeds = {k.split(":")[0]: v for k, v in (feeds or {}).items()}
        self.train = train
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.cache: Dict[str, Any] = {}

    # -- plumbing ------------------------------------------------------------

    def tensor(self, x) -> torch.Tensor:
        """``x`` as a tensor on the evaluator's device; a numpy value takes
        the dtype JAX gives it with 64-bit mode off."""
        if torch.is_tensor(x):
            return x if x.device == self.device else x.to(self.device)
        a = np.asarray(x)
        dt = _TORCH_DTYPES.get(a.dtype)
        if dt is None:
            raise TypeError(f"unsupported value dtype {a.dtype}")
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def value(self, ref: str):
        name, idx = (ref.split(":") + ["0"])[:2] if ":" in ref else (ref, "0")
        out = self._node_value(name)
        if isinstance(out, tuple):
            return out[int(idx)]
        return out

    def _in(self, node, i):
        return self.value(node["input"][i].lstrip("^"))

    def _ins(self, node):
        return [self.value(i) for i in node.get("input", [])
                if not i.startswith("^")]

    def _t_in(self, node, i) -> torch.Tensor:
        return self.tensor(self._in(node, i))

    def _node_value(self, name: str):
        if name in self.cache:
            return self.cache[name]
        node = self.m._nodes.get(name)
        if node is None:
            raise KeyError(f"no node named {name!r} in graph")
        val = self._eval(node)
        self.cache[name] = val
        return val

    def _compute_cast(self, x) -> torch.Tensor:
        """Product-feeding operands honor the model's compute_dtype (one
        policy: TF1GraphModel.cast); the product's result is float32."""
        return self.m.cast(self.tensor(x))

    def _random(self, node, fn) -> torch.Tensor:
        shape = [int(s) for s in np.asarray(self._in(node, 0)).reshape(-1)]
        return fn(shape)

    # -- op table ------------------------------------------------------------

    def _eval(self, node):  # noqa: C901 — one dispatch table, kept flat
        op = node["op"]
        attr = node.get("attr", {})

        if op == "Placeholder":
            base = node["name"]
            if base in self.feeds:
                return self.tensor(self.feeds[base])
            raise KeyError(f"placeholder {base!r} not fed; feeds: "
                           f"{sorted(self.feeds)}")
        if op == "PlaceholderWithDefault":
            base = node["name"]
            if base in self.feeds:
                return self.tensor(self.feeds[base])
            return self._in(node, 0)
        if op == "Const":
            return _parse_const(node)
        if op in _VAR_OPS:
            name = node["name"]
            if name in self.m._var_shapes:
                return self.tensor(self.m._param_value(self.params, name))
            # non-trainable variable (e.g. batch-norm moving_mean/variance):
            # not in the trainable collection, so it has no params slot —
            # evaluate its initializer subgraph instead. Checkpoint imports
            # bake restored values in as `<var>/imported_value` Consts
            # (bake_nontrainable_values); WITHOUT a baked value the
            # initializer yields FRESH-INIT state (0/1), not whatever the
            # source graph learned — warn in that case only
            init_node = self.m._var_init.get(name)
            if init_node is None or not init_node.endswith(_BAKED_SUFFIX):
                warnings.warn(
                    f"reading non-trainable variable {name!r} via its "
                    f"initializer subgraph (the reference wire format "
                    f"carries trainable variables only); if this model "
                    f"relies on learned non-trainable state (e.g. batch-norm "
                    f"moving statistics), those values are fresh-initialized "
                    f"here — import through load_tensorflow_model to restore "
                    f"them from the checkpoint", stacklevel=2)
            if init_node is not None:
                return self.value(init_node)
            return torch.zeros(_attr_shape(node),
                               dtype=_torch_dtype(_attr_type(node)),
                               device=self.device)
        if op in ("ReadVariableOp", "Identity", "StopGradient", "Snapshot",
                  "PreventGradient", "CheckNumerics", "EnsureShape"):
            return self._in(node, 0)
        if op == "NoOp":
            return None

        # --- elementwise: the numpy path constant-folds shape plumbing
        if op in _BINARY:
            a, b = self._in(node, 0), self._in(node, 1)
            np_fn, t_fn = _BINARY[op]
            if _is_static(a, b):
                return np.asarray(np_fn(a, b))
            return t_fn(self.tensor(a), self.tensor(b))
        if op == "DivNoNan":
            a, b = self._t_in(node, 0), self._t_in(node, 1)
            zero = b == 0
            return torch.where(zero, torch.zeros((), dtype=a.dtype,
                                                 device=a.device),
                               a / torch.where(zero, torch.ones_like(b), b))
        if op in _UNARY:
            x = self._in(node, 0)
            np_fn, t_fn = _UNARY[op]
            if np_fn is not None and _is_static(x):
                return np.asarray(np_fn(x))
            return t_fn(self.tensor(x))
        if op == "Cast":
            return self._t_in(node, 0).to(_torch_dtype(_attr_type(node, "DstT")))
        if op == "Select" or op == "SelectV2":
            c, a, b = (self.tensor(v) for v in self._ins(node))
            return torch.where(c.bool(), a, b)
        if op == "ClipByValue":
            x, lo, hi = (self.tensor(v) for v in self._ins(node))
            return torch.minimum(torch.maximum(x, lo.to(x.dtype)),
                                 hi.to(x.dtype))

        # --- linear algebra / nn ---
        if op in ("Conv2D", "MaxPool", "AvgPool", "BiasAdd",
                  "DepthwiseConv2dNative"):
            fmt = attr.get("data_format", {}).get("s")
            if fmt and _b64str(fmt) not in ("NHWC", ""):
                raise NotImplementedError(
                    f"TF1 op {op!r} with data_format={_b64str(fmt)!r} "
                    f"(node {node['name']!r}): only NHWC is supported")
        if op == "MatMul":
            a, b = self._compute_cast(self._in(node, 0)), \
                self._compute_cast(self._in(node, 1))
            if attr.get("transpose_a", {}).get("b"):
                a = a.t()
            if attr.get("transpose_b", {}).get("b"):
                b = b.t()
            return torch.matmul(a, b).float()
        if op == "BiasAdd":
            return self._t_in(node, 0) + self._t_in(node, 1)
        if op == "Softmax":
            return torch.softmax(self._t_in(node, 0), dim=-1)
        if op == "LogSoftmax":
            return torch.log_softmax(self._t_in(node, 0), dim=-1)
        if op == "SoftmaxCrossEntropyWithLogits":
            logits, labels = self._t_in(node, 0), self._t_in(node, 1)
            logp = torch.log_softmax(logits, dim=-1)
            loss = -torch.sum(labels * logp, dim=-1)
            grad = torch.softmax(logits, dim=-1) - labels
            return (loss, grad)
        if op in ("Conv2D", "DepthwiseConv2dNative"):
            return self._conv(node, attr, op == "DepthwiseConv2dNative")
        if op in ("MaxPool", "AvgPool"):
            return self._pool(node, attr, op == "MaxPool")
        if op == "LeakyRelu":
            alpha = float(attr.get("alpha", {}).get("f", 0.2))
            return F.leaky_relu(self._t_in(node, 0), negative_slope=alpha)
        if op == "AddN":
            vals = self._ins(node)
            if _is_static(*vals):
                return np.asarray(sum(np.asarray(v) for v in vals))
            out = self.tensor(vals[0])
            for v in vals[1:]:
                out = out + self.tensor(v)
            return out
        if op == "SparseSoftmaxCrossEntropyWithLogits":
            logits = self._t_in(node, 0)
            labels = self._t_in(node, 1).long()
            logp = torch.log_softmax(logits, dim=-1)
            loss = -torch.gather(logp, -1, labels[..., None])[..., 0]
            grad = (torch.softmax(logits, dim=-1)
                    - F.one_hot(labels, logits.shape[-1]).to(logits.dtype))
            return (loss, grad)
        if op == "OneHot":
            ind = self._t_in(node, 0).long()
            depth = int(np.asarray(self._in(node, 1)))
            on_v, off_v = self._t_in(node, 2), self._t_in(node, 3)
            axis = int(attr.get("axis", {}).get("i", -1))
            # out-of-range ids (TF's -1 padding) give an all-off row, as
            # jax.nn.one_hot does
            oh = (ind[..., None] == torch.arange(
                depth, device=ind.device)).to(torch.float32)
            if axis != -1:
                oh = torch.movedim(oh, -1, axis)
            return (oh * (on_v - off_v) + off_v).to(on_v.dtype)
        if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            x = self._t_in(node, 0)
            scale, offset = self._t_in(node, 1), self._t_in(node, 2)
            eps = float(attr.get("epsilon", {}).get("f", 1e-3))
            training = bool(attr.get("is_training", {}).get("b", True))
            fmt = attr.get("data_format", {}).get("s")
            if fmt and _b64str(fmt) not in ("NHWC", ""):
                raise NotImplementedError(
                    f"{op} with data_format={_b64str(fmt)!r}: NHWC only")
            if training:
                axes = tuple(range(x.dim() - 1))
                mean = x.mean(dim=axes)
                var = x.var(dim=axes, unbiased=False)
            else:
                mean, var = self._t_in(node, 3), self._t_in(node, 4)
            inv = torch.rsqrt(var + eps)
            y = (x - mean) * inv * scale + offset
            # outputs: y, batch_mean, batch_var(, reserved...) — reserved
            # slots mirror the stats, enough for any consumer on the value path
            return (y, mean, var, mean, var, var)
        if op in ("BatchMatMul", "BatchMatMulV2"):
            a = self._compute_cast(self._in(node, 0))
            b = self._compute_cast(self._in(node, 1))
            if attr.get("adj_x", {}).get("b"):
                a = a.transpose(-1, -2)
            if attr.get("adj_y", {}).get("b"):
                b = b.transpose(-1, -2)
            return torch.matmul(a, b).float()
        if op == "LRN":
            x = self._t_in(node, 0)
            radius = int(attr.get("depth_radius", {}).get("i", 5))
            bias = float(attr.get("bias", {}).get("f", 1.0))
            alpha = float(attr.get("alpha", {}).get("f", 1.0))
            beta = float(attr.get("beta", {}).get("f", 0.5))
            win = 2 * radius + 1
            # the squares summed over a SAME window along the channels
            sq = F.pad(torch.square(x), (radius, radius))
            sq_sum = sq.unfold(-1, win, 1).sum(-1)
            return x / torch.pow(bias + alpha * sq_sum, beta)
        if op == "Cumsum":
            x = self._t_in(node, 0)
            axis = int(np.asarray(self._in(node, 1)))
            exclusive = bool(attr.get("exclusive", {}).get("b", False))
            reverse = bool(attr.get("reverse", {}).get("b", False))
            if reverse:
                x = torch.flip(x, (axis,))
            out = torch.cumsum(x, dim=axis)
            if exclusive:
                out = out - x
            if reverse:
                out = torch.flip(out, (axis,))
            return out
        if op == "TopKV2":
            x = self._t_in(node, 0)
            k = int(np.asarray(self._in(node, 1)))
            # a stable descending sort: equal values keep index order, so
            # ties go to the lower index as in lax.top_k
            vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
            return (vals[..., :k], idx[..., :k].to(torch.int32))
        if op in ("Split", "SplitV", "Unpack"):
            if op == "Unpack":
                x = self._t_in(node, 0)
                axis = int(attr.get("axis", {}).get("i", 0))
                n = int(attr.get("num", {}).get("i", x.shape[axis]))
                return tuple(p.squeeze(axis)
                             for p in torch.tensor_split(x, n, dim=axis))
            if op == "Split":  # inputs: (axis, value)
                axis = int(np.asarray(self._in(node, 0)))
                x = self._t_in(node, 1)
                n = int(attr.get("num_split", {}).get("i", 1))
                return tuple(torch.tensor_split(x, n, dim=axis))
            # SplitV: (value, size_splits, axis)
            x = self._t_in(node, 0)
            sizes = [int(s) for s in np.asarray(self._in(node, 1)).reshape(-1)]
            axis = int(np.asarray(self._in(node, 2)))
            if sizes.count(-1) > 1:
                raise NotImplementedError(
                    f"SplitV (node {node['name']!r}): more than one inferred "
                    f"(-1) entry in size_splits {sizes}")
            if -1 in sizes:  # one entry may be inferred from the dim size
                rest = sum(s for s in sizes if s != -1)
                sizes[sizes.index(-1)] = int(x.shape[axis]) - rest
            return tuple(torch.split(x, sizes, dim=axis))
        if op in ("SpaceToBatchND", "BatchToSpaceND"):
            return self._space_batch(node, op == "SpaceToBatchND")
        if op in ("Print", "PrintV2", "Assert"):
            # debug/validation side-effects: pass through / no-op on the
            # value path (Assert appears only as a control dependency)
            return self._in(node, 0) if node.get("input") else None

        # --- reductions / indexing ---
        if op in _REDUCTIONS:
            x = self._in(node, 0)
            axes = self._in(node, 1)
            keep = bool(attr.get("keep_dims", {}).get("b", False))
            if _is_static(x, axes):
                return np.asarray(_np_reduce(op, np.asarray(x), axes, keep))
            return _torch_reduce(op, self.tensor(x), np.asarray(axes), keep)
        if op in ("ArgMax", "ArgMin"):
            x = self._t_in(node, 0)
            axis = int(np.asarray(self._in(node, 1)))
            # torch.argmax / argmin return the first extremal index
            fn = torch.argmax if op == "ArgMax" else torch.argmin
            return fn(x, dim=axis).to(
                _torch_dtype(_attr_type(node, "output_type")))

        # --- shapes (static: numpy) ---
        if op == "Shape":
            return np.asarray(tuple(self._shape(self._in(node, 0))), np.int32)
        if op == "Size":
            return np.asarray(int(np.prod(self._shape(self._in(node, 0)))),
                              np.int32)
        if op == "Rank":
            return np.asarray(len(self._shape(self._in(node, 0))), np.int32)
        if op == "Reshape":
            shape = [int(s) for s in np.asarray(self._in(node, 1)).reshape(-1)]
            return torch.reshape(self._t_in(node, 0), shape)
        if op == "ExpandDims":
            return torch.unsqueeze(self._t_in(node, 0),
                                   int(np.asarray(self._in(node, 1))))
        if op == "Squeeze":
            dims = [int(i) for i in attr.get("squeeze_dims", {})
                    .get("list", {}).get("i", [])]
            x = self._t_in(node, 0)
            if not dims:
                return torch.squeeze(x)
            for d in sorted((d % x.dim() for d in dims), reverse=True):
                x = x.squeeze(d)
            return x
        if op == "Fill":
            dims = [int(d) for d in np.asarray(self._in(node, 0)).reshape(-1)]
            v = self._in(node, 1)
            if _is_static(v):
                return np.full(dims, np.asarray(v))
            return torch.broadcast_to(self.tensor(v), dims).clone()
        if op == "Range":
            s, l, d = (np.asarray(self._in(node, i)) for i in range(3))
            return np.arange(int(s), int(l), int(d), dtype=np.int32)
        if op == "Pack":
            vals = self._ins(node)
            axis = int(attr.get("axis", {}).get("i", 0))
            if _is_static(*vals):
                return np.stack([np.asarray(v) for v in vals], axis=axis)
            return torch.stack([self.tensor(v) for v in vals], dim=axis)
        if op == "ConcatV2":
            vals = self._ins(node)
            axis = int(np.asarray(vals[-1]))
            parts = vals[:-1]
            if _is_static(*parts):
                return np.concatenate([np.asarray(v) for v in parts], axis)
            return torch.cat([self.tensor(v) for v in parts], dim=axis)
        if op == "Tile":
            reps = [int(r) for r in np.asarray(self._in(node, 1)).reshape(-1)]
            return torch.tile(self._t_in(node, 0), reps)
        if op == "Transpose":
            perm = [int(p) for p in np.asarray(self._in(node, 1)).reshape(-1)]
            return self._t_in(node, 0).permute(perm)
        if op == "StridedSlice":
            x = self._in(node, 0)
            begin = np.asarray(self._in(node, 1)).reshape(-1)
            end = np.asarray(self._in(node, 2)).reshape(-1)
            strides = np.asarray(self._in(node, 3)).reshape(-1)
            bm = int(attr.get("begin_mask", {}).get("i", 0))
            em = int(attr.get("end_mask", {}).get("i", 0))
            sm = int(attr.get("shrink_axis_mask", {}).get("i", 0))
            em_ellipsis = int(attr.get("ellipsis_mask", {}).get("i", 0))
            nm = int(attr.get("new_axis_mask", {}).get("i", 0))
            if em_ellipsis or nm:
                raise NotImplementedError(
                    "StridedSlice ellipsis/new-axis masks not supported")
            idx = []
            for i in range(len(begin)):
                if sm & (1 << i):
                    idx.append(int(begin[i]))
                    continue
                b = None if bm & (1 << i) else int(begin[i])
                e = None if em & (1 << i) else int(end[i])
                idx.append(slice(b, e, int(strides[i])))
            if _is_static(x):
                return np.asarray(x)[tuple(idx)]
            return _index_dims(self.tensor(x), idx)
        if op == "L2Loss":
            return torch.sum(torch.square(self._t_in(node, 0))) / 2.0
        if op in ("Pad", "PadV2"):
            x = self._t_in(node, 0)
            pairs = [(int(a), int(b))
                     for a, b in np.asarray(self._in(node, 1))]
            cval = (float(np.asarray(self._in(node, 2)))
                    if op == "PadV2" else 0.0)
            flat = [p for a, b in reversed(pairs) for p in (a, b)]
            return F.pad(x, flat, value=cval)
        if op == "Slice":
            x = self._in(node, 0)
            begin = [int(b) for b in np.asarray(self._in(node, 1)).reshape(-1)]
            size = [int(s) for s in np.asarray(self._in(node, 2)).reshape(-1)]
            idx = tuple(slice(b, None if s == -1 else b + s)
                        for b, s in zip(begin, size))
            if _is_static(x):
                return np.asarray(x)[idx]
            return _index_dims(self.tensor(x), idx)
        if op in ("GatherV2", "ResourceGather"):
            x = self._t_in(node, 0)
            ind = self._t_in(node, 1).long()
            axis = (int(np.asarray(self._in(node, 2))) if op == "GatherV2"
                    else 0) % x.dim()
            out = x.index_select(axis, ind.reshape(-1))
            return out.reshape(tuple(x.shape[:axis]) + tuple(ind.shape)
                               + tuple(x.shape[axis + 1:]))
        if op == "BroadcastTo":
            shape = [int(s) for s in np.asarray(self._in(node, 1)).reshape(-1)]
            return torch.broadcast_to(self._t_in(node, 0), shape)

        # --- random (initializers, dropout) ---
        g, dev = self.generator, self.device
        if op == "RandomUniform":
            return self._random(node, lambda s: torch.rand(
                s, generator=g, device=dev))
        if op in ("RandomStandardNormal", "RandomNormal"):
            return self._random(node, lambda s: torch.randn(
                s, generator=g, device=dev))
        if op == "TruncatedNormal":
            return self._random(node, lambda s: torch.nn.init.trunc_normal_(
                torch.empty(s, device=dev), 0.0, 1.0, -2.0, 2.0,
                generator=g))

        raise NotImplementedError(
            f"TF1 op {op!r} (node {node['name']!r}) is not supported by the "
            f"tf1_compat interpreter; rebuild this model with "
            f"sparkflow_tpu_torch.nn")

    # -- ops with more plumbing ----------------------------------------------

    @staticmethod
    def _shape(x) -> Tuple[int, ...]:
        return tuple(x.shape) if torch.is_tensor(x) else np.shape(x)

    def _conv(self, node, attr, depthwise: bool) -> torch.Tensor:
        """Conv2D (HWIO kernel) or DepthwiseConv2dNative ([H, W, C, M]
        kernel, one group per input channel) on NHWC, TF's padding."""
        x = self._compute_cast(self._in(node, 0))
        k = self._compute_cast(self._in(node, 1))
        sh, sw = _window(attr, "strides")
        padding = _b64str(attr["padding"]["s"])
        dil = [int(d) for d in attr.get("dilations", {})
               .get("list", {}).get("i", [1, 1, 1, 1])]
        dh, dw = dil[1], dil[2]
        groups = 1
        if depthwise:
            h, w, c, m = k.shape
            k = k.reshape(h, w, 1, c * m)
            groups = c
        kh, kw = k.shape[0], k.shape[1]
        xc = x.permute(0, 3, 1, 2)
        if padding == "SAME":
            top, bottom = _same_pads(xc.shape[2], (kh - 1) * dh + 1, sh)
            left, right = _same_pads(xc.shape[3], (kw - 1) * dw + 1, sw)
            if top or bottom or left or right:
                xc = F.pad(xc, (left, right, top, bottom))
        elif padding != "VALID":
            raise NotImplementedError(
                f"{node['op']} padding {padding!r} (node {node['name']!r})")
        y = _conv2d(xc, k.permute(3, 2, 0, 1), (sh, sw), (dh, dw), groups)
        return y.permute(0, 2, 3, 1).float()

    def _pool(self, node, attr, is_max: bool) -> torch.Tensor:
        x = self._t_in(node, 0).permute(0, 3, 1, 2)
        kh, kw = _window(attr, "ksize")
        sh, sw = _window(attr, "strides")
        padding = _b64str(attr["padding"]["s"])
        if is_max:
            y = F.max_pool2d(_pool_pad(x, kh, kw, sh, sw, padding, -math.inf),
                             (kh, kw), (sh, sw))
        else:
            # the window sum over the count of real (unpadded) elements
            y = F.avg_pool2d(_pool_pad(x, kh, kw, sh, sw, padding),
                             (kh, kw), (sh, sw))
            if padding == "SAME":
                ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                  device=x.device)
                y = y / F.avg_pool2d(_pool_pad(ones, kh, kw, sh, sw, padding),
                                     (kh, kw), (sh, sw))
        return y.permute(0, 2, 3, 1)

    def _space_batch(self, node, to_batch: bool) -> torch.Tensor:
        """SpaceToBatchND / BatchToSpaceND — the lowering TF emits for
        dilated (atrous) convolutions."""
        x = self._t_in(node, 0)
        block = [int(b) for b in np.asarray(self._in(node, 1)).reshape(-1)]
        pc = np.asarray(self._in(node, 2)).reshape(-1, 2)
        m = len(block)
        rest = list(x.shape[1 + m:])
        if to_batch:
            pads = [(0, 0)] * len(rest) + [(int(a), int(b))
                                           for a, b in reversed(pc)]
            x = F.pad(x, [p for ab in pads for p in ab])
            batch, spatial = x.shape[0], list(x.shape[1:1 + m])
            shape = [batch]
            for d, b in zip(spatial, block):
                shape += [d // b, b]
            x = x.reshape(shape + rest)
            perm = ([2 * i + 2 for i in range(m)] + [0]
                    + [2 * i + 1 for i in range(m)]
                    + [2 * m + 1 + i for i in range(len(rest))])
            x = x.permute(perm)
            return x.reshape([batch * int(np.prod(block))]
                             + [spatial[i] // block[i] for i in range(m)]
                             + rest)
        batch, spatial = x.shape[0], list(x.shape[1:1 + m])
        prod_b = int(np.prod(block))
        x = x.reshape(list(block) + [batch // prod_b] + spatial + rest)
        perm = [m]
        for i in range(m):
            perm += [m + 1 + i, i]
        perm += [2 * m + 1 + i for i in range(len(rest))]
        x = x.permute(perm)
        x = x.reshape([batch // prod_b]
                      + [spatial[i] * block[i] for i in range(m)] + rest)
        idx = [slice(None)]
        for i in range(m):
            c0, c1 = int(pc[i][0]), int(pc[i][1])
            idx.append(slice(c0, x.shape[1 + i] - c1 if c1 else None))
        return x[tuple(idx + [slice(None)] * len(rest))]
