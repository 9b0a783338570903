"""Model-definition DSL used inside ``build_graph`` model functions.

This replaces the raw TF1 ops the reference's users write inside ``build_graph``
model functions (``tf.placeholder`` / ``tf.layers.dense`` / ``tf.losses.*`` — see
reference ``examples/simple_dnn.py:13-22``). The API is deliberately shaped like
TF1's so a sparkflow model function ports line-for-line:

    import sparkflow_tpu_torch.nn as nn

    def small_model():
        x = nn.placeholder([None, 784], name='x')
        y = nn.placeholder([None, 10], name='y')
        h = nn.dense(x, 256, activation='relu')
        h = nn.dense(h, 256, activation='relu')
        out = nn.dense(h, 10)
        z = nn.argmax(out, 1, name='out')
        loss = nn.softmax_cross_entropy(y, out)
        return loss

Under the hood each call appends a node to the active :class:`~sparkflow_tpu_torch.graphdef.GraphDef`
(a JSON-serializable dataflow spec executed by PyTorch), instead of mutating a global
TF graph. Loss functions auto-register in the graph's loss collection, mirroring
``tf.losses.*`` adding to ``tf.GraphKeys.LOSSES`` (consumed by the reference at
``sparkflow/HogwildSparkModel.py:50``).
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence, Union

import numpy as np

from .graphdef import GraphDef, _TF_ACT_SCOPE

_state = threading.local()


class Sym:
    """Symbolic tensor: a handle to a node in the graph being built."""

    __slots__ = ("graph", "node_id")

    def __init__(self, graph: GraphDef, node_id: int):
        self.graph = graph
        self.node_id = node_id

    @property
    def name(self) -> str:
        return f"{self.graph.nodes[self.node_id].name}:0"

    @property
    def shape(self):
        # lazily infer via a throwaway GraphModel would be heavy; shapes are
        # re-derived at execution. Expose the declared placeholder shape only.
        node = self.graph.nodes[self.node_id]
        return node.attrs.get("shape")

    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)

    def __sub__(self, other):
        return subtract(self, other)

    def __rsub__(self, other):
        return subtract(other, self)

    def __mul__(self, other):
        return multiply(self, other)

    def __rmul__(self, other):
        return multiply(other, self)

    def __repr__(self):
        return f"Sym({self.name})"


def current_graph() -> GraphDef:
    g = getattr(_state, "graph", None)
    if g is None:
        raise RuntimeError(
            "no active graph: model-definition ops must run inside "
            "sparkflow_tpu_torch.graph_utils.build_graph(model_fn)")
    return g


class graph_scope:
    """Context manager installing a fresh GraphDef as the active graph."""

    def __init__(self, graph: Optional[GraphDef] = None):
        self.graph = graph or GraphDef()

    def __enter__(self) -> GraphDef:
        self._prev = getattr(_state, "graph", None)
        _state.graph = self.graph
        return self.graph

    def __exit__(self, *exc):
        _state.graph = self._prev
        return False


def _ids(vals: Sequence[Union[Sym, float, int]]):
    """Resolve op inputs to node ids, lifting Python scalars to constants."""
    g = current_graph()
    out = []
    for v in vals:
        if isinstance(v, Sym):
            out.append(v.node_id)
        else:
            node = g.add_node("constant", "const", [], {"value": v})
            out.append(node.id)
    return out


def _op(op: str, inputs: Sequence[Any], attrs: dict, name: Optional[str] = None) -> Sym:
    g = current_graph()
    node = g.add_node(op, name, _ids(inputs), attrs)
    return Sym(g, node.id)


# -- inputs ------------------------------------------------------------------

def placeholder(*args, name: Optional[str] = None, dtype: str = "float32",
                shape=None) -> Sym:
    """Declare a model input. ``shape=[None, d]`` — None marks the batch dim.

    Positional forms accepted (TF1 model functions are written both ways):
    ``placeholder([None, d], 'x')`` (shape-first, this framework's native form)
    and ``placeholder('float', [None, d], 'x')`` / ``placeholder('float',
    shape=[...], name=...)`` (tf.placeholder's dtype-first ordering, reference
    ``examples/autoencoder_example.py:11``).
    """
    args = list(args)
    pos: dict = {}
    if args and isinstance(args[0], str):  # TF1 ordering: (dtype, shape, name)
        order = ["dtype", "shape", "name"]
    else:  # native ordering: (shape, name, dtype)
        order = ["shape", "name", "dtype"]
    if len(args) > len(order):
        raise TypeError(f"placeholder takes at most {len(order)} positional "
                        f"arguments ({len(args)} given)")
    for slot, val in zip(order, args):
        pos[slot] = val
    for slot, kw in (("shape", shape), ("name", name), ("dtype", dtype)):
        if slot in pos and kw is not None and slot != "dtype" :
            raise TypeError(f"placeholder got multiple values for {slot!r}")
    shape = pos.get("shape", shape)
    name = pos.get("name", name)
    dtype = pos.get("dtype", dtype)
    if shape is None:
        raise ValueError("placeholder requires a shape")
    if dtype in ("float", "float32", "f32"):
        dtype = "float32"
    shape = [None if d is None else int(d) for d in shape]
    return _op("placeholder", [], {"shape": shape, "dtype": dtype}, name or "placeholder")


def placeholder_with_default(default, shape=None, name: Optional[str] = None,
                             dtype: str = "float32") -> Sym:
    """A placeholder that evaluates to ``default`` when not fed — the TF1
    ``tf.placeholder_with_default`` pattern users need for dropout keep-prob
    (fed 1.0/0.0 at predict time via the estimator's ``tfDropout`` param,
    reference ``sparkflow/ml_util.py:70-71``; unfed during training)."""
    if shape is None:
        shape = list(np.asarray(default).shape) if hasattr(default, "shape") else []
    return _op("placeholder", [],
               {"shape": list(shape), "dtype": dtype, "default": default},
               name or "placeholder")


def constant(value, name: Optional[str] = None, dtype: str = "float32") -> Sym:
    return _op("constant", [], {"value": value, "dtype": dtype}, name or "const")


# -- layers ------------------------------------------------------------------

def dense(x: Sym, units: int, activation: Optional[str] = None,
          name: Optional[str] = None, use_bias: bool = True,
          kernel_initializer: str = "glorot_uniform",
          bias_initializer: str = "zeros") -> Sym:
    """Fully-connected layer (``tf.layers.dense`` analog).

    With ``activation='sigmoid'`` and ``name='out'``, the post-activation tensor
    is addressable as ``'out/Sigmoid:0'`` (TF1 scope-naming compat) as well as
    ``'out:0'``.
    """
    g = current_graph()
    base = g.unique_name(name or "dense")
    node = g.add_node("dense", f"{base}/BiasAdd" if use_bias else f"{base}/MatMul",
                      _ids([x]),
                      {"units": int(units), "use_bias": use_bias,
                       "kernel_init": kernel_initializer, "bias_init": bias_initializer})
    out = Sym(g, node.id)
    if activation is not None:
        act_name = f"{base}/{_TF_ACT_SCOPE.get(activation, activation)}"
        out = _op(activation, [out], {}, act_name)
    g.add_alias(f"{base}:0", out.node_id)
    return out


def conv2d(x: Sym, filters: int, kernel_size, strides=1, padding: str = "valid",
           activation: Optional[str] = None, name: Optional[str] = None,
           use_bias: bool = True, kernel_initializer: str = "glorot_uniform") -> Sym:
    """2-D convolution over NHWC input (``tf.layers.conv2d`` analog)."""
    g = current_graph()
    base = g.unique_name(name or "conv2d")
    node = g.add_node("conv2d", f"{base}/BiasAdd", _ids([x]),
                      {"filters": int(filters), "kernel_size": kernel_size,
                       "strides": strides, "padding": padding.upper(),
                       "use_bias": use_bias, "kernel_init": kernel_initializer})
    out = Sym(g, node.id)
    if activation is not None:
        out = _op(activation, [out], {}, f"{base}/{_TF_ACT_SCOPE.get(activation, activation)}")
    g.add_alias(f"{base}:0", out.node_id)
    return out


def max_pooling2d(x: Sym, pool_size, strides=None, padding: str = "valid",
                  name: Optional[str] = None) -> Sym:
    return _op("max_pool2d", [x],
               {"pool_size": pool_size, "strides": strides or pool_size,
                "padding": padding.upper()}, name or "max_pool")


def avg_pooling2d(x: Sym, pool_size, strides=None, padding: str = "valid",
                  name: Optional[str] = None) -> Sym:
    return _op("avg_pool2d", [x],
               {"pool_size": pool_size, "strides": strides or pool_size,
                "padding": padding.upper()}, name or "avg_pool")


def flatten(x: Sym, name: Optional[str] = None) -> Sym:
    return _op("flatten", [x], {}, name or "flatten")


def reshape(x: Sym, shape, name: Optional[str] = None) -> Sym:
    return _op("reshape", [x], {"shape": [int(d) for d in shape]}, name or "reshape")


def dropout(x: Sym, keep_prob: Union[Sym, float, None] = None,
            rate: Union[Sym, float, None] = None, name: Optional[str] = None) -> Sym:
    """Dropout. ``keep_prob`` follows TF1 ``tf.nn.dropout`` semantics (fraction
    to KEEP); ``rate`` follows TF2/torch semantics (fraction to DROP). Either may
    be a placeholder ``Sym`` so inference can feed 1.0/0.0 — this is what the
    estimator's ``tfDropout``/``toKeepDropout`` params drive (reference
    ``sparkflow/ml_util.py:70-71``)."""
    if (keep_prob is None) == (rate is None):
        raise ValueError("pass exactly one of keep_prob / rate")
    mode = "keep" if keep_prob is not None else "drop"
    p = keep_prob if keep_prob is not None else rate
    if isinstance(p, Sym):
        return _op("dropout", [x, p], {"mode": mode}, name or "dropout")
    return _op("dropout", [x], {"mode": mode, "rate": float(p)}, name or "dropout")


def layer_norm(x: Sym, epsilon: float = 1e-6, name: Optional[str] = None) -> Sym:
    return _op("layer_norm", [x], {"epsilon": epsilon}, name or "layer_norm")


def batch_norm(x: Sym, epsilon: float = 1e-5, name: Optional[str] = None) -> Sym:
    """Batch-statistics normalization (stateless — see graphdef._eval_batch_norm
    for the train/serve caveat vs TF1's moving averages)."""
    return _op("batch_norm", [x], {"epsilon": epsilon}, name or "batch_norm")


def embedding(ids: Sym, vocab_size: int, dim: int, name: Optional[str] = None) -> Sym:
    return _op("embedding", [ids], {"vocab_size": int(vocab_size), "dim": int(dim)},
               name or "embedding")


# -- pointwise / math --------------------------------------------------------

def _unary(op_name):
    def fn(x: Sym, name: Optional[str] = None) -> Sym:
        return _op(op_name, [x], {}, name or op_name)
    fn.__name__ = op_name
    return fn


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
softmax = _unary("softmax")
log_softmax = _unary("log_softmax")
gelu = _unary("gelu")
elu = _unary("elu")
leaky_relu = _unary("leaky_relu")
softplus = _unary("softplus")
swish = _unary("swish")


def argmax(x: Sym, axis: int = 1, name: Optional[str] = None) -> Sym:
    return _op("argmax", [x], {"axis": int(axis)}, name or "argmax")


def add(a, b, name: Optional[str] = None) -> Sym:
    return _op("add", [a, b], {}, name or "add")


def subtract(a, b, name: Optional[str] = None) -> Sym:
    return _op("subtract", [a, b], {}, name or "subtract")


def multiply(a, b, name: Optional[str] = None) -> Sym:
    return _op("multiply", [a, b], {}, name or "multiply")


def matmul(a: Sym, b: Sym, name: Optional[str] = None) -> Sym:
    return _op("matmul", [a, b], {}, name or "matmul")


def concat(xs: Sequence[Sym], axis: int = -1, name: Optional[str] = None) -> Sym:
    return _op("concat", list(xs), {"axis": int(axis)}, name or "concat")


# -- losses (auto-register, like tf.losses.*) --------------------------------

def _loss(op_name):
    def fn(labels: Sym, predictions: Sym, name: Optional[str] = None, **attrs) -> Sym:
        s = _op(op_name, [labels, predictions], attrs, name or op_name)
        s.graph.register_loss(s.node_id)
        return s
    fn.__name__ = op_name
    return fn


softmax_cross_entropy = _loss("softmax_cross_entropy")
sigmoid_cross_entropy = _loss("sigmoid_cross_entropy")
mean_squared_error = _loss("mean_squared_error")
absolute_difference = _loss("absolute_difference")
huber_loss = _loss("huber_loss")
log_loss = _loss("log_loss")
