"""Declarative, JSON-serializable model graphs executed by PyTorch — the port
of the JAX package's ``graphdef.py``.

The wire format is unchanged: :class:`GraphDef` and :class:`Node` are carried
as they are, so ``build_graph`` here gives the same JSON string as the JAX
package's and either package runs the other's graphs. :class:`GraphModel`
executes a graph in PyTorch with the JAX meaning of every op:

- tensors keep the NHWC layout and conv kernels the HWIO layout of the
  JAX ops (and of the flat weight list); a convolution or pooling permutes
  to NCHW for ``torch.nn.functional`` and back;
- ``SAME`` padding is TF's — ``ceil(in / stride)`` outputs, the odd pixel
  of padding after — applied by ``F.pad`` (``-inf`` for max-pooling; an
  average divides by the count of real elements);
- float32 convolutions run in float32, forward and backward (TF32 off
  inside the op), as the JAX op asks for float32
  (``preferred_element_type``);
- ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default),
  ``softplus`` is ``logaddexp(x, 0)`` (no linear cut-off), ``swish`` is
  ``silu``, ``batch_norm`` takes the biased variance and keeps no running
  statistics;
- dropout's ``mode="keep"`` reads its rate as a keep-probability, which a
  fed placeholder may set.

Randomness (initializers, dropout) comes from ``torch.Generator`` s: the
distributions are the JAX initializers', the draws are not ``jax.random``'s.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the flat weight-list helpers: spec order, the JAX package's wire format
from .convert import list_to_params, params_to_list  # noqa: F401
from .device import as_dtype, resolve_device

FORMAT_NAME = "sparkflow-tpu-graph"
FORMAT_VERSION = 1

Params = Dict[str, Dict[str, torch.Tensor]]

# ---------------------------------------------------------------------------
# GraphDef: nodes + name registry (carried unchanged: the JSON is shared)
# ---------------------------------------------------------------------------


class Node:
    """One op in the dataflow graph. Serializes to a plain JSON dict."""

    __slots__ = ("id", "op", "name", "inputs", "attrs")

    def __init__(self, id: int, op: str, name: str, inputs: List[int], attrs: Dict[str, Any]):
        self.id = id
        self.op = op
        self.name = name
        self.inputs = inputs
        self.attrs = attrs

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "op": self.op,
            "name": self.name,
            "inputs": list(self.inputs),
            "attrs": self.attrs,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Node":
        return Node(d["id"], d["op"], d["name"], list(d["inputs"]), dict(d["attrs"]))


class GraphDef:
    """A serializable model graph: nodes in topological (creation) order."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.losses: List[int] = []  # node ids registered as losses
        self.aliases: Dict[str, int] = {}  # tensor name -> node id
        self._name_counts: Dict[str, int] = {}
        self._taken: set = set()

    # -- construction -------------------------------------------------------

    def unique_name(self, base: str) -> str:
        n = self._name_counts.get(base, 0)
        while True:
            cand = base if n == 0 else f"{base}_{n}"
            n += 1
            if cand not in self._taken:
                self._name_counts[base] = n
                self._taken.add(cand)
                return cand

    def add_node(self, op: str, name: Optional[str], inputs: Sequence[int],
                 attrs: Dict[str, Any], alias: bool = True) -> Node:
        name = self.unique_name(name or op)
        node = Node(len(self.nodes), op, name, list(inputs), attrs)
        self.nodes.append(node)
        if alias:
            self.aliases[f"{name}:0"] = node.id
        return node

    def register_loss(self, node_id: int) -> None:
        self.losses.append(node_id)

    def add_alias(self, tensor_name: str, node_id: int) -> None:
        self.aliases[tensor_name] = node_id

    # -- lookup -------------------------------------------------------------

    def resolve(self, tensor_name: str) -> int:
        """Resolve a TF1-style tensor name ('x:0', 'out/Sigmoid:0', or bare 'x')."""
        for cand in (tensor_name, f"{tensor_name}:0"):
            if cand in self.aliases:
                return self.aliases[cand]
        known = ", ".join(sorted(self.aliases))
        raise KeyError(f"tensor {tensor_name!r} not found in graph; known tensors: {known}")

    def placeholders(self) -> List[Node]:
        return [n for n in self.nodes if n.op == "placeholder"]

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "format": FORMAT_NAME,
            "version": FORMAT_VERSION,
            "nodes": [n.to_json() for n in self.nodes],
            "losses": self.losses,
            "aliases": self.aliases,
        })

    @staticmethod
    def from_json(s: str) -> "GraphDef":
        d = json.loads(s)
        if d.get("format") != FORMAT_NAME:
            raise ValueError(f"not a {FORMAT_NAME} document (format={d.get('format')!r})")
        g = GraphDef()
        g.nodes = [Node.from_json(nd) for nd in d["nodes"]]
        g.losses = list(d["losses"])
        g.aliases = dict(d["aliases"])
        # mark full names AND base scope names (e.g. 'out' for 'out/BiasAdd')
        # as taken so extending a deserialized graph can't silently collide
        for n in g.nodes:
            g._taken.add(n.name)
            g._taken.add(n.name.split("/")[0])
        for a in g.aliases:
            g._taken.add(a.split(":")[0])
        return g


# ---------------------------------------------------------------------------
# Initializers: the JAX initializers' distributions, drawn from a
# torch.Generator on the CPU
# ---------------------------------------------------------------------------

Shape = Tuple[Optional[int], ...]

# name -> (scale, fan mode, distribution), as jax.nn.initializers defines them
_VARIANCE_SCALING = {
    "glorot_uniform": (1.0, "fan_avg", "uniform"),
    "glorot_normal": (1.0, "fan_avg", "truncated_normal"),
    "he_uniform": (2.0, "fan_in", "uniform"),
    "he_normal": (2.0, "fan_in", "truncated_normal"),
    "lecun_normal": (1.0, "fan_in", "truncated_normal"),
    "lecun_uniform": (1.0, "fan_in", "uniform"),
}


def _fans(shape) -> Tuple[float, float]:
    """``jax.nn.initializers``' fans: input axis -2, output axis -1, the
    other axes a receptive field (a conv kernel's H x W)."""
    if len(shape) < 2:
        n = float(np.prod(shape)) if shape else 1.0
        return n, n
    receptive = float(np.prod(shape[:-2])) if len(shape) > 2 else 1.0
    return shape[-2] * receptive, shape[-1] * receptive


def initialize(name: str, shape, generator: torch.Generator) -> torch.Tensor:
    """A float32 tensor of ``shape`` drawn by the initializer ``name`` (the
    JAX package's names: ``zeros``, ``ones``, ``normal(std)``, the glorot /
    he / lecun families), on the generator's device: the CPU for a CPU
    generator, the card for a CUDA one (a model too large to draw on the
    host)."""
    shape = tuple(int(d) for d in shape)
    dev = generator.device
    if name == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    if name == "ones":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    if name.startswith("normal"):
        stddev = 0.05
        if "(" in name:
            stddev = float(name[name.index("(") + 1:name.index(")")])
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev) * stddev
    if name not in _VARIANCE_SCALING:
        raise ValueError(f"unknown initializer {name!r}")
    scale, mode, dist = _VARIANCE_SCALING[name]
    fan_in, fan_out = _fans(shape)
    denom = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2
    variance = scale / max(1.0, denom)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if dist == "uniform":
        limit = math.sqrt(3 * variance)
        return torch.nn.init.uniform_(out, -limit, limit, generator=generator)
    # the stddev of a standard normal truncated to (-2, 2), as in JAX
    std = math.sqrt(variance) / .87962566103423978
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator) * std


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); torch's F.softplus turns linear
    # above 20
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


_ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "softplus": _softplus,
    "swish": F.silu,
    "identity": lambda x: x,
}

# Canonical TF1 op-scope names so 'out/Sigmoid:0'-style tensor names match
# what the reference's users are used to (tf.layers.dense(name='out',
# activation=tf.nn.sigmoid) -> tensor 'out/Sigmoid:0').
_TF_ACT_SCOPE = {
    "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh", "softmax": "Softmax",
    "log_softmax": "LogSoftmax", "gelu": "Gelu", "elu": "Elu",
    "leaky_relu": "LeakyRelu", "softplus": "Softplus", "swish": "Swish",
}

_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


class _EvalCtx:
    """Per-apply context threaded through op evaluation."""

    __slots__ = ("feeds", "train", "generator", "compute_dtype", "device",
                 "quant_mode")

    def __init__(self, feeds, train, generator, compute_dtype, device,
                 quant_mode=None):
        self.feeds = feeds
        self.train = train
        self.generator = generator
        self.compute_dtype = compute_dtype
        self.device = device
        self.quant_mode = quant_mode


def _cast(x, dtype):
    if dtype is None:
        return x
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype)
    return x


def _const(value, dtype: str, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value), dtype=_DTYPES.get(dtype, torch.float32),
                           device=device)


# Each op: infer(node, in_shapes) -> out_shape;
#          params(node, in_shapes) -> {pname: (shape, init_name)} or {};
#          eval(node, ins, ctx[, p]) -> tensor.
# The shape rules are the JAX package's, unchanged.

def _infer_placeholder(node, ins):
    return tuple(node.attrs["shape"])


def _infer_dense(node, ins):
    return tuple(ins[0][:-1]) + (node.attrs["units"],)


def _params_dense(node, ins):
    in_dim = ins[0][-1]
    if in_dim is None:
        raise ValueError(f"dense layer {node.name!r}: input feature dim must be static")
    p = {"kernel": ((in_dim, node.attrs["units"]), node.attrs.get("kernel_init", "glorot_uniform"))}
    if node.attrs.get("use_bias", True):
        p["bias"] = ((node.attrs["units"],), node.attrs.get("bias_init", "zeros"))
    return p


def _eval_dense(node, ins, ctx, p):
    x = _cast(ins[0], ctx.compute_dtype)
    if "kernel_q8" in p:  # int8-quantized serving tree (utils/quant.py)
        from .utils.quant import quantized_dense
        return _cast(quantized_dense(x, p, ctx.quant_mode or "weight_only",
                                     compute_dtype=ctx.compute_dtype),
                     ctx.compute_dtype)
    y = torch.matmul(x, _cast(p["kernel"], ctx.compute_dtype))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _conv_out_dim(size, k, stride, padding):
    if size is None:
        return None
    if padding == "SAME":
        return -(-size // stride)
    return -(-(size - k + 1) // stride)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF ``SAME`` padding of one spatial axis: (before, after), the odd
    element after (``lax.padtype_to_pads``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, kh, kw, sh, sw, pad: str, value: float = 0.0):
    """Pad an NCHW tensor for a ``SAME`` window (no-op for ``VALID``)."""
    if pad != "SAME":
        return x
    top, bottom = _same_pads(x.shape[2], kh, sh)
    left, right = _same_pads(x.shape[3], kw, sw)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _infer_conv2d(node, ins):
    n, h, w, _ = ins[0]
    kh, kw = _pair(node.attrs["kernel_size"])
    sh, sw = _pair(node.attrs.get("strides", 1))
    pad = node.attrs.get("padding", "VALID").upper()
    return (n, _conv_out_dim(h, kh, sh, pad), _conv_out_dim(w, kw, sw, pad), node.attrs["filters"])


def _params_conv2d(node, ins):
    cin = ins[0][-1]
    kh, kw = _pair(node.attrs["kernel_size"])
    p = {"kernel": ((kh, kw, cin, node.attrs["filters"]),
                    node.attrs.get("kernel_init", "glorot_uniform"))}
    if node.attrs.get("use_bias", True):
        p["bias"] = ((node.attrs["filters"],), node.attrs.get("bias_init", "zeros"))
    return p


class _NoTF32:
    """cuDNN runs float32 convolutions in TF32 unless told not to, and
    cuBLAS float32 matmuls when asked to; the JAX ops compute in float32
    (``preferred_element_type``). Turns TF32 off for both in the block and
    restores the caller's settings."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev
        return False


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (NCHW / OIHW, no padding) whose forward and backward
    both run with TF32 off: autograd would run the backward outside any
    context the forward set."""

    @staticmethod
    def forward(ctx, x, w, stride, dilation=(1, 1), groups=1):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.dilation, ctx.groups = stride, dilation, groups
        with _NoTF32():
            return F.conv2d(x, w, stride=stride, dilation=dilation,
                            groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _NoTF32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, list(ctx.stride), [0, 0],
                list(ctx.dilation), False, [0, 0], ctx.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def _conv2d(x, w, stride: Tuple[int, int],
            dilation: Tuple[int, int] = (1, 1), groups: int = 1):
    """``_Conv2d`` of NCHW ``x`` by OIHW ``w``. Rows and columns that no
    window reads (a strided convolution whose windows stop short of the
    edge) are cut first: for such a convolution the CPU's oneDNN backward
    gave wrong gradients that changed from run to run."""
    (sh, sw), (dh, dw) = stride, dilation
    kh = (w.shape[2] - 1) * dh + 1
    kw = (w.shape[3] - 1) * dw + 1
    h = (x.shape[2] - kh) // sh * sh + kh
    wd = (x.shape[3] - kw) // sw * sw + kw
    if (h, wd) != tuple(x.shape[2:]):
        x = x[:, :, :h, :wd]
    return _Conv2d.apply(x, w, (sh, sw), (dh, dw), groups)


def _eval_conv2d(node, ins, ctx, p):
    x = _cast(ins[0], ctx.compute_dtype)
    if "kernel_q8" in p:  # conv always serves weight-only (utils/quant.py)
        from .utils.quant import dequantize_tensor
        k = _cast(dequantize_tensor(p["kernel_q8"], p["kernel_scale"]),
                  ctx.compute_dtype)
    else:
        k = _cast(p["kernel"], ctx.compute_dtype)
    kh, kw = _pair(node.attrs["kernel_size"])
    sh, sw = _pair(node.attrs.get("strides", 1))
    pad = node.attrs.get("padding", "VALID").upper()
    xc = _pad_nchw(x.permute(0, 3, 1, 2), kh, kw, sh, sw, pad)
    y = _conv2d(xc, k.permute(3, 2, 0, 1), (sh, sw)).permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _infer_pool(node, ins):
    n, h, w, c = ins[0]
    kh, kw = _pair(node.attrs["pool_size"])
    sh, sw = _pair(node.attrs.get("strides", node.attrs["pool_size"]))
    pad = node.attrs.get("padding", "VALID").upper()
    return (n, _conv_out_dim(h, kh, sh, pad), _conv_out_dim(w, kw, sw, pad), c)


def _eval_pool(node, ins, ctx):
    kh, kw = _pair(node.attrs["pool_size"])
    sh, sw = _pair(node.attrs.get("strides", node.attrs["pool_size"]))
    pad = node.attrs.get("padding", "VALID").upper()
    x = ins[0].permute(0, 3, 1, 2)
    if node.op == "max_pool2d":
        y = F.max_pool2d(_pad_nchw(x, kh, kw, sh, sw, pad, -math.inf),
                         (kh, kw), (sh, sw))
    else:
        # the window sum over the count of real (unpadded) elements in it
        y = F.avg_pool2d(_pad_nchw(x, kh, kw, sh, sw, pad), (kh, kw), (sh, sw))
        if pad == "SAME":
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            y = y / F.avg_pool2d(_pad_nchw(ones, kh, kw, sh, sw, pad),
                                 (kh, kw), (sh, sw))
    return y.permute(0, 2, 3, 1)


def _infer_flatten(node, ins):
    n = ins[0][0]
    rest = ins[0][1:]
    if any(d is None for d in rest):
        raise ValueError("flatten: non-batch dims must be static")
    return (n, int(np.prod(rest)) if rest else 1)


def _infer_reshape(node, ins):
    shape = list(node.attrs["shape"])
    # -1 in position 0 keeps the batch dim; a single other -1 is inferred.
    in_shape = ins[0]
    out = []
    for i, d in enumerate(shape):
        if d == -1 and i == 0:
            out.append(in_shape[0])
        elif d == -1:
            out.append(None)  # resolved at eval time
        else:
            out.append(int(d))
    # try to resolve inner -1 statically
    if None not in in_shape:
        total = int(np.prod(in_shape))
        fixed = int(np.prod([d for d in out if d is not None])) or 1
        out = [d if d is not None else total // fixed for d in out]
    return tuple(out)


def _eval_reshape(node, ins, ctx):
    shape = [int(d) for d in node.attrs["shape"]]
    x = ins[0]
    if shape.count(-1) > 1:
        # a leading -1 means "keep the batch dim"; resolve it so at most one
        # unknown remains for reshape
        shape[0] = x.shape[0]
    return torch.reshape(x, tuple(shape))


def _infer_elementwise(node, ins):
    return ins[0]


def _infer_broadcast(node, ins):
    """Numpy-style broadcast of input shapes (None dims stay None)."""
    out: List[Optional[int]] = []
    rank = max(len(s) for s in ins)
    shapes = [(None,) * (rank - len(s)) + tuple(s) for s in ins]
    for dims in zip(*shapes):
        known = [d for d in dims if d is not None and d != 1]
        if known and any(k != known[0] for k in known):
            raise ValueError(f"{node.op} {node.name!r}: shapes {ins} do not broadcast")
        if known:
            out.append(known[0])
        elif all(d == 1 for d in dims):
            out.append(1)
        else:
            out.append(None)
    return tuple(out)


def _infer_argmax(node, ins):
    ax = node.attrs.get("axis", 1)
    s = list(ins[0])
    del s[ax]
    return tuple(s)


def _infer_matmul(node, ins):
    return tuple(ins[0][:-1]) + (ins[1][-1],)


def _infer_concat(node, ins):
    ax = node.attrs.get("axis", -1)
    s = list(ins[0])
    ax = ax if ax >= 0 else len(s) + ax
    dims = [i[ax] for i in ins]
    s[ax] = None if any(d is None for d in dims) else sum(dims)
    return tuple(s)


def _infer_loss(node, ins):
    return (ins[0][0],)  # per-example vector


def _params_layer_norm(node, ins):
    d = ins[0][-1]
    return {"scale": ((d,), "ones"), "bias": ((d,), "zeros")}


def _eval_batch_norm(node, ins, ctx, p):
    """Batch-statistics normalization over all non-channel axes + learned
    scale/shift, stateless (no running averages) as in the JAX package."""
    x = ins[0].float()
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return _cast(y, ctx.compute_dtype)


def _eval_layer_norm(node, ins, ctx, p):
    x = ins[0].float()
    eps = node.attrs.get("epsilon", 1e-6)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"] + p["bias"]
    return _cast(y, ctx.compute_dtype)


def _params_embedding(node, ins):
    return {"embedding": ((node.attrs["vocab_size"], node.attrs["dim"]),
                          node.attrs.get("init", "normal(0.02)"))}


def _eval_dropout(node, ins, ctx):
    x = ins[0]
    if len(node.inputs) > 1:
        rate = ins[1]
    else:
        rate = node.attrs.get("rate", 0.5)
    mode = node.attrs.get("mode", "keep")  # 'keep': rate = keep-prob (tf.nn.dropout TF1)
    if not ctx.train:
        return x
    rate = torch.as_tensor(rate, dtype=torch.float32, device=x.device)
    keep = rate if mode == "keep" else 1.0 - rate
    safe = keep.clamp_min(1e-8)
    mask = torch.rand(x.shape, generator=ctx.generator, device=x.device) < safe
    dropped = torch.where(mask, x / safe.to(x.dtype), torch.zeros_like(x))
    # keep >= 1 is the identity, decided on the device (a fed keep-prob
    # needs no host read)
    return torch.where(keep >= 1.0, x, dropped)


# Per-example losses (reduced over feature axes only; batch axis preserved so
# the trainer can mask padded rows).

def _feature_axes(x) -> Tuple[int, ...]:
    return tuple(range(1, x.dim()))


def _eval_softmax_ce(node, ins, ctx):
    labels, logits = ins[0].float(), ins[1].float()
    logz = torch.log_softmax(logits, dim=-1)
    return -torch.sum(labels * logz, dim=_feature_axes(logits))


def _eval_sigmoid_ce(node, ins, ctx):
    labels, logits = ins[0].float(), ins[1].float()
    per = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return per.mean(dim=_feature_axes(logits))


def _eval_mse(node, ins, ctx):
    per = torch.square(ins[0].float() - ins[1].float())
    return per.mean(dim=_feature_axes(per))


def _eval_abs_diff(node, ins, ctx):
    per = (ins[0].float() - ins[1].float()).abs()
    return per.mean(dim=_feature_axes(per))


def _eval_huber(node, ins, ctx):
    delta = node.attrs.get("delta", 1.0)
    abs_err = (ins[0].float() - ins[1].float()).abs()
    quad = abs_err.clamp_max(delta)
    lin = abs_err - quad
    per = 0.5 * quad * quad + delta * lin
    return per.mean(dim=_feature_axes(per))


def _eval_log_loss(node, ins, ctx):
    labels, preds = ins[0].float(), ins[1].float()
    eps = 1e-7
    per = -labels * torch.log(preds + eps) - (1 - labels) * torch.log(1 - preds + eps)
    return per.mean(dim=_feature_axes(per))


_LOSS_EVALS = {
    "softmax_cross_entropy": _eval_softmax_ce,
    "sigmoid_cross_entropy": _eval_sigmoid_ce,
    "mean_squared_error": _eval_mse,
    "absolute_difference": _eval_abs_diff,
    "huber_loss": _eval_huber,
    "log_loss": _eval_log_loss,
}


class _OpDef:
    __slots__ = ("infer", "params", "eval")

    def __init__(self, infer, eval, params=None):
        self.infer = infer
        self.eval = eval
        self.params = params


def _simple_eval(fn):
    return lambda node, ins, ctx: fn(ins[0])


def _eval_placeholder(node, ins, ctx):
    if node.name in ctx.feeds:
        return torch.as_tensor(ctx.feeds[node.name], device=ctx.device)
    if "default" in node.attrs:
        return _const(node.attrs["default"], node.attrs.get("dtype", "float32"),
                      ctx.device)
    raise KeyError(f"placeholder {node.name!r} was not fed and has no default")


def _eval_matmul(node, ins, ctx):
    return torch.matmul(_cast(ins[0], ctx.compute_dtype),
                        _cast(ins[1], ctx.compute_dtype))


OPS: Dict[str, _OpDef] = {
    "placeholder": _OpDef(_infer_placeholder, _eval_placeholder),
    "constant": _OpDef(lambda n, i: tuple(np.asarray(n.attrs["value"]).shape),
                       lambda n, i, c: _const(n.attrs["value"],
                                              n.attrs.get("dtype", "float32"),
                                              c.device)),
    "dense": _OpDef(_infer_dense, _eval_dense, _params_dense),
    "conv2d": _OpDef(_infer_conv2d, _eval_conv2d, _params_conv2d),
    "max_pool2d": _OpDef(_infer_pool, _eval_pool),
    "avg_pool2d": _OpDef(_infer_pool, _eval_pool),
    "flatten": _OpDef(_infer_flatten,
                      lambda n, i, c: torch.reshape(i[0], (i[0].shape[0], -1))),
    "reshape": _OpDef(_infer_reshape, _eval_reshape),
    "dropout": _OpDef(_infer_elementwise, _eval_dropout),
    "argmax": _OpDef(_infer_argmax,
                     lambda n, i, c: torch.argmax(i[0], dim=n.attrs.get("axis", 1)).float()),
    "add": _OpDef(_infer_broadcast, lambda n, i, c: i[0] + i[1]),
    "subtract": _OpDef(_infer_broadcast, lambda n, i, c: i[0] - i[1]),
    "multiply": _OpDef(_infer_broadcast, lambda n, i, c: i[0] * i[1]),
    "matmul": _OpDef(_infer_matmul, _eval_matmul),
    "concat": _OpDef(_infer_concat,
                     lambda n, i, c: torch.cat(list(i), dim=n.attrs.get("axis", -1))),
    "layer_norm": _OpDef(_infer_elementwise, _eval_layer_norm, _params_layer_norm),
    "batch_norm": _OpDef(_infer_elementwise, _eval_batch_norm, _params_layer_norm),
    "embedding": _OpDef(lambda n, i: tuple(i[0]) + (n.attrs["dim"],),
                        lambda n, i, c, p: p["embedding"][i[0].long()],
                        _params_embedding),
}

for _name, _act in _ACTIVATIONS.items():
    if _name == "identity":
        continue
    OPS[_name] = _OpDef(_infer_elementwise, _simple_eval(_act))

for _name, _fn in _LOSS_EVALS.items():
    OPS[_name] = _OpDef(_infer_loss, _fn)

PARAM_OPS = {name for name, od in OPS.items() if od.params is not None}
LOSS_OPS = set(_LOSS_EVALS)


# ---------------------------------------------------------------------------
# GraphModel: executable init/apply derived from a GraphDef
# ---------------------------------------------------------------------------


class GraphModel:
    """Executable form of a :class:`GraphDef` on one device.

    ``init(generator)`` returns a params tree ``{layer_name: {param_name:
    tensor}}`` in node order (the flat weight-list order of
    :func:`params_to_list`). ``apply(params, feeds, outputs=[...])``
    evaluates only the subgraph the requested tensors need. The surface is
    the registry models' (``device``, ``load_params``, ``resolve``,
    ``loss_vector``), so the trainer and the predict path take either."""

    def __init__(self, graphdef: GraphDef, compute_dtype: Optional[Any] = None,
                 device=None):
        self.graphdef = graphdef
        self.compute_dtype = as_dtype(compute_dtype)
        self.device = resolve_device(device)
        # int8 serving (utils/quant.py): apply() consumes quantized trees
        # when present; 'dynamic' additionally routes dense matmuls through
        # int8 x int8 -> int32. Set by utils.quant.quantize_for_serving()
        # or directly.
        self.quant_mode: Optional[str] = None
        self._shapes: Dict[int, Shape] = {}
        self._tree: Optional[Params] = None
        self._infer_shapes()

    @staticmethod
    def from_json(s: str, compute_dtype: Optional[Any] = None,
                  device=None) -> "GraphModel":
        return GraphModel(GraphDef.from_json(s), compute_dtype, device)

    # -- shapes -------------------------------------------------------------

    def _infer_shapes(self):
        for node in self.graphdef.nodes:
            od = OPS.get(node.op)
            if od is None:
                raise ValueError(f"unknown op {node.op!r} (node {node.name!r})")
            in_shapes = [self._shapes[i] for i in node.inputs]
            self._shapes[node.id] = od.infer(node, in_shapes)

    def tensor_shape(self, tensor_name: str) -> Shape:
        return self._shapes[self.graphdef.resolve(tensor_name)]

    def input_specs(self) -> Dict[str, Tuple[Shape, str]]:
        return {n.name: (tuple(n.attrs["shape"]), n.attrs.get("dtype", "float32"))
                for n in self.graphdef.placeholders()}

    def resolve(self, tensor_name: str) -> int:
        return self.graphdef.resolve(tensor_name)

    # -- params -------------------------------------------------------------

    def param_specs(self) -> Dict[str, Dict[str, Tuple[Shape, str]]]:
        specs = {}
        for node in self.graphdef.nodes:
            od = OPS[node.op]
            if od.params is not None:
                in_shapes = [self._shapes[i] for i in node.inputs]
                specs[node.name] = od.params(node, in_shapes)
        return specs

    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0) -> Params:
        """Draw float32 parameters by their initializers from ``generator``
        (a CPU ``torch.Generator``; default one seeded with ``seed``), so a
        seed gives the same weights on every device; install and return
        them."""
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        tree = {lname: {pname: initialize(init_name, shape, generator).to(self.device)
                        for pname, (shape, init_name) in pspec.items()}
                for lname, pspec in self.param_specs().items()}
        return self.load_params(tree)

    def load_params(self, tree: Params, trainable: bool = False) -> Params:
        """Make ``tree`` the default for ``params=None`` calls; with
        ``trainable`` every leaf requires a gradient (the trainer's tree,
        which its optimizer updates in place). Leaves share storage with
        ``tree``'s tensors."""
        self._tree = {ln: {pn: t.detach().requires_grad_(trainable)
                           for pn, t in layer.items()}
                      for ln, layer in tree.items()}
        return self._tree

    def params(self) -> Params:
        if self._tree is None:
            raise RuntimeError("model has no parameters yet: call init() or "
                               "load_params()")
        return self._tree

    # -- apply --------------------------------------------------------------

    def _needed(self, targets: Sequence[int]) -> List[Node]:
        need = set()
        stack = list(targets)
        while stack:
            nid = stack.pop()
            if nid in need:
                continue
            need.add(nid)
            stack.extend(self.graphdef.nodes[nid].inputs)
        return [n for n in self.graphdef.nodes if n.id in need]

    def apply(self, params: Optional[Params], feeds: Dict[str, Any],
              outputs: Sequence[str], train: bool = False,
              generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Evaluate the graph. ``feeds`` keys may use ':0' suffixes; so may
        outputs. ``train`` turns dropout on, drawn from ``generator`` (a
        ``torch.Generator`` on the model's device)."""
        params = self.params() if params is None else params
        norm_feeds = {k.split(":")[0]: v for k, v in feeds.items()}
        target_ids = [o if isinstance(o, int) else self.graphdef.resolve(o)
                      for o in outputs]
        ctx = _EvalCtx(norm_feeds, train, generator, self.compute_dtype,
                       self.device, self.quant_mode)
        values: Dict[int, Any] = {}
        for node in self._needed(target_ids):
            od = OPS[node.op]
            ins = [values[i] for i in node.inputs]
            if od.params is not None:
                values[node.id] = od.eval(node, ins, ctx, params[node.name])
            else:
                values[node.id] = od.eval(node, ins, ctx)
        return {o: values[t] for o, t in zip(outputs, target_ids)}

    def quantize_for_serving(self, params, mode: str = "weight_only",
                             min_size: int = 4096):
        """int8-quantize a trained params tree for inference and set this
        model to serve it (``utils/quant.py``). Returns the quantized tree;
        training must keep the original full-precision params."""
        from .utils.quant import quantize_for_serving
        return quantize_for_serving(self, params, mode, min_size)

    def loss_vector(self, params: Optional[Params], feeds: Dict[str, Any],
                    train: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-example total loss (sum of registered losses), shape [batch]."""
        if not self.graphdef.losses:
            raise ValueError("graph has no registered losses; use a loss op from "
                             "sparkflow_tpu_torch.nn (softmax_cross_entropy, "
                             "mean_squared_error, ...)")
        outs = self.apply(params, feeds, self.graphdef.losses, train=train,
                          generator=generator)
        vals = list(outs.values())
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return total
