"""Graph-DSL preset builders for the reference's three example architectures,
and the MoE LM's serving preset — carried from the JAX package's
``models/presets.py``: each builder returns the same JSON string as its JAX
twin for the same arguments.

The graph builders return ``build_graph`` JSON, so they flow through the
Estimator exactly like hand-written model functions (reference
``examples/*.py``)."""

from __future__ import annotations

from typing import Sequence

from .. import nn
from ..graph_utils import build_graph
from .registry import build_registry_spec


def mlp(input_dim: int, num_classes: int, hidden: Sequence[int] = (256, 256),
        activation: str = "relu") -> str:
    """The simple_dnn.py MLP shape (reference examples/simple_dnn.py:13-22)."""

    def model():
        x = nn.placeholder([None, input_dim], name="x")
        y = nn.placeholder([None, num_classes], name="y")
        h = x
        for units in hidden:
            h = nn.dense(h, units, activation=activation)
        out = nn.dense(h, num_classes, name="out")
        nn.argmax(out, 1, name="pred")
        nn.softmax_cross_entropy(y, out)

    return build_graph(model)


def cnn(side: int = 28, channels: int = 1, num_classes: int = 10) -> str:
    """The cnn_example.py conv net (reference examples/cnn_example.py:10-22)."""

    def model():
        x = nn.placeholder([None, side * side * channels], name="x")
        y = nn.placeholder([None, num_classes], name="y")
        xr = nn.reshape(x, [-1, side, side, channels])
        c1 = nn.conv2d(xr, 32, 5, activation="relu")
        p1 = nn.max_pooling2d(c1, 2, 2)
        c2 = nn.conv2d(p1, 64, 3, activation="relu")
        p2 = nn.max_pooling2d(c2, 2, 2)
        out = nn.dense(nn.flatten(p2), num_classes, name="out")
        nn.argmax(out, 1, name="pred")
        nn.softmax_cross_entropy(y, out)

    return build_graph(model)


def autoencoder(input_dim: int = 784,
                widths: Sequence[int] = (256, 128, 256)) -> str:
    """The autoencoder_example.py stack; bottleneck exposed as 'out/Sigmoid:0'
    (reference examples/autoencoder_example.py:9-16)."""
    mid = len(widths) // 2

    def model():
        x = nn.placeholder([None, input_dim], name="x")
        h = x
        for i, w in enumerate(widths):
            name = "out" if i == mid else None
            act = "sigmoid" if i == mid else "relu"
            h = nn.dense(h, w, activation=act, name=name)
        recon = nn.dense(h, input_dim, activation="sigmoid")
        nn.mean_squared_error(recon, x)

    return build_graph(model)


def moe_lm(vocab_size: int, *, hidden: int = 256, num_layers: int = 4,
           num_heads: int = 8, mlp_dim: int = 1024, max_len: int = 512,
           num_experts: int = 8, router_top_k: int = 2, moe_every: int = 2,
           capacity_factor: float = 1.25, dropout: float = 0.0) -> str:
    """Registry spec for a mixture-of-experts decoder LM sized for serving.

    The defaults keep ``num_experts`` divisible across an ``('ep',)`` mesh
    mesh and ``num_heads`` divisible across a ``('tp',)`` mesh (the JAX
    package's expert- and tensor-parallel decode; this package serves it on
    one card). Returns registry JSON for ``model_from_json`` — NOT
    graph-DSL JSON like the builders above."""
    return build_registry_spec(
        "transformer_moe_lm", vocab_size=vocab_size, hidden=hidden,
        num_layers=num_layers, num_heads=num_heads, mlp_dim=mlp_dim,
        max_len=max_len, num_experts=num_experts, router_top_k=router_top_k,
        moe_every=moe_every, capacity_factor=capacity_factor, dropout=dropout)
