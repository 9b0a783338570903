"""ResNet family (v1.5 bottleneck, group norm) — the port of the JAX
package's ``models/resnet.py``.

``build_registry_spec('resnet50', num_classes=10, image_size=32)`` is the
repo's "ResNet-50 / CIFAR-10" configuration; ``resnet`` takes ``depth`` 18,
34, 50 or 101 and a base ``width``.

Same parameter names and layouts as the JAX model: conv kernels stay HWIO
(``[kh, kw, cin, cout]``), so weights carry across unchanged
(:mod:`sparkflow_tpu_torch.convert`). Numerics follow the JAX model:

- the convolutions run NCHW through the graph runtime's ``_conv2d``, with
  TF32 off in the forward and the backward (cuDNN would run a float32
  convolution in TF32 by default; the JAX convolution is float32);
- ``SAME`` padding is TF's, odd element after: a stride-2 3x3 on 32 pixels
  pads (0, 1), the 7x7/2 ImageNet stem on 224 pads (2, 3) — explicit pads,
  not ``F.conv2d(padding=...)``;
- group norm in float32 with eps 1e-5, ``min(32, C)`` groups lowered until
  they divide ``C``;
- the CIFAR stem (3x3, stride 1) when ``image_size <= 64``, else the
  ImageNet stem (7x7, stride 2) and a 3x3/2 ``SAME`` max-pool padded with
  ``-inf``;
- a flattened Spark vector ``x`` [B, H*W*C] is read as NHWC;
- the head is a float32 spatial mean and a float32 matmul.

Like the JAX model, a ResNet does not serve int8 trees.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..graphdef import _conv2d, _pad_nchw
from .base import Params, RegistryModel, softmax_xent
from .registry import register_model

_STAGES = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
           50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True)}


def _conv(x, kernel, stride: int = 1):
    """``SAME`` convolution of NCHW ``x`` by an HWIO ``kernel``."""
    kh, kw = int(kernel.shape[0]), int(kernel.shape[1])
    xp = _pad_nchw(x, kh, kw, stride, stride, "SAME")
    return _conv2d(xp, kernel.to(x.dtype).permute(3, 2, 0, 1),
                   (stride, stride))


def _group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    b, c, h, w = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    x32 = x.float().reshape(b, g, c // g, h, w)
    mean = x32.mean(dim=(2, 3, 4), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return (y * scale[:, None, None] + bias[:, None, None]).to(x.dtype)


def _max_pool_same(x):
    """3x3 stride-2 ``SAME`` max-pool, padded with ``-inf``."""
    xp = _pad_nchw(x, 3, 3, 2, 2, "SAME", value=float("-inf"))
    return F.max_pool2d(xp, 3, 2)


@register_model("resnet")
class ResNet(RegistryModel):
    """Residual network over NHWC images ``x`` (or flattened vectors) with a
    softmax head."""

    TENSORS = ("x", "y", "logits", "probs", "pred")

    def __init__(self, num_classes: int, depth: int = 50,
                 image_size: int = 32, channels: int = 3, width: int = 64,
                 compute_dtype=None, device=None):
        if depth not in _STAGES:
            raise ValueError(f"depth must be one of {sorted(_STAGES)}")
        super().__init__(compute_dtype, device)
        self.num_classes = int(num_classes)
        self.depth = int(depth)
        self.image_size = int(image_size)
        self.channels = int(channels)
        self.width = int(width)
        self.stages, self.bottleneck = _STAGES[depth]

    # -- specs ----------------------------------------------------------------

    def input_specs(self):
        n = self.image_size
        return {"x": ((None, n, n, self.channels), "float32"),
                "y": ((None, self.num_classes), "float32")}

    def _block_channels(self) -> List[Tuple[str, int, int, int]]:
        """(name, cin, cmid, stride) per block, stage by stage."""
        blocks = []
        expansion = 4 if self.bottleneck else 1
        cin = self.width
        for si, n_blocks in enumerate(self.stages):
            cmid = self.width * (2 ** si)
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append((f"stage{si}_block{bi}", cin, cmid, stride))
                cin = cmid * expansion
        return blocks

    def param_specs(self):
        k = 3 if self.image_size <= 64 else 7  # CIFAR stem vs ImageNet stem
        specs = {"stem": {"kernel": ((k, k, self.channels, self.width),
                                     "he_normal"),
                          "gn_scale": ((self.width,), "ones"),
                          "gn_bias": ((self.width,), "zeros")}}
        expansion = 4 if self.bottleneck else 1
        for name, cin, cmid, stride in self._block_channels():
            cout = cmid * expansion
            if self.bottleneck:
                layer = {
                    "conv1": ((1, 1, cin, cmid), "he_normal"),
                    "gn1_scale": ((cmid,), "ones"),
                    "gn1_bias": ((cmid,), "zeros"),
                    "conv2": ((3, 3, cmid, cmid), "he_normal"),
                    "gn2_scale": ((cmid,), "ones"),
                    "gn2_bias": ((cmid,), "zeros"),
                    "conv3": ((1, 1, cmid, cout), "he_normal"),
                    "gn3_scale": ((cout,), "ones"),
                    "gn3_bias": ((cout,), "zeros"),
                }
            else:
                layer = {
                    "conv1": ((3, 3, cin, cmid), "he_normal"),
                    "gn1_scale": ((cmid,), "ones"),
                    "gn1_bias": ((cmid,), "zeros"),
                    "conv2": ((3, 3, cmid, cout), "he_normal"),
                    "gn2_scale": ((cout,), "ones"),
                    "gn2_bias": ((cout,), "zeros"),
                }
            if stride != 1 or cin != cout:
                layer["proj"] = ((1, 1, cin, cout), "he_normal")
                layer["gnp_scale"] = ((cout,), "ones")
                layer["gnp_bias"] = ((cout,), "zeros")
            specs[name] = layer
        cfinal = self.width * (2 ** (len(self.stages) - 1)) * expansion
        specs["head"] = {"kernel": ((cfinal, self.num_classes), "zeros"),
                         "bias": ((self.num_classes,), "zeros")}
        return specs

    # -- forward ----------------------------------------------------------------

    @staticmethod
    def _bottleneck_block(bp, x, stride):
        y = F.relu(_group_norm(_conv(x, bp["conv1"]), bp["gn1_scale"],
                               bp["gn1_bias"]))
        y = F.relu(_group_norm(_conv(y, bp["conv2"], stride),
                               bp["gn2_scale"], bp["gn2_bias"]))
        y = _group_norm(_conv(y, bp["conv3"]), bp["gn3_scale"],
                        bp["gn3_bias"])
        if "proj" in bp:
            x = _group_norm(_conv(x, bp["proj"], stride), bp["gnp_scale"],
                            bp["gnp_bias"])
        return F.relu(x + y)

    @staticmethod
    def _basic_block(bp, x, stride):
        y = F.relu(_group_norm(_conv(x, bp["conv1"], stride),
                               bp["gn1_scale"], bp["gn1_bias"]))
        y = _group_norm(_conv(y, bp["conv2"]), bp["gn2_scale"],
                        bp["gn2_bias"])
        if "proj" in bp:
            x = _group_norm(_conv(x, bp["proj"], stride), bp["gnp_scale"],
                            bp["gnp_bias"])
        return F.relu(x + y)

    def _forward(self, params: Params, feeds, train: bool = False,
                 generator: Optional[torch.Generator] = None):
        x = self.cast(torch.as_tensor(feeds["x"], device=self.device))
        n = self.image_size
        if x.dim() == 2:  # flattened Spark vector column, NHWC order
            x = x.reshape(x.shape[0], n, n, self.channels)
        x = x.permute(0, 3, 1, 2)                                 # NCHW
        sp = params["stem"]
        x = F.relu(_group_norm(_conv(x, sp["kernel"], 1 if n <= 64 else 2),
                               sp["gn_scale"], sp["gn_bias"]))
        if n > 64:
            x = _max_pool_same(x)
        block = self._bottleneck_block if self.bottleneck else self._basic_block
        for name, _cin, _cmid, stride in self._block_channels():
            x = block(params[name], x, stride)
        pooled = x.float().mean(dim=(2, 3))
        logits = (torch.matmul(pooled, params["head"]["kernel"].float())
                  + params["head"]["bias"].float())
        return {"logits": logits, "probs": torch.softmax(logits, -1),
                "pred": logits.argmax(-1).float()}

    def _loss(self, params: Params, feeds, train: bool = True,
              generator: Optional[torch.Generator] = None):
        logits = self._forward(params, feeds, train, generator)["logits"]
        return softmax_xent(logits, feeds["y"])


@register_model("resnet50")
class ResNet50(ResNet):
    """``resnet`` at depth 50 and the default width 64."""

    def __init__(self, num_classes: int, image_size: int = 32,
                 channels: int = 3, compute_dtype=None, device=None):
        super().__init__(num_classes, depth=50, image_size=image_size,
                         channels=channels, compute_dtype=compute_dtype,
                         device=device)


__all__ = ["ResNet", "ResNet50"]
