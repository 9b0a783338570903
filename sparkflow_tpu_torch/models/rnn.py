"""Recurrent models (LSTM / GRU) — the port of the JAX package's
``models/rnn.py``: ``rnn_classifier`` (uni- or bi-directional encoder and
a softmax head) and ``rnn_lm`` (next-token LM with tied embeddings).

The JAX ``lax.scan`` over time is a Python loop here. Numerics follow the
JAX model:

- each step is one fused gate product ``[B, D+H] @ [D+H, G*H]`` (G = 4 for
  the LSTM, 3 for the GRU) of operands in the compute dtype with a float32
  result (JAX's ``preferred_element_type``): the compute-dtype operands are
  widened to float32 and multiplied with TF32 off, in the forward and the
  backward (``torch.matmul`` of two bf16 tensors would round to bf16);
- the hidden and cell state stay float32;
- the LSTM's forget gate gets +1 (Jozefowicz et al.);
- the GRU's candidate is ``tanh(n_x - h_n + r * h_n)``, ``n_x`` the fused
  product's n-slice (the n-bias on the input side) and ``h_n`` the hidden
  state's share of it. That is neither ``torch.nn.GRU``'s nor cuDNN's bias
  placement, so the library RNNs do not compute this function;
- padded steps (``attention_mask`` 0) carry the state through unchanged, so
  the final state is the last valid step's;
- the reverse direction flips the sequence and the mask, layer by layer;
- dropout follows every layer, drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graphdef import _NoTF32
from ..sharding import P
from .base import Params, RegistryModel, softmax_xent
from .registry import register_model


class _Matmul32(torch.autograd.Function):
    """``a @ b`` of float32 2-D operands with TF32 off in the forward and
    in the backward (autograd runs the backward outside any context the
    forward set)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _NoTF32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, gy):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _NoTF32():
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(gy, b.t())
            if ctx.needs_input_grad[1]:
                gb = torch.matmul(a.t(), gy)
        return ga, gb


def _matmul_f32(a, b):
    """Product of compute-dtype operands with a float32 result."""
    return _Matmul32.apply(a.float(), b.to(a.dtype).float())


def _gate_matmul(xh, kernel, bias):
    """``[B, D+H] @ [D+H, G*H]`` in the compute dtype, float32 result."""
    return _matmul_f32(xh, kernel) + bias.float()


def _lstm_scan(x, mask, h, c, kernel, bias):
    """``x`` [S,B,D], ``mask`` [S,B,1] or None -> (ys [S,B,H] f32, h, c)."""
    ys = []
    for t in range(x.shape[0]):
        xt = x[t]
        gates = _gate_matmul(torch.cat([xt, h.to(xt.dtype)], -1), kernel,
                             bias)
        i, f, g, o = gates.chunk(4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + 1.0)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if mask is not None:
            keep = mask[t] > 0
            c_new = torch.where(keep, c_new, c)
            h_new = torch.where(keep, h_new, h)
        h, c = h_new, c_new
        ys.append(h)
    return torch.stack(ys), h, c


def _gru_scan(x, mask, h, kernel, bias):
    """``x`` [S,B,D] -> (ys [S,B,H] f32, h). Gate layout [z, r, n]."""
    hdim = h.shape[-1]
    xdim = x.shape[-1]
    w_hn = kernel[xdim:, 2 * hdim:]
    ys = []
    for t in range(x.shape[0]):
        xt = x[t]
        hx = h.to(xt.dtype)
        zr_n = _gate_matmul(torch.cat([xt, hx], -1), kernel, bias)
        z = torch.sigmoid(zr_n[..., :hdim])
        r = torch.sigmoid(zr_n[..., hdim:2 * hdim])
        n_x = zr_n[..., 2 * hdim:]           # holds the hidden's share too
        h_n = _matmul_f32(hx, w_hn)
        n = torch.tanh(n_x - h_n + r * h_n)
        h_new = (1.0 - z) * n + z * h
        if mask is not None:
            h_new = torch.where(mask[t] > 0, h_new, h)
        h = h_new
        ys.append(h)
    return torch.stack(ys), h


class _RNNBase(RegistryModel):
    """Embedding and the stacked recurrence shared by both families."""

    def __init__(self, vocab_size: int, hidden: int = 512,
                 num_layers: int = 2, max_len: int = 128,
                 cell: str = "lstm", dropout: float = 0.0,
                 embed_dim: Optional[int] = None, compute_dtype=None,
                 device=None):
        if cell not in ("lstm", "gru"):
            raise ValueError(f"cell must be 'lstm' or 'gru', got {cell!r}")
        super().__init__(compute_dtype, device)
        self.vocab_size = int(vocab_size)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.max_len = int(max_len)
        self.cell = cell
        self.dropout = float(dropout)
        self.embed_dim = int(embed_dim or hidden)

    @property
    def _gates(self) -> int:
        return 4 if self.cell == "lstm" else 3

    def input_specs(self):
        return {"input_ids": ((None, self.max_len), "int32"),
                "attention_mask": ((None, self.max_len), "float32")}

    def _layer_specs(self, in_dim):
        g, h = self._gates, self.hidden
        return {"kernel": ((in_dim + h, g * h), "normal(0.02)"),
                "bias": ((g * h,), "zeros")}

    def param_specs(self):
        specs = {"embed": {"tok": ((self.vocab_size, self.embed_dim),
                                   "normal(0.02)")}}
        in_dim = self.embed_dim
        for i in range(self.num_layers):
            specs[f"layer_{i}"] = self._layer_specs(in_dim)
            in_dim = self.hidden
        return specs

    def param_pspecs(self):
        # recurrent kernels replicated by design, as in the JAX package
        return {name: {k: P() for k in layer}
                for name, layer in self.param_specs().items()}

    def _dropout(self, x, train: bool, generator: Optional[torch.Generator]):
        if not train or self.dropout <= 0.0:
            return x
        keep = 1.0 - self.dropout
        m = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(m, x / keep, 0.0).to(x.dtype)

    def _run_layer(self, lp, x, mask, reverse: bool = False):
        """``x`` [S,B,D] -> (ys [S,B,H] in x's dtype, h_last [B,H] f32)."""
        if reverse:
            x = x.flip(0)
            mask = mask.flip(0) if mask is not None else None
        h0 = torch.zeros((x.shape[1], self.hidden), dtype=torch.float32,
                         device=x.device)
        if self.cell == "lstm":
            ys, h, _ = _lstm_scan(x, mask, h0, h0, lp["kernel"], lp["bias"])
        else:
            ys, h = _gru_scan(x, mask, h0, lp["kernel"], lp["bias"])
        if reverse:
            ys = ys.flip(0)
        return ys.to(x.dtype), h

    def _encode(self, params: Params, feeds, train: bool,
                generator: Optional[torch.Generator], suffix: str = "",
                reverse: bool = False):
        """The stacked recurrence over ``layer_{i}{suffix}``: ``(ys [S,B,H]
        in the compute dtype, h_last [B,H] f32)``."""
        ids = torch.as_tensor(feeds["input_ids"], device=self.device).long()
        mask = feeds.get("attention_mask")
        x = self.cast(params["embed"]["tok"][ids]).transpose(0, 1)  # [S,B,D]
        m = None
        if mask is not None:
            m = torch.as_tensor(mask, device=self.device).t()[:, :, None]
            m = m.float()
        h_last = None
        for i in range(self.num_layers):
            x, h_last = self._run_layer(params[f"layer_{i}{suffix}"], x, m,
                                        reverse=reverse)
            x = self._dropout(x, train, generator)
        return x, h_last


@register_model("rnn_classifier")
class RNNClassifier(_RNNBase):
    """Uni- or bi-directional recurrent encoder and a softmax head over the
    last valid hidden state (and, bidirectional, the reverse direction's
    final state)."""

    TENSORS = ("input_ids", "attention_mask", "y", "logits", "probs", "pred")

    def __init__(self, vocab_size: int, num_classes: int,
                 bidirectional: bool = False, **kw):
        super().__init__(vocab_size, **kw)
        self.num_classes = int(num_classes)
        self.bidirectional = bool(bidirectional)

    def input_specs(self):
        specs = super().input_specs()
        specs["y"] = ((None, self.num_classes), "float32")
        return specs

    def param_specs(self):
        specs = super().param_specs()
        if self.bidirectional:
            in_dim = self.embed_dim
            for i in range(self.num_layers):
                specs[f"layer_{i}_rev"] = self._layer_specs(in_dim)
                in_dim = self.hidden
        feat = self.hidden * (2 if self.bidirectional else 1)
        specs["head"] = {"kernel": ((feat, self.num_classes), "normal(0.02)"),
                         "bias": ((self.num_classes,), "zeros")}
        return specs

    def _forward(self, params: Params, feeds, train: bool = False,
                 generator: Optional[torch.Generator] = None):
        _, h = self._encode(params, feeds, train, generator)
        if self.bidirectional:
            _, h_rev = self._encode(params, feeds, train, generator,
                                    suffix="_rev", reverse=True)
            h = torch.cat([h, h_rev], -1)
        logits = (torch.matmul(h, params["head"]["kernel"].float())
                  + params["head"]["bias"].float())
        return {"logits": logits, "probs": torch.softmax(logits, -1),
                "pred": logits.argmax(-1).float()}

    def _loss(self, params: Params, feeds, train: bool = True,
              generator: Optional[torch.Generator] = None):
        logits = self._forward(params, feeds, train, generator)["logits"]
        return softmax_xent(logits, feeds["y"])


@register_model("rnn_lm")
class RNNLM(_RNNBase):
    """Next-token recurrent LM with tied input and output embeddings; the
    loss weights positions by ``attention_mask`` per example."""

    TENSORS = ("input_ids", "attention_mask", "logits", "pred")

    def __init__(self, vocab_size: int, **kw):
        super().__init__(vocab_size, **kw)
        if self.embed_dim != self.hidden:
            raise ValueError("rnn_lm ties embeddings: embed_dim must equal "
                             f"hidden ({self.embed_dim} != {self.hidden})")

    def _forward(self, params: Params, feeds, train: bool = False,
                 generator: Optional[torch.Generator] = None):
        ys, _ = self._encode(params, feeds, train, generator)     # [S,B,H]
        x = ys.transpose(0, 1).float()
        logits = torch.matmul(x, params["embed"]["tok"].float().t())
        return {"logits": logits, "pred": logits.argmax(-1).float()}

    def _loss(self, params: Params, feeds, train: bool = True,
              generator: Optional[torch.Generator] = None):
        logits = self._forward(params, feeds, train, generator)["logits"]
        ids = torch.as_tensor(feeds["input_ids"], device=self.device).long()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        tok_ll = logp.gather(-1, ids[:, 1:, None])[..., 0]
        mask = feeds.get("attention_mask")
        if mask is not None:
            w = torch.as_tensor(mask, device=self.device)[:, 1:].float()
        else:
            w = torch.ones_like(tok_ll)
        return -(tok_ll * w).sum(-1) / w.sum(-1).clamp_min(1e-6)


__all__ = ["RNNClassifier", "RNNLM"]
