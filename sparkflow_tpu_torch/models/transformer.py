"""Transformer models — the port of the JAX package's
``models/transformer.py``: ``TransformerLM`` (causal decoder) and
``TransformerClassifier`` (encoder + mean-pool head).

Same architecture, parameter names and layouts (``qkv_kernel [h, 3h]``,
``o_kernel [h, h]``, ...), so weights carry across without transposes
(:mod:`sparkflow_tpu_torch.convert`). Numerics follow the JAX models:

- layer norm computes in float32 with eps 1e-6 (not ``nn.LayerNorm``'s 1e-5);
- a dense layer casts its kernel to the activation's dtype (bf16 on the card
  with ``compute_dtype=bfloat16``), parameters themselves stay float32;
  every projection goes through ``_proj``, which also serves an
  int8-quantized tree (``*_kernel_q8`` + ``*_kernel_scale``,
  :func:`~sparkflow_tpu_torch.utils.quant.quantize_params`) in the model's
  ``quant_mode`` and casts the result back to the activation's dtype;
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- the tied-embedding head and the classifier head run in float32;
- positions are clipped to ``max_len - 1``;
- training applies dropout after the O projection and after fc2,
  ``where(keep, x / keep_prob, 0)``, drawn from an explicit
  ``torch.Generator`` on the model's device.

Full-sequence attention is :func:`~sparkflow_tpu_torch.ops.flash_attention`
(the CUDA kernels on the card, forward and backward); decode attention is
delegated to an ``attend`` callback — the dense cache below for parity, the
serving engine's paged pool over
:func:`~sparkflow_tpu_torch.ops.paged_attention` in production.
``remat=True`` / ``"full"`` recomputes each block in the backward
(``torch.utils.checkpoint``); ``remat="dots"`` saves the outputs of the
block's 2-D weight products (``mm`` / ``addmm`` over the flattened tokens)
and recomputes the rest, the flash forward included — JAX's
``dots_with_no_batch_dims_saveable`` policy, which saves no batched product
and no Pallas call. :meth:`TransformerLM.decode_verify` scores a drafted
token block at every position (speculative decoding), and the dense decode
cache takes int8/fp8 rows (``init_decode_cache(kv_dtype=)``). Model
parallelism (``tp_axis``, ``ep_axis``, ``sp_axis``) is not yet ported and
raises.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..ops import flash_attention
from ..utils import quant
from .base import Params, RegistryModel, softmax_xent
from .registry import register_model

NEG_INF = -1e30


def _layer_norm(x, scale, bias, eps=1e-6):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


def _dense(x, kernel, bias=None):
    y = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _not_yet(what: str):
    raise ValueError(f"{what} is not yet ported to PyTorch (see ROADMAP.md)")


# remat="dots": the weight products' outputs are kept, everything else is
# recomputed in the backward
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _save_weight_products)


class _TransformerBase(RegistryModel):
    """Embedding, blocks and specs shared by the LM and the classifier."""

    def __init__(self, vocab_size: int, hidden: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 dropout: float = 0.1, remat=False,
                 sp_axis: Optional[str] = None, compute_dtype=None,
                 device=None):
        if remat not in (False, True, "full", "dots"):
            raise ValueError(
                f"remat must be False, True/'full', or 'dots'; got {remat!r}")
        if sp_axis is not None:
            _not_yet("sequence parallelism (sp_axis)")
        super().__init__(compute_dtype, device)
        self.vocab_size = int(vocab_size)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.hidden // self.num_heads
        self.mlp_dim = int(mlp_dim)
        self.max_len = int(max_len)
        self.dropout = float(dropout)  # training only; serving ignores it
        self.remat = remat

    # -- specs ---------------------------------------------------------------

    def input_specs(self):
        return {"input_ids": ((None, self.max_len), "int32"),
                "attention_mask": ((None, self.max_len), "float32")}

    def _block_specs(self):
        h, m = self.hidden, self.mlp_dim
        return {
            "ln1_scale": ((h,), "ones"), "ln1_bias": ((h,), "zeros"),
            "qkv_kernel": ((h, 3 * h), "normal(0.02)"),
            "qkv_bias": ((3 * h,), "zeros"),
            "o_kernel": ((h, h), "normal(0.02)"), "o_bias": ((h,), "zeros"),
            "ln2_scale": ((h,), "ones"), "ln2_bias": ((h,), "zeros"),
            "fc1_kernel": ((h, m), "normal(0.02)"),
            "fc1_bias": ((m,), "zeros"),
            "fc2_kernel": ((m, h), "normal(0.02)"),
            "fc2_bias": ((h,), "zeros"),
        }

    def param_specs(self):
        h = self.hidden
        specs = {"embed": {"tok": ((self.vocab_size, h), "normal(0.02)"),
                           "pos": ((self.max_len, h), "normal(0.02)")}}
        for i in range(self.num_layers):
            specs[f"block_{i}"] = self._block_specs()
        specs["final_ln"] = {"scale": ((h,), "ones"), "bias": ((h,), "zeros")}
        return specs

    # -- blocks --------------------------------------------------------------

    @staticmethod
    def _check_axes(tp_axis, ep_axis):
        if tp_axis is not None:
            _not_yet("tensor parallelism (tp_axis)")
        if ep_axis is not None:
            _not_yet("expert parallelism (ep_axis)")

    SUPPORTS_INT8_SERVING = True

    def _proj(self, p, base: str, x):
        """Dense projection through ``p[f'{base}kernel']``, or through its
        int8-quantized form (``{base}kernel_q8``) when the serving tree came
        from ``quantize_params``. The result is cast back to ``x``'s dtype:
        the dynamic path rescales in float32, and without the cast a bf16
        model's residual stream would promote to float32."""
        if f"{base}kernel_q8" in p:
            return quant.quantized_dense(
                x, p, self.quant_mode or "weight_only", compute_dtype=x.dtype,
                prefix=f"{base}kernel").to(x.dtype)
        return _dense(x, p[f"{base}kernel"], p.get(f"{base}bias"))

    def _dropout(self, x, train: bool, generator: Optional[torch.Generator]):
        if not train or self.dropout <= 0.0:
            return x
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)

    def _qkv(self, bp, x):
        """ln1 + qkv projection of ``x`` [B,S,hidden] -> q, k, v views
        [B,heads,S,d] of ONE [3,B,heads,S,d] permutation (no copies)."""
        b, s, _ = x.shape
        y = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
        qkv = self._proj(bp, "qkv_", y)
        qkv = qkv.view(b, s, 3, self.num_heads, self.head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2]

    def _mlp(self, bp, y, mask=None):
        """The block's feed-forward half on ``y`` [B,S,hidden] (after ln2):
        ``(out, aux)``. Dense blocks add no auxiliary loss (``aux`` None);
        the MoE mixin overrides this for its expert layers, where ``mask``
        [B,S] marks the tokens that may claim expert capacity."""
        y = _gelu(self._proj(bp, "fc1_", y))
        return self._proj(bp, "fc2_", y), None

    def _finish_block(self, bp, x, att, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      mask=None):
        """O-projection + residual + MLP on ``att`` [B,S,heads*d], with
        dropout after the O projection and after the MLP when training:
        ``(x, aux)`` (see :meth:`_mlp`)."""
        x = x + self._dropout(self._proj(bp, "o_", att),
                              train, generator)
        y = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
        y, aux = self._mlp(bp, y, mask)
        return x + self._dropout(y, train, generator), aux

    def _block(self, bp, x, mask, causal, attention=None, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """Full-sequence block: ``(x, k, v, aux)`` with k/v
        [B,heads,S,d]; ``mask`` is the key-padding mask and the MLP's live
        tokens."""
        b, s, _ = x.shape
        q, k, v = self._qkv(bp, x)
        attend = flash_attention if attention is None else attention
        att = attend(q, k, v, causal=causal, kv_mask=mask)
        att = att.transpose(1, 2).reshape(b, s, -1)
        x, aux = self._finish_block(bp, x, att, train, generator, mask)
        return x, k, v, aux

    def _block_decode(self, bp, x, layer, cache, pos, attend):
        """One block on a single token ``x`` [B,1,hidden]; attention over
        the cached history is ``attend``'s (see :meth:`decode_step`)."""
        b = x.shape[0]
        y = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
        qkv = self._proj(bp, "qkv_", y)
        qkv = qkv.view(b, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]           # [B, heads, d]
        att, cache = attend(layer, q, k, v, cache, pos)
        return self._finish_block(bp, x, att.reshape(b, 1, -1))[0], cache

    def _block_suffix(self, bp, x, layer, cache, start, attend):
        """One block on a prompt suffix ``x`` [B,S,hidden] starting at
        absolute position ``start`` [B]; ``attend(layer, q, k, v, cache,
        start)`` with q/k/v [B,heads,S,d] owns the history."""
        b, s, _ = x.shape
        q, k, v = self._qkv(bp, x)
        att, cache = attend(layer, q, k, v, cache, start)
        att = att.transpose(1, 2).reshape(b, s, -1)
        return self._finish_block(bp, x, att)[0], cache

    def _remat_block(self, bp, x, mask, causal, attention, train, generator):
        """One block under ``torch.utils.checkpoint``: ``(x, aux)``, its
        activations recomputed in the backward, all of them (``remat`` True
        / "full") or all but the weight products' outputs ("dots", a
        selective checkpoint policy). Dropout must draw the same masks
        twice, so the block draws from a generator rebuilt from
        ``generator``'s state before the block, and ``generator`` then moves
        past the block's draws as if it had drawn them itself."""
        state = (generator.get_state() if train and self.dropout > 0.0
                 and generator is not None else None)
        after = {}

        def run(x):
            g = None
            if state is not None:
                g = torch.Generator(device=x.device)
                g.set_state(state)
            y, _, _, aux = self._block(bp, x, mask, causal, attention, train,
                                       g)
            if g is not None:
                after["state"] = g.get_state()
            return y, aux

        x, aux = checkpoint(run, x, use_reentrant=False, context_fn=(
            _DOTS_CONTEXT if self.remat == "dots" else noop_context_fn))
        if state is not None:
            generator.set_state(after["state"])
        return x, aux

    def _encode(self, params: Params, feeds, causal: bool,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                attention: Optional[Callable] = None):
        """Embeddings and every block over ``feeds["input_ids"]`` [B,S],
        then the final layer norm: ``(x [B,S,hidden], mask, aux)``; the
        optional ``attention_mask`` [B,S] is the key-padding mask of every
        block, and ``aux`` the float32 sum of the blocks' auxiliary losses
        (zero for a dense model)."""
        ids = torch.as_tensor(feeds["input_ids"], device=self.device).long()
        mask = feeds.get("attention_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        x = self.prefill_embed(params, ids)
        remat = self.remat and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(self.num_layers):
            bp = params[f"block_{i}"]
            if remat:
                x, aux = self._remat_block(bp, x, mask, causal, attention,
                                           train, generator)
            else:
                x, _, _, aux = self._block(bp, x, mask, causal, attention,
                                           train, generator)
            if aux is not None:
                aux_total = aux_total + aux
        return _layer_norm(x, params["final_ln"]["scale"],
                           params["final_ln"]["bias"]), mask, aux_total

    def prefill_embed(self, params, ids):
        emb = params["embed"]
        s = ids.shape[1]
        return self.cast(emb["tok"][ids.long()] + emb["pos"][:s][None])


@register_model("transformer_classifier")
class TransformerClassifier(_TransformerBase):
    """BERT-class encoder + mean-pool classification head (non-causal,
    key-padding mask honoured, softmax cross-entropy loss)."""

    TENSORS = ("input_ids", "attention_mask", "y", "logits", "probs", "pred")

    def __init__(self, vocab_size: int, num_classes: int, **kw):
        super().__init__(vocab_size, **kw)
        self.num_classes = int(num_classes)

    def input_specs(self):
        specs = super().input_specs()
        specs["y"] = ((None, self.num_classes), "float32")
        return specs

    def param_specs(self):
        specs = super().param_specs()
        specs["head"] = {"kernel": ((self.hidden, self.num_classes),
                                    "normal(0.02)"),
                         "bias": ((self.num_classes,), "zeros")}
        return specs

    def _forward(self, params: Params, feeds, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 attention: Optional[Callable] = None):
        x, mask, _ = self._encode(params, feeds, False, train, generator,
                                  attention)
        if mask is not None:
            w = mask[:, :, None].to(x.dtype)
            pooled = (x * w).sum(1) / w.sum(1).clamp_min(1e-6)
        else:
            pooled = x.mean(1)
        logits = self._proj(params["head"], "", pooled.float())
        return {"logits": logits, "probs": torch.softmax(logits, -1),
                "pred": logits.argmax(-1).float()}

    def _loss(self, params: Params, feeds, train: bool = True,
              generator: Optional[torch.Generator] = None, **kw):
        logits = self._forward(params, feeds, train, generator, **kw)["logits"]
        return softmax_xent(logits, feeds["y"])


@register_model("transformer_lm")
class TransformerLM(_TransformerBase):
    """Causal decoder LM (next-token prediction)."""

    TENSORS = ("input_ids", "attention_mask", "logits", "pred")

    # -- embed / head ----------------------------------------------------------

    def decode_embed(self, params, token, pos):
        """``token``/``pos`` [B] -> [B, 1, hidden] in compute dtype."""
        emb = params["embed"]
        x = emb["tok"][token.long()]
        posemb = emb["pos"][pos.long().clamp(0, self.max_len - 1)]
        return self.cast(x + posemb)[:, None, :]

    def suffix_embed(self, params, ids, start):
        """``ids`` [B,S] whose first token sits at ``start`` [B]."""
        emb = params["embed"]
        s = ids.shape[1]
        pos = start.long()[:, None] + torch.arange(s, device=ids.device)
        x = emb["tok"][ids.long()]
        return self.cast(x + emb["pos"][pos.clamp(0, self.max_len - 1)])

    def head_all(self, params, x):
        """Final LN + tied head at every position -> [B,S,vocab] f32."""
        x = _layer_norm(x, params["final_ln"]["scale"],
                        params["final_ln"]["bias"])
        return torch.matmul(x.float(), params["embed"]["tok"].float().t())

    def decode_head(self, params, x):
        return self.head_all(params, x)[:, 0]

    def head_last(self, params, x, lengths=None):
        """Final LN + tied head at the last valid position (``lengths`` [B]
        valid tokens, default S) -> [B, vocab] f32."""
        b, s, _ = x.shape
        x = _layer_norm(x, params["final_ln"]["scale"],
                        params["final_ln"]["bias"])
        if lengths is None:
            last = torch.full((b,), s - 1, dtype=torch.long, device=x.device)
        else:
            last = (lengths.long() - 1).clamp(0, s - 1)
        x_last = x[torch.arange(b, device=x.device), last]
        return torch.matmul(x_last.float(), params["embed"]["tok"].float().t())

    # -- whole-model entry points -----------------------------------------------

    def _forward(self, params: Params, feeds, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 attention: Optional[Callable] = None):
        """Causal forward over ``feeds["input_ids"]`` [B,S] -> ``{"logits"
        [B,S,vocab] f32, "pred"}``. ``attention`` overrides the kernel
        (``attention_reference`` gives the plain dense forward)."""
        x, _, _ = self._encode(params, feeds, True, train, generator,
                               attention)
        logits = torch.matmul(x.float(), params["embed"]["tok"].float().t())
        return {"logits": logits, "pred": logits.argmax(-1).float()}

    def _loss(self, params: Params, feeds, train: bool = True,
              generator: Optional[torch.Generator] = None, **kw):
        """Per-sequence mean next-token NLL [B], weighted by
        ``attention_mask[:, 1:]`` when the feeds carry one."""
        ids = torch.as_tensor(feeds["input_ids"], device=self.device).long()
        logits = self._forward(params, feeds, train, generator, **kw)["logits"]
        b, s, vocab = logits.shape
        # next-token targets; the last position has none (ignored: NLL 0)
        tgt = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -100)], 1)
        nll = F.cross_entropy(logits.reshape(b * s, vocab), tgt.reshape(-1),
                              reduction="none").view(b, s)[:, :-1]
        mask = feeds.get("attention_mask")
        if mask is not None:
            w = torch.as_tensor(mask, device=self.device)[:, 1:].float()
            return (nll * w).sum(-1) / w.sum(-1).clamp_min(1e-6)
        return nll.mean(-1)

    def prefill(self, params: Params, ids, mask=None, lengths=None,
                tp_axis=None, ep_axis=None
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Causal forward over a (padded) prompt that also returns each
        block's keys/values: ``(logits [B, vocab] at the last valid position,
        [(k, v)] * layers with k/v [B,heads,S,d])``."""
        self._check_axes(tp_axis, ep_axis)
        x = self.prefill_embed(params, ids)
        kvs = []
        for i in range(self.num_layers):
            x, k, v, _ = self._block(params[f"block_{i}"], x, mask, True)
            kvs.append((k, v))
        return self.head_last(params, x, lengths), kvs

    def decode_step(self, params: Params, cache, token, pos, attend=None,
                    num_layers: Optional[int] = None, tp_axis=None,
                    ep_axis=None):
        """Single-token apply: embed ``token`` [B] at ``pos`` [B], run the
        blocks over the cached history, return ``(logits [B, vocab] f32,
        cache)``. ``attend(layer, q, k_new, v_new, cache, pos) -> (att
        [B,heads,d], cache)`` owns the cache layout (default: the dense
        cache of :meth:`init_decode_cache`)."""
        self._check_axes(tp_axis, ep_axis)
        if attend is None:
            attend = self._dense_cache_attend
        n = self.num_layers if num_layers is None else int(num_layers)
        x = self.decode_embed(params, token, pos)
        for i in range(n):
            x, cache = self._block_decode(params[f"block_{i}"], x, i, cache,
                                          pos, attend)
        return self.decode_head(params, x), cache

    def prefill_suffix(self, params: Params, ids, start, cache, attend,
                       lengths=None, tp_axis=None, ep_axis=None):
        """Prefill a prompt suffix ``ids`` [B,S] whose first token sits at
        ``start`` [B]; attention over the committed prefix is ``attend``'s.
        Returns ``(logits [B, vocab] at the last valid suffix position,
        cache)``."""
        self._check_axes(tp_axis, ep_axis)
        x = self._suffix_blocks(params, ids, start, cache, attend)
        return self.head_last(params, x, lengths), cache

    def decode_verify(self, params: Params, ids, start, cache, attend,
                      tp_axis=None, ep_axis=None):
        """Speculative-verify forward: like :meth:`prefill_suffix` (``ids``
        [B,S] starting at absolute position ``start`` [B], attention over
        the committed history and this chunk is ``attend``'s) but with
        logits at EVERY position — ``(logits [B, S, vocab] f32, cache)`` —
        so one call scores a drafted block: ``logits[:, j]`` is the model's
        next-token distribution after the prefix and ``ids[:, :j+1]``."""
        self._check_axes(tp_axis, ep_axis)
        x = self._suffix_blocks(params, ids, start, cache, attend)
        return self.head_all(params, x), cache

    def _suffix_blocks(self, params, ids, start, cache, attend):
        x = self.suffix_embed(params, ids, start)
        for i in range(self.num_layers):
            x, cache = self._block_suffix(params[f"block_{i}"], x, i, cache,
                                          start, attend)
        return x

    # -- dense decode cache (parity implementation) ------------------------------

    def init_decode_cache(self, batch: int, max_len: Optional[int] = None,
                          dtype=None, kv_dtype: Optional[str] = None):
        """Dense per-slot cache ``{"k","v": [layers, B, heads, L, d]}``.
        With ``kv_dtype="int8"|"fp8"`` the rows are stored quantized and the
        cache carries ``k_scale`` / ``v_scale`` ``[layers, B, heads, L]``
        float32 per-token-per-head scales — the dense twin of the serving
        engine's quantized page pool (dense writes are independent per
        position, so no running page max is needed)."""
        L = int(max_len) if max_len is not None else self.max_len
        shape = (self.num_layers, batch, self.num_heads, L, self.head_dim)
        if kv_dtype in (None, "bf16"):
            dt = dtype if dtype is not None else (self.compute_dtype
                                                  or torch.float32)
            return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                    "v": torch.zeros(shape, dtype=dt, device=self.device)}
        store, _ = quant.kv_pool_dtype(kv_dtype)
        sshape = shape[:-1]
        return {"k": torch.zeros(shape, dtype=store, device=self.device),
                "v": torch.zeros(shape, dtype=store, device=self.device),
                "k_scale": torch.zeros(sshape, device=self.device),
                "v_scale": torch.zeros(sshape, device=self.device)}

    def _dense_cache_attend(self, layer, q, k_new, v_new, cache, pos):
        """Write this token's k/v into the dense cache at ``pos`` (in place)
        and attend over positions ``<= pos``. A quantized cache (``"k_scale"
        in cache``) stores each row as int8/fp8 with its own per-head scale;
        the gathered rows are multiplied by their scales in float32."""
        b = q.shape[0]
        L = cache["k"].shape[3]
        bidx = torch.arange(b, device=q.device)
        pos = pos.long()
        kc, vc = cache["k"][layer], cache["v"][layer]
        if "k_scale" in cache:
            qmax = quant.kv_qmax(kc.dtype)

            def put(rows, scales, new):
                nf = new.float()                                # [B, heads, d]
                sc = nf.abs().amax(dim=-1) / qmax               # [B, heads]
                eff = torch.where(sc > 0, sc, torch.ones_like(sc))
                rows[bidx, :, pos] = quant.kv_cast(nf / eff[..., None],
                                                   rows.dtype, qmax)
                scales[bidx, :, pos] = sc
                return rows.float() * scales[..., None]

            kf = put(kc, cache["k_scale"][layer], k_new)
            vf = put(vc, cache["v_scale"][layer], v_new)
        else:
            kc[bidx, :, pos] = k_new.to(kc.dtype)
            vc[bidx, :, pos] = v_new.to(vc.dtype)
            kf, vf = kc.float(), vc.float()
        scale = 1.0 / math.sqrt(self.head_dim)
        s = torch.einsum("bhd,bhld->bhl", q.float(), kf) * scale
        valid = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
        s = torch.where(valid[:, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhl,bhld->bhd", p, vf)
        return out.to(q.dtype), cache


__all__ = ["TransformerClassifier", "TransformerLM"]
