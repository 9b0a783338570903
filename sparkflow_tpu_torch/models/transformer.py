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
cache takes int8/fp8 rows (``init_decode_cache(kv_dtype=)``).

Sequence parallelism: with ``sp_axis`` set (a mesh axis name; the sp train
step sets it on its own copy of the model, :mod:`..parallel.sp`) each rank
holds a sequence shard, attention runs
:func:`~sparkflow_tpu_torch.ops.ring_flash_attention` over that axis of the
bound mesh, and positions start at the rank's index on the axis times the
shard length.

Tensor parallelism (Megatron; :mod:`..parallel.tp`): a block splits at its
two reduction points into an attention half (ln1, qkv on the local
columns, attention on the local heads, o on the local rows) and an MLP half
(ln2, fc1 local, gelu, fc2 local); the number of heads comes from the local
qkv width. Between the halves a reduction hook does one of two things. On
a rank of a ``tp`` mesh (``tp_axis`` set on the rank's copy of the model,
its leaves that rank's slices) *f* goes before qkv and fc1 and *g*, an
all-reduce over the axis, after o and fc2
(:func:`~..parallel.collectives.tp_enter`, ``tp_exit``), and the
row-parallel bias is added once after the sum. In one-process serving a
block's params are a :class:`~..parallel.tp.TPShards` (and so are a decode
cache and a prefill's K/V): each half runs on every shard, the partials are
summed in float32 on shard 0's device in shard order and rounded to the
compute dtype once, and the bias is added once after. An MoE layer's
expert MLP is replicated on a ``tp`` mesh and has no reduction. Expert parallelism
(``ep_axis``) is not yet ported and raises.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..ops import flash_attention, ring_flash_attention
from ..parallel.tp import TPShards, shard_of as _shard, shards_of as _shards
from ..sharding import P
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
        super().__init__(compute_dtype, device)
        # a mesh axis name: attention becomes ring attention over it
        self.sp_axis = sp_axis
        # a mesh axis name, set on a tp rank's copy of the model: the
        # Megatron forward over that axis of the bound mesh
        self.tp_axis: Optional[str] = None
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

    def _block_pspecs(self):
        return {
            "ln1_scale": P(), "ln1_bias": P(),
            "qkv_kernel": P(None, "tp"), "qkv_bias": P("tp"),
            "o_kernel": P("tp", None), "o_bias": P(),
            "ln2_scale": P(), "ln2_bias": P(),
            "fc1_kernel": P(None, "tp"), "fc1_bias": P("tp"),
            "fc2_kernel": P("tp", None), "fc2_bias": P(),
        }

    def param_pspecs(self):
        """Megatron-style TP sharding rules, same tree structure as params
        (the JAX package's)."""
        specs = {"embed": {"tok": P(None, None), "pos": P(None, None)}}
        for i in range(self.num_layers):
            specs[f"block_{i}"] = self._block_pspecs()
        specs["final_ln"] = {"scale": P(), "bias": P()}
        return specs

    # -- blocks --------------------------------------------------------------

    def _axes_model(self, tp_axis, ep_axis):
        """The model an entry point called with mesh axes runs as: itself,
        or a copy running the Megatron forward over ``tp_axis`` (of the
        bound mesh, on this rank's slices). ``ep_axis`` is refused."""
        if ep_axis is not None:
            _not_yet("expert parallelism (ep_axis)")
        if tp_axis is None or tp_axis == self.tp_axis:
            return self
        other = copy.copy(self)
        other.tp_axis = tp_axis
        return other

    def _tp_enter(self, y):
        """Megatron's *f* before a column-parallel projection on a tp rank;
        the identity elsewhere."""
        if self.tp_axis is None:
            return y
        from ..parallel.collectives import tp_enter
        return tp_enter(y, self.tp_axis)

    def _parallel_half(self, bp, x, half, base: str):
        """One block half ending in the row-parallel projection ``base``
        (``"o_"`` or ``"fc2_"``): ``half(p, x, s) -> (h, side)`` runs the
        half up to that projection's input on params ``p`` (shard ``s``).
        Returns ``(out, side)``: the projection's output, summed over the
        tp shards with its bias counted once, and ``half``'s side output
        (a TPShards of them in one-process serving)."""
        shards = _shards(bp)
        if shards is None:
            h, side = half(bp, x, 0)
            if self.tp_axis is None:
                return self._proj(bp, base, h), side
            from ..parallel.collectives import tp_exit
            out = tp_exit(_dense(h, bp[f"{base}kernel"]), self.tp_axis)
            bias = bp.get(f"{base}bias")
            return (out if bias is None else out + bias.to(out.dtype)), side
        # one process: each shard's product in float32 (a bf16 product of
        # bf16 operands is exact there), summed in shard order on shard 0's
        # device and rounded to the compute dtype once, then the bias — the
        # unsharded projection's arithmetic up to the order of summation
        total, sides = None, TPShards()
        for s, p in enumerate(shards):
            kernel = p[f"{base}kernel"]
            h, side = half(p, x.to(kernel.device), s)
            part = torch.matmul(h.float(), kernel.to(h.dtype).float())
            total = part.to(x.device) if total is None else (
                total + part.to(x.device))
            sides.append(side)
        out = total.to(x.dtype)
        bias = shards[0].get(f"{base}bias")
        return (out if bias is None else out + bias.to(out.dtype)), sides

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
        [B,heads,S,d] of ONE [3,B,heads,S,d] permutation (no copies);
        ``heads`` from the (local) qkv width."""
        b, s, _ = x.shape
        y = self._tp_enter(_layer_norm(x, bp["ln1_scale"], bp["ln1_bias"]))
        qkv = self._proj(bp, "qkv_", y)
        heads = qkv.shape[-1] // (3 * self.head_dim)
        qkv = qkv.view(b, s, 3, heads, self.head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2]

    def _mlp(self, bp, y, mask=None):
        """The block's feed-forward half on ``y`` [B,S,hidden] (after ln2):
        ``(out, aux)``. Dense blocks add no auxiliary loss (``aux`` None);
        the MoE mixin overrides this for its expert layers, where ``mask``
        [B,S] marks the tokens that may claim expert capacity."""
        y = _gelu(self._proj(bp, "fc1_", y))
        return self._proj(bp, "fc2_", y), None

    def _mlp_half(self, bp, x, mask=None):
        """ln2 and the feed-forward half on the residual stream ``x``:
        ``(out, aux)``. Tensor-parallel as a Megatron half, except an MoE
        layer's, whose expert MLP is replicated on a tp mesh (shard 0's copy
        in one-process serving) and has no reduction."""
        shards = _shards(bp)
        p0 = bp if shards is None else shards[0]
        if (shards is None and self.tp_axis is None) or "router" in p0:
            y = _layer_norm(x, p0["ln2_scale"], p0["ln2_bias"])
            return self._mlp(p0, y, mask)

        def half(p, xs, _s):
            y = self._tp_enter(_layer_norm(xs, p["ln2_scale"],
                                           p["ln2_bias"]))
            return _gelu(self._proj(p, "fc1_", y)), None

        return self._parallel_half(bp, x, half, "fc2_")[0], None

    def _finish_block(self, bp, x, att, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      mask=None):
        """Residual + MLP after the attention half's output ``att``
        [B,S,hidden], with dropout after the O projection and after the MLP
        when training: ``(x, aux)`` (see :meth:`_mlp`)."""
        x = x + self._dropout(att, train, generator)
        y, aux = self._mlp_half(bp, x, mask)
        return x + self._dropout(y, train, generator), aux

    def _block(self, bp, x, mask, causal, attention=None, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """Full-sequence block: ``(x, k, v, aux)`` with k/v
        [B,heads,S,d] (TPShards of them in one-process tp serving);
        ``mask`` is the key-padding mask and the MLP's live tokens."""
        b, s, _ = x.shape

        def half(p, xs, _s):
            q, k, v = self._qkv(p, xs)
            m = None if mask is None else mask.to(q.device)
            if attention is not None:
                att = attention(q, k, v, causal=causal, kv_mask=m)
            elif self.sp_axis is not None:
                att = ring_flash_attention(q, k, v, self.sp_axis,
                                           causal=causal, kv_mask=m)
            else:
                att = flash_attention(q, k, v, causal=causal, kv_mask=m)
            return att.transpose(1, 2).reshape(b, s, -1), (k, v)

        att, kv = self._parallel_half(bp, x, half, "o_")
        x, aux = self._finish_block(bp, x, att, train, generator, mask)
        if isinstance(kv, TPShards):
            k = TPShards([a for a, _ in kv])
            v = TPShards([b_ for _, b_ in kv])
        else:
            k, v = kv
        return x, k, v, aux

    def _block_decode(self, bp, x, layer, cache, pos, attend):
        """One block on a single token ``x`` [B,1,hidden]; attention over
        the cached history is ``attend``'s (see :meth:`decode_step`), on
        shard ``s``'s entry of a TPShards cache in one-process tp
        serving."""
        b = x.shape[0]

        def half(p, xs, s):
            y = self._tp_enter(_layer_norm(xs, p["ln1_scale"],
                                           p["ln1_bias"]))
            qkv = self._proj(p, "qkv_", y)
            heads = qkv.shape[-1] // (3 * self.head_dim)
            qkv = qkv.view(b, 3, heads, self.head_dim)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]       # [B, heads, d]
            att, _ = attend(layer, q, k, v, _shard(cache, s),
                            pos.to(q.device))
            return att.reshape(b, 1, -1), None

        att, _ = self._parallel_half(bp, x, half, "o_")
        return self._finish_block(bp, x, att)[0], cache

    def _block_suffix(self, bp, x, layer, cache, start, attend):
        """One block on a prompt suffix ``x`` [B,S,hidden] starting at
        absolute position ``start`` [B]; ``attend(layer, q, k, v, cache,
        start)`` with q/k/v [B,heads,S,d] owns the history."""
        b, s, _ = x.shape

        def half(p, xs, sh):
            q, k, v = self._qkv(p, xs)
            att, _ = attend(layer, q, k, v, _shard(cache, sh),
                            start.to(q.device))
            return att.transpose(1, 2).reshape(b, s, -1), None

        att, _ = self._parallel_half(bp, x, half, "o_")
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
        # the recompute runs inside autograd's backward — on its own thread
        # for CUDA tensors — where a ring needs its mesh bound again
        from ..parallel.mesh import current_mesh
        mesh = current_mesh()

        def run(x):
            g = None
            if state is not None:
                g = torch.Generator(device=x.device)
                g.set_state(state)
            with (mesh.bind() if mesh is not None
                  else contextlib.nullcontext()):
                y, _, _, aux = self._block(bp, x, mask, causal, attention,
                                           train, g)
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

    def stage_apply(self, blocks, x, mask=None, causal: bool = True,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None):
        """A pipeline stage: ``x`` [B,S,hidden] through ``blocks`` (a list
        of block trees, e.g. :func:`~..parallel.pp.stage_blocks`) in order;
        the blocks' auxiliary losses are dropped, as JAX's pp stage drops
        them."""
        for bp in blocks:
            x = self._block(bp, x, mask, causal, None, train, generator)[0]
        return x

    def prefill_embed(self, params, ids):
        emb = params["embed"]
        s = ids.shape[1]
        start = 0
        if self.sp_axis is not None:
            # a rank holds a sequence SHARD: global positions, not 0..s-1
            # (clamped into the table as jax's dynamic_slice does)
            from ..parallel.collectives import axis_index
            start = min(axis_index(self.sp_axis) * s, self.max_len - s)
        pos = emb["pos"][start:start + s]
        return self.cast(emb["tok"][ids.long()] + pos[None])


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

    def param_pspecs(self):
        specs = super().param_pspecs()
        specs["head"] = {"kernel": P(None, None), "bias": P()}
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

    # -- stage-level pieces ---------------------------------------------------
    #
    # Pipeline-parallel decode (serving/decode.py with an active pp_axis)
    # walks the embed / per-block / head pieces stage by stage, each stage
    # holding only its own blocks and its own layers of the pool, so the
    # per-block pieces take stage-LOCAL layer indices (whatever index the
    # ``attend`` callback expects). The whole-model methods below compose
    # the same pieces.

    def block_decode(self, bp, x, layer, cache, pos, attend, tp_axis=None,
                     ep_axis=None):
        """One block's decode step (see :meth:`_block_decode`):
        ``(x, cache)``."""
        return self._axes_model(tp_axis, ep_axis)._block_decode(
            bp, x, layer, cache, pos, attend)

    def block_suffix(self, bp, x, layer, cache, start, attend, tp_axis=None,
                     ep_axis=None):
        """One block over a prompt suffix (see :meth:`_block_suffix`):
        ``(x, cache)``."""
        return self._axes_model(tp_axis, ep_axis)._block_suffix(
            bp, x, layer, cache, start, attend)

    def block_prefill(self, bp, x, mask=None, tp_axis=None, ep_axis=None):
        """One causal block over a prompt, with its keys / values for the
        decode cache: ``(x, k, v)``, k / v [B,heads,S,d] (the local heads
        under tp; TPShards of them in one-process tp serving)."""
        x, k, v, _ = self._axes_model(tp_axis, ep_axis)._block(bp, x, mask,
                                                               True)
        return x, k, v

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
        [(k, v)] * layers with k/v [B,heads,S,d])``. ``tp_axis``: on a
        rank of a tp mesh, the Megatron forward over that axis (k/v then
        hold the rank's heads)."""
        m = self._axes_model(tp_axis, ep_axis)
        if m is not self:
            return m.prefill(params, ids, mask, lengths)
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
        m = self._axes_model(tp_axis, ep_axis)
        if m is not self:
            return m.decode_step(params, cache, token, pos, attend,
                                 num_layers)
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
        m = self._axes_model(tp_axis, ep_axis)
        if m is not self:
            return m.prefill_suffix(params, ids, start, cache, attend,
                                    lengths)
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
        m = self._axes_model(tp_axis, ep_axis)
        if m is not self:
            return m.decode_verify(params, ids, start, cache, attend)
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
