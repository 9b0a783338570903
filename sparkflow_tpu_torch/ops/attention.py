"""Attention ops: flash attention (forward and backward) and paged decode
attention.

The port of the JAX package's ``ops/attention.py`` for the decode-serving
and training paths. Each op is a pair:

- a plain PyTorch version (:func:`attention_reference`,
  :func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference` and
  their composition :func:`flash_attention_backward_reference`,
  :func:`paged_attention_reference`) — the ground truth, and what the
  wrapper computes for tensors on the CPU;
- a wrapper (:func:`flash_attention`, :func:`flash_bwd_dq`,
  :func:`flash_bwd_dkv`, :func:`paged_attention`) that, for CUDA tensors,
  launches the hand-written kernel from ``ops/csrc/`` (built at first use,
  :mod:`._build`) or raises — it never falls back to the plain version on
  the card.

:func:`flash_attention` is differentiable: when q, k or v requires a
gradient it runs as a ``torch.autograd.Function`` (the counterpart of the
JAX ``jax.custom_vjp`` ``_flash``) whose backward is
:func:`flash_attention_backward` — the dq and dk/dv kernels on the card.

Every wrapper carries ``launches``, a plain integer counting the kernel
launches it made, so a run can show its main path went through the kernel.
:func:`last_attention_path` reports which of the two the latest call in this
context took (``"kernel"`` or ``"reference"``).

Layout convention: ``[batch, heads, seq, head_dim]`` for flash attention;
the paged pool is ``[num_pages, page_size, heads, head_dim]``, as in the JAX
package. Unlike the TPU kernels there are no tile rules: the CUDA kernels
mask their ragged edges and take every sequence length, with ``head_dim``
a multiple of 8 up to 128, in float32 or bfloat16.
"""

from __future__ import annotations

import ctypes
import math
from contextvars import ContextVar
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30

_LAST_PATH: ContextVar = ContextVar("sparkflow_torch_last_attention_path",
                                    default=None)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def last_attention_path() -> Optional[str]:
    """Path taken by the latest :func:`flash_attention` or
    :func:`paged_attention` call in this thread/context: ``"kernel"`` (the
    CUDA kernel) or ``"reference"`` (the plain version, CPU tensors)."""
    return _LAST_PATH.get()


def _route(x: torch.Tensor) -> str:
    """``"reference"`` for CPU tensors, ``"kernel"`` for CUDA tensors."""
    if x.device.type == "cpu":
        return "reference"
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return "kernel"


def _check_kernel_operands(name: str, dtype: torch.dtype, *tensors) -> None:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.is_floating_point() and t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")


def _check_head_dim(name: str, d: int) -> None:
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 in "
                         f"[8, 128], got {d}")


# ---------------------------------------------------------------------------
# Flash attention (prefill)
# ---------------------------------------------------------------------------


def _masked_scores(q, k, scale, causal, kv_mask, q_offset: int = 0,
                   k_offset: int = 0) -> torch.Tensor:
    """Float32 scores ``scale * Q K^T`` [B,H,S,Sk], NEG_INF where a key lies
    past the query (``causal``) or is padding (``kv_mask`` [B,Sk] is 0)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(s.shape[-2], device=s.device)[:, None] + q_offset
        ki = torch.arange(s.shape[-1], device=s.device)[None, :] + k_offset
        s = torch.where(qi >= ki, s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    return s


def _check_shapes(name: str, q, k, v, *like_q) -> None:
    """q [B,H,S,D], k and v [B,H,S_k,D], and ``like_q`` shaped as q."""
    b, h, _, d = q.shape
    if (k.shape != (b, h, k.shape[2], d) or v.shape != k.shape
            or any(t.shape != q.shape for t in like_q)):
        got = ", ".join(f"{n} {tuple(t.shape)}" for n, t in
                        zip(("q", "k", "v", "dout"), (q, k, v) + like_q))
        raise ValueError(f"{name}: {got} do not match")


def _flash_operands(name: str, q, k, v, kv_mask, *like_q):
    """Check the flash kernels' operands (shapes already checked) and ready
    them for a launch: ``head_dim`` contiguous, the [B, S_k] mask float32
    and contiguous. Returns ``(q, k, v, *like_q, kv_mask)``."""
    _check_kernel_operands(name, q.dtype, q, k, v, *like_q)
    _check_head_dim(name, q.shape[-1])
    ts = tuple(t if t.stride(-1) == 1 else t.contiguous()
               for t in (q, k, v) + like_q)
    if kv_mask is not None:
        want = (q.shape[0], k.shape[2])
        if tuple(kv_mask.shape) != want:
            raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} is not "
                             f"[B, S_k] = {want}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    return ts + (kv_mask,)


def _seq_strides(*tensors):
    """(batch, head, seq) element strides of each tensor, for the kernels."""
    flat = [x for t in tensors for x in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def attention_reference(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        q_offset: int = 0, k_offset: int = 0, kv_mask=None,
                        return_lse: bool = False):
    """Plain softmax attention with float32 scores. Shapes [B,H,S,D];
    ``kv_mask`` [B,S_k] masks padded keys (1 = attend). With ``return_lse``
    also returns the per-row logsumexp [B,H,S] float32."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = _masked_scores(q, k, scale, causal, kv_mask, q_offset, k_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, kv_mask=None,
                    return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention forward; [B,H,S,D] -> [B,H,S,D] in the input dtype
    (plus the [B,H,S] float32 logsumexp with ``return_lse``). ``kv_mask`` is
    an optional [B, S_k] key-padding mask (1 = attend); ``causal`` masks key
    j > query i (positions counted from 0 on both axes).

    On the card this launches ``csrc/flash_fwd.cu`` (the port of the TPU
    ``_flash_kernel``). q/k/v may be strided views (the model passes slices
    of one qkv permutation) as long as ``head_dim`` is contiguous; the output
    is allocated [B,S,H,D]-contiguous and returned as its [B,H,S,D] view, so
    the caller's transpose back to [B,S,H*D] is free.

    When grad mode is on and q, k or v requires a gradient, the call runs
    as :class:`FlashAttentionFunction`: the forward saves q, k, v, the mask,
    O and the logsumexp, and the backward is
    :func:`flash_attention_backward` (``csrc/flash_bwd.cu`` on the card,
    the plain recurrence on the CPU). ``kv_mask`` gets no gradient."""
    _check_shapes("flash_attention", q, k, v)
    b, h, s, d = q.shape
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttentionFunction.apply(q, k, v, kv_mask,
                                                bool(causal), float(scale))
        return (out, lse) if return_lse else out
    path = _route(q)
    _LAST_PATH.set(path)
    if path == "reference":
        return attention_reference(q, k, v, causal, scale, kv_mask=kv_mask,
                                   return_lse=return_lse)
    q, k, v, kv_mask = _flash_operands("flash_attention", q, k, v, kv_mask)
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        from . import _build
        lib = _build.load()
        strides = _seq_strides(q, k, v, out)
        rc = lib.sf_flash_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, h, s, sk, d, ctypes.addressof(strides), float(scale),
            int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_fwd")
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Flash attention backward (dq and dk/dv kernels, flash-style recompute)
#
# The FlashAttention-2 recurrence of the JAX package: with the row
# statistics L = logsumexp saved by the forward and D_i = rowsum(dO_i * O_i),
#   P  = exp(S - L);  dV = P^T dO;  dP = dO V^T
#   dS = P * (dP - D);  dQ = scale * dS K;  dK = scale * dS^T Q
# Masked and causal-excluded entries of P are exactly 0 (the JAX gate
# s > 0.5 * NEG_INF), so a query row whose keys are all padding gets zero
# gradient although the forward averaged its values uniformly.
# ---------------------------------------------------------------------------


def _bwd_delta(out, dout) -> torch.Tensor:
    """D = rowsum(dO * O) as a contiguous [B,H,S] float32 tensor — a plain
    reduction, as the JAX package leaves it to XLA (``_flash_bwd_prep``)."""
    return (dout.float() * out.float()).sum(-1).contiguous()


def _bwd_p(q, k, lse, scale, causal, kv_mask) -> torch.Tensor:
    """P = exp(S - L) [B,H,S,Sk] in float32, exactly 0 where masked."""
    s = _masked_scores(q, k, scale, causal, kv_mask)
    return torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse[..., None]), 0.0)


def _bwd_ds(p, v, dout, delta) -> torch.Tensor:
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool = False,
                           sm_scale: Optional[float] = None, kv_mask=None):
    """Plain version of :func:`flash_bwd_dq`: dQ in q's dtype."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p = _bwd_p(q, k, lse, scale, causal, kv_mask)
    ds = _bwd_ds(p, v, dout, delta)
    return (scale * torch.einsum("bhqk,bhkd->bhqd", ds, k.float())).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool = False,
                            sm_scale: Optional[float] = None, kv_mask=None):
    """Plain version of :func:`flash_bwd_dkv`: (dK, dV) in k's and v's
    dtypes."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p = _bwd_p(q, k, lse, scale, causal, kv_mask)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    ds = _bwd_ds(p, v, dout, delta)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, out, lse, dout,
                                       causal: bool = False,
                                       sm_scale: Optional[float] = None,
                                       kv_mask=None):
    """Plain backward of flash attention: ``(dq, dk, dv)`` in the inputs'
    dtypes, computed in float32 by the recurrence above from the forward's
    output ``out`` and logsumexp ``lse`` [B,H,S] and the cotangent
    ``dout``."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    delta = _bwd_delta(out, dout)
    dq = flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, scale,
                                kv_mask)
    dk, dv = flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                     scale, kv_mask)
    return dq, dk, dv


def _bwd_operands(name, q, k, v, dout, lse, delta, kv_mask):
    """Check the backward kernels' operands; returns (q, k, v, dout,
    kv_mask) ready for the launch."""
    _check_shapes(name, q, k, v, dout)
    want = tuple(q.shape[:3])
    for t, what in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"[B, H, S] = {want} tensor on {q.device}")
    return _flash_operands(name, q, k, v, kv_mask, dout)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = False,
                 sm_scale: Optional[float] = None, kv_mask=None
                 ) -> torch.Tensor:
    """dQ of flash attention from the forward's logsumexp ``lse`` and
    ``delta`` = rowsum(dO * O), both [B,H,S] float32. On the card this
    launches ``flash_bwd_dq_kernel`` of ``csrc/flash_bwd.cu`` (the port of
    the TPU ``_flash_bwd_dq_kernel``); dQ is allocated [B,S,H,D]-contiguous
    and returned as its [B,H,S,D] view, like the forward's output."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _route(q) == "reference":
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal,
                                      scale, kv_mask)
    q, k, v, dout, mask = _bwd_operands("flash_bwd_dq", q, k, v, dout,
                                        lse, delta, kv_mask)
    b, h, s, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    if dq.numel():
        from . import _build
        lib = _build.load()
        strides = _seq_strides(q, k, v, dout, dq)
        rc = lib.sf_flash_bwd_dq(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            mask.data_ptr() if mask is not None else None, dq.data_ptr(),
            b, h, s, k.shape[2], d, ctypes.addressof(strides), float(scale),
            int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_bwd_dq")
        flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                  sm_scale: Optional[float] = None, kv_mask=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of flash attention; operands as :func:`flash_bwd_dq`. On the
    card this launches ``flash_bwd_dkv_kernel`` of ``csrc/flash_bwd.cu``
    (the port of the TPU ``_flash_bwd_dkv_kernel``)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _route(q) == "reference":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                       scale, kv_mask)
    q, k, v, dout, mask = _bwd_operands("flash_bwd_dkv", q, k, v, dout,
                                        lse, delta, kv_mask)
    b, h, sk, d = k.shape
    dk = torch.empty((b, sk, h, d), dtype=k.dtype,
                     device=k.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    if dk.numel():
        from . import _build
        lib = _build.load()
        strides = _seq_strides(q, k, v, dout, dk, dv)
        rc = lib.sf_flash_bwd_dkv(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            mask.data_ptr() if mask is not None else None, dk.data_ptr(),
            dv.data_ptr(), b, h, q.shape[2], sk, d,
            ctypes.addressof(strides), float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_bwd_dkv")
        flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = False,
                             sm_scale: Optional[float] = None, kv_mask=None):
    """``(dq, dk, dv)`` of flash attention: D = rowsum(dO * O) as a plain
    reduction, then :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` — the
    two CUDA kernels for CUDA tensors, their plain versions on the CPU."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    delta = _bwd_delta(out, dout)
    lse = lse.contiguous()
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, kv_mask)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, kv_mask)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention — the counterpart of the JAX package's
    ``jax.custom_vjp`` ``_flash``. ``apply(q, k, v, kv_mask, causal, scale)
    -> (out, lse)``; ``lse`` carries no gradient, nor does ``kv_mask``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        out, lse = flash_attention(q, k, v, causal, scale, kv_mask=kv_mask,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.causal, ctx.scale, kv_mask)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# Paged attention (decode)
# ---------------------------------------------------------------------------


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              sm_scale: Optional[float] = None):
    """Ground-truth decode attention over a paged KV pool.

    - ``q``: ``[B, H, D]`` — the current token's query per slot;
    - ``k_pages`` / ``v_pages``: ``[num_pages, page_size, H, D]`` pool;
    - ``page_table``: ``[B, max_pages]`` int — slot b's cache lives in pages
      ``page_table[b, :ceil(lengths[b]/page_size)]``, in order (entries past
      that count must still be valid pool indices);
    - ``lengths``: ``[B]`` int — valid tokens per slot; position
      ``p * page_size + t < lengths[b]`` attends. A slot with
      ``lengths == 0`` returns exact zeros.
    """
    b, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    maxp = page_table.shape[1]
    page = k_pages.shape[1]
    idx = page_table.long()
    k = k_pages[idx].float().reshape(b, maxp * page, h, d)
    v = v_pages[idx].float().reshape(b, maxp * page, h, d)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    pos = torch.arange(maxp * page, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    # all-masked rows softmax to uniform garbage; empty slots must be zeros
    out = torch.where((lengths.to(q.device) > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, lengths,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention: one query token per slot against a page-table-
    indirected K/V pool. Same operands and semantics as
    :func:`paged_attention_reference`. On the card this launches
    ``csrc/paged_attention.cu`` (the port of the TPU ``_paged_kernel``): one
    thread block per (slot, head) reads its own table row and walks only
    the slot's ``ceil(lengths[b] / page)`` pages. Quantized pools (the TPU
    ``_paged_kernel_quant``) are not ported yet."""
    b, h, d = q.shape
    num_pages, page = k_pages.shape[:2]
    if (tuple(k_pages.shape) != (num_pages, page, h, d)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"paged_attention: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError("paged_attention: page_table must be [B, max_pages] "
                         "and lengths [B]")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    path = _route(q)
    _LAST_PATH.set(path)
    if path == "reference":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, sm_scale=scale)
    _check_kernel_operands("paged_attention", q.dtype, q, k_pages, v_pages,
                           page_table, lengths)
    _check_head_dim("paged_attention", d)
    if q.stride(-1) != 1:
        q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel():
        from . import _build
        lib = _build.load()
        rc = lib.sf_paged_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
            k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
            table.shape[1], lens.data_ptr(), out.data_ptr(), b, h, d, page,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "paged_attention")
        paged_attention.launches += 1
    return out


paged_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's ``launches`` counter."""
    flash_attention.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0
    paged_attention.launches = 0
