"""Attention ops: flash attention forward and paged decode attention.

The port of the JAX package's ``ops/attention.py`` for the decode-serving
path. Each op is a pair:

- a plain PyTorch version (:func:`attention_reference`,
  :func:`paged_attention_reference`) — the ground truth, and what the
  wrapper computes for tensors on the CPU;
- a wrapper (:func:`flash_attention`, :func:`paged_attention`) that, for
  CUDA tensors, launches the hand-written kernel from ``ops/csrc/`` (built
  at first use, :mod:`._build`) or raises — it never falls back to the
  plain version on the card.

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


def attention_reference(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        q_offset: int = 0, k_offset: int = 0, kv_mask=None,
                        return_lse: bool = False):
    """Plain softmax attention with float32 scores. Shapes [B,H,S,D];
    ``kv_mask`` [B,S_k] masks padded keys (1 = attend). With ``return_lse``
    also returns the per-row logsumexp [B,H,S] float32."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(s.shape[-2], device=s.device)[:, None] + q_offset
        ki = torch.arange(s.shape[-1], device=s.device)[None, :] + k_offset
        s = torch.where(qi >= ki, s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
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
    the caller's transpose back to [B,S,H*D] is free. Forward only: the
    backward kernels are not ported yet."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    path = _route(q)
    _LAST_PATH.set(path)
    if path == "reference":
        return attention_reference(q, k, v, causal, scale, kv_mask=kv_mask,
                                   return_lse=return_lse)
    _check_kernel_operands("flash_attention", q.dtype, q, k, v)
    _check_head_dim("flash_attention", d)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, sk):
            raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)}"
                             f" is not [B, S_k] = {(b, sk)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        from . import _build
        lib = _build.load()
        # (batch, head, seq) element strides of q, k, v and out
        strides = (ctypes.c_longlong * 12)(
            *(tuple(q.stride()[:3]) + tuple(k.stride()[:3])
              + tuple(v.stride()[:3]) + tuple(out.stride()[:3])))
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
    paged_attention.launches = 0
