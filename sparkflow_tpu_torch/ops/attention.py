"""Attention ops: flash attention (forward and backward), paged decode
attention and paged verify attention (speculative decoding), each over a
plain or an int8/fp8-quantized KV pool.

The port of the JAX package's ``ops/attention.py`` for the decode-serving
and training paths. Each op is a pair:

- a plain PyTorch version (:func:`attention_reference`,
  :func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference` and
  their composition :func:`flash_attention_backward_reference`,
  :func:`paged_attention_reference`,
  :func:`paged_attention_verify_reference`) — the ground truth, and what
  the wrapper computes for tensors on the CPU;
- a wrapper (:func:`flash_attention`, :func:`flash_bwd_dq`,
  :func:`flash_bwd_dkv`, :func:`paged_attention`,
  :func:`paged_attention_verify`) that, for CUDA tensors, launches the
  hand-written kernel from ``ops/csrc/`` (built at first use,
  :mod:`._build`) or raises — it never falls back to the plain version on
  the card.

:func:`flash_attention` is differentiable: when q, k or v requires a
gradient it runs as a ``torch.autograd.Function`` (the counterpart of the
JAX ``jax.custom_vjp`` ``_flash``) whose backward is
:func:`flash_attention_backward` — the dq and dk/dv kernels on the card.

:func:`ring_flash_attention` is ring attention for sequence parallelism:
each rank holds a sequence shard, K/V rotate around a mesh axis, and every
visit runs the flash kernels (forward, and dq / dk-dv in its backward);
:func:`ring_attention` is its plain version.

Every kernel has a launch counter, a plain integer on its wrapper
(``launches``; the paged wrappers also ``quant_launches`` for their
quantized-pool kernel), so a run can show its main path went through the
kernel; :func:`launch_counts` reads them all by kernel name.
:func:`last_attention_path` reports which of the two the latest call in this
context took (``"kernel"`` or ``"reference"``).

Layout convention: ``[batch, heads, seq, head_dim]`` for flash attention
and the verify queries; the paged pool is ``[num_pages, page_size, heads,
head_dim]``, as in the JAX package. Unlike the TPU kernels there are no
tile rules: the CUDA kernels mask their ragged edges and take every
sequence length, with queries in float32 or bfloat16 and quantized pools in
int8 or float8_e4m3fn, every ``head_dim`` from 1 up and every count of
verify rows; nothing is refused by width. A multiple of 8 up to 256 runs
the tensor-core flash kernels and the vector paged kernels; a head_dim
below 256 that is not a multiple of 8 (TinyBERT's 26) runs the flash
kernels on q/k/v (and dO) staged into copies zero-padded to a multiple of 8
(:func:`_pad_head`; the zero columns add nothing to Q K^T or dO V^T, and the
padded output columns are dropped) and the paged kernels of
``csrc/paged_sliced.cu``, which read the pool as it is (it is the whole KV
cache: never copied); above 256 the column-sliced kernels of
``csrc/flash_sliced.cu`` and ``csrc/paged_sliced.cu`` run, each block owning
at most 256 output columns. ``sm_scale`` defaults to ``1/sqrt(head_dim)``
of the true head_dim. The verify kernel scores its rows in groups of 16,
so ``spec_k`` above 15 takes more groups, not another kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading
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


#: widest head_dim the tensor-core flash kernels and the vector paged
#: kernels take (a multiple of 8); the column-sliced kernels take the rest
_VECTOR_MAX_HEAD_DIM = 256


def _vector_head(d: int) -> bool:
    """Whether the tensor-core flash kernels and the vector paged kernels
    take head_dim ``d`` as it is (the C entries' own routing); else the
    column-sliced kernels run it."""
    return d % 8 == 0 and 8 <= d <= _VECTOR_MAX_HEAD_DIM


def _flash_head(d: int) -> int:
    """The head_dim the flash kernels run a ``d``-wide head at: ``d`` where
    the tensor-core kernels take it or above 256 (the column-sliced
    kernels), else ``d`` rounded up to a multiple of 8 (at least 8), to
    which :func:`_pad_head` stages the operands."""
    if _vector_head(d) or d > _VECTOR_MAX_HEAD_DIM:
        return d
    return max(8, -(-d // 8) * 8)


def _pad_head(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` [..., d] as a fresh contiguous [..., dp] tensor whose columns
    past d are zeros — aligned rows for the tensor-core kernels' 16-byte
    copies, and the same values: a zero column adds nothing to a product
    contracted over head_dim, and the kernels' padded output columns are
    dropped (:func:`_trim_head`)."""
    return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))


def _trim_head(t: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel's output at the padded head_dim, as its first ``d`` columns
    (a view)."""
    return t if t.shape[-1] == d else t[..., :d]


def _launch_ready(t: torch.Tensor, dp: int) -> torch.Tensor:
    """A flash kernel's operand as the launch at head_dim ``dp`` takes it:
    zero-padded to ``dp`` (:func:`_pad_head`), as it is for the column-sliced
    kernels (any alignment), else 16-byte aligned (:func:`_cp_async_ready`)."""
    if t.shape[-1] != dp:
        return _pad_head(t, dp)
    if dp > _VECTOR_MAX_HEAD_DIM:
        return t
    return _cp_async_ready(t)


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


def _mapped(*xs) -> bool:
    """Whether an operand is a ``torch.func`` transform's wrapper (a vmap
    batch, a grad level): the call then goes through
    :class:`FlashAttentionFunction`, whose rules fold the mapped axis."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(x is not None and wrapped(x) for x in xs)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, kv_mask=None,
                    return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention forward; [B,H,S,D] -> [B,H,S,D] in the input dtype
    (plus the [B,H,S] float32 logsumexp with ``return_lse``). ``kv_mask`` is
    an optional [B, S_k] key-padding mask (1 = attend); ``causal`` masks key
    j > query i (positions counted from 0 on both axes).

    On the card this launches ``csrc/flash_fwd.cu`` (the port of the TPU
    ``_flash_kernel``) on the tensor cores: in bf16 for bfloat16 operands
    (P rounded to bfloat16 before P V, as the TPU kernel does), in 3xTF32
    for float32 ones (each product as three TF32 products of a big/small
    split, float32-accurate; P not rounded). q/k/v may be strided views (the
    model passes slices of one qkv permutation) as long as ``head_dim`` is
    contiguous; an operand whose rows are not 16-byte aligned is copied
    first (:func:`_cp_async_ready`). The output is allocated
    [B,S,H,D]-contiguous and returned as its [B,H,S,D] view, so the caller's
    transpose back to [B,S,H*D] is free. A head_dim that is not a multiple
    of 8 below 256 runs on q/k/v zero-padded to one (:func:`_pad_head`) and
    returns the first head_dim columns of the padded output; above 256 the
    column-sliced kernel of ``csrc/flash_sliced.cu`` runs (CUDA cores,
    float32 arithmetic, at most 256 output columns a block).

    When grad mode is on and q, k or v requires a gradient, the call runs
    as :class:`FlashAttentionFunction`: the forward saves q, k, v, the mask,
    O and the logsumexp, and the backward is
    :func:`flash_attention_backward` (``csrc/flash_bwd.cu`` on the card,
    the plain recurrence on the CPU). ``kv_mask`` gets no gradient."""
    _check_shapes("flash_attention", q, k, v)
    b, h, s, d = q.shape
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                     or v.requires_grad)) or _mapped(
                                         q, k, v, kv_mask):
        out, lse = FlashAttentionFunction.apply(q, k, v, kv_mask,
                                                bool(causal), float(scale))
        return (out, lse) if return_lse else out
    path = _route(q)
    _LAST_PATH.set(path)
    if path == "reference":
        return attention_reference(q, k, v, causal, scale, kv_mask=kv_mask,
                                   return_lse=return_lse)
    q, k, v, kv_mask = _flash_operands("flash_attention", q, k, v, kv_mask)
    dp = _flash_head(d)
    q, k, v = (_launch_ready(t, dp) for t in (q, k, v))
    out = torch.empty((b, s, h, dp), dtype=q.dtype,
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
            b, h, s, sk, dp, ctypes.addressof(strides), float(scale),
            int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_fwd")
        _count(flash_attention, "launches")
    out = _trim_head(out, d)
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


def _cp_async_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if the tensor-core flash kernels can stream it with
    16-byte ``cp.async`` copies (pointer 16-byte aligned, batch/head/seq
    strides multiples of 16 bytes: 8 bf16 or 4 float32 elements), else a
    contiguous copy in fresh (aligned) memory — a layout copy, the same
    values."""
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3]):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


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
    *ts, kv_mask = _flash_operands(name, q, k, v, kv_mask, dout)
    dp = _flash_head(q.shape[-1])
    return (*(_launch_ready(t, dp) for t in ts), kv_mask)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = False,
                 sm_scale: Optional[float] = None, kv_mask=None
                 ) -> torch.Tensor:
    """dQ of flash attention from the forward's logsumexp ``lse`` and
    ``delta`` = rowsum(dO * O), both [B,H,S] float32. On the card this
    launches the dq kernel of ``csrc/flash_bwd.cu`` (the port of the TPU
    ``_flash_bwd_dq_kernel``) on the tensor cores: in bf16 for bfloat16
    operands (P and dS rounded to bfloat16 before the second product), in
    3xTF32 for float32 ones (each product as three TF32 products of a
    big/small split, float32-accurate); above head_dim 128, the
    instantiations of ``csrc/flash_bwd_wide.cu``. Operands whose rows are
    not 16-byte aligned are copied first (:func:`_cp_async_ready`). dQ is
    allocated [B,S,H,D]-contiguous and returned as its [B,H,S,D] view, like
    the forward's output. Other head_dims as in :func:`flash_attention`:
    zero-padded operands below 256, the column-sliced kernel of
    ``csrc/flash_sliced.cu`` above."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _route(q) == "reference":
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal,
                                      scale, kv_mask)
    d = q.shape[-1]
    q, k, v, dout, mask = _bwd_operands("flash_bwd_dq", q, k, v, dout,
                                        lse, delta, kv_mask)
    b, h, s, dp = q.shape
    dq = torch.empty((b, s, h, dp), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    if dq.numel():
        from . import _build
        lib = _build.load()
        strides = _seq_strides(q, k, v, dout, dq)
        rc = lib.sf_flash_bwd_dq(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            mask.data_ptr() if mask is not None else None, dq.data_ptr(),
            b, h, s, k.shape[2], dp, ctypes.addressof(strides), float(scale),
            int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_bwd_dq")
        _count(flash_bwd_dq, "launches")
    return _trim_head(dq, d)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                  sm_scale: Optional[float] = None, kv_mask=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of flash attention; operands as :func:`flash_bwd_dq`. On the
    card this launches the dk/dv kernel of ``csrc/flash_bwd.cu`` (the port
    of the TPU ``_flash_bwd_dkv_kernel``), by dtype as there; above
    head_dim 128 one call launches two kernels of ``csrc/flash_bwd_wide.cu``,
    dV's and dK's (one launch count, as one call of the TPU kernel). Other
    head_dims as in :func:`flash_bwd_dq`."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _route(q) == "reference":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                       scale, kv_mask)
    d = q.shape[-1]
    q, k, v, dout, mask = _bwd_operands("flash_bwd_dkv", q, k, v, dout,
                                        lse, delta, kv_mask)
    b, h, sk, dp = k.shape
    dk = torch.empty((b, sk, h, dp), dtype=k.dtype,
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
            dv.data_ptr(), b, h, q.shape[2], sk, dp,
            ctypes.addressof(strides), float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_bwd_dkv")
        _count(flash_bwd_dkv, "launches")
    return _trim_head(dk, d), _trim_head(dv, d)


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


def _fold(x, dim, k: int):
    """A ``torch.func.vmap`` operand with its mapped axis ``dim`` (None: not
    mapped) folded into dim 0 — the batch — of ``k`` copies: [K*B, ...]."""
    if x is None:
        return None
    if dim is None:
        x = x.unsqueeze(0).expand((k,) + tuple(x.shape))
    else:
        x = x.movedim(dim, 0)
    return x.reshape((k * x.shape[1],) + tuple(x.shape[2:]))


def _vmap_size(in_dims, *xs) -> int:
    return next(x.shape[d] for x, d in zip(xs, in_dims)
                if x is not None and d is not None)


def _unfold(x, k: int):
    return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention — the counterpart of the JAX package's
    ``jax.custom_vjp`` ``_flash``. ``apply(q, k, v, kv_mask, causal, scale)
    -> (out, lse)``; ``lse`` carries no gradient, nor does ``kv_mask``.

    Written in the form ``torch.func`` takes (``forward`` without ``ctx``,
    ``setup_context``), with a batching rule: under ``torch.func.vmap`` the
    mapped axis folds into B (the mask's with it), so K mapped replicas
    launch the forward kernel once, as JAX's ``pallas_call`` batching rule
    adds a grid axis; under ``torch.func`` the backward
    (:class:`_FlashBackward`) folds the same way, and outside it calls the
    backward kernels directly."""

    @staticmethod
    def forward(q, k, v, kv_mask, causal, scale):
        return flash_attention(q, k, v, causal, scale, kv_mask=kv_mask,
                               return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, kv_mask, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        if not _mapped(q, dout):
            dq, dk, dv = flash_attention_backward(
                q, k, v, out, lse, dout, ctx.causal, ctx.scale, kv_mask)
        else:
            # under torch.func: the backward's own batching rule
            dq, dk, dv = _FlashBackward.apply(q, k, v, kv_mask, out, lse,
                                              dout.contiguous(), ctx.causal,
                                              ctx.scale)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, kv_mask, causal, scale):
        n = info.batch_size
        qd, kd, vd, md = in_dims[:4]
        out, lse = FlashAttentionFunction.apply(
            _fold(q, qd, n), _fold(k, kd, n), _fold(v, vd, n),
            _fold(kv_mask, md, n), causal, scale)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashBackward(torch.autograd.Function):
    """``(dq, dk, dv)`` of :class:`FlashAttentionFunction` — the dq and dk/dv
    kernels on the card — with the same batching rule (K mapped replicas:
    one launch of each)."""

    @staticmethod
    def forward(q, k, v, kv_mask, out, lse, dout, causal, scale):
        return flash_attention_backward(q, k, v, out, lse, dout, causal,
                                        scale, kv_mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, kv_mask, out, lse, dout, causal,
             scale):
        n = info.batch_size
        args = [_fold(x, d, n) for x, d in zip(
            (q, k, v, kv_mask, out, lse, dout), in_dims[:7])]
        grads = _FlashBackward.apply(*args, causal, scale)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


# ---------------------------------------------------------------------------
# Paged attention (decode) and paged verify attention (speculative decode)
#
# The pool is [num_pages, page_size, H, D]. It holds the compute dtype
# (float32 or bfloat16, the query's), or is quantized: int8 or float8_e4m3fn
# rows with [num_pages, H] float32 scales, row = stored * scale[page, head]
# (see utils/quant.py). A quantized pool is never dequantized as a whole:
# the plain versions convert the gathered pages only, the kernels fold the K
# scale into the scores and the V scale into the PV update.
# ---------------------------------------------------------------------------

#: quantized pool element type -> the kernels' pool code
_POOL_CODE = {torch.int8: 0}
if hasattr(torch, "float8_e4m3fn"):
    _POOL_CODE[torch.float8_e4m3fn] = 1

#: tokens a thread block of the decode kernel walks, at the least, and the
#: most blocks (the portable thread-block cluster size) one (slot, head)'s
#: walk is split over
DECODE_CHUNK = 128
DECODE_MAX_BLOCKS = 8
#: pool rows a decode block loads in one trip, at one lane a row: its 8
#: warps x 32 lanes x 4 rows a lane in flight (``kWarps`` x 32 x
#: ``kUnroll`` in ``csrc/paged_attention.cu``)
_DECODE_TRIP_LANES = 8 * 32 * 4


def _decode_trip(d: int, itemsize: int) -> int:
    """Tokens one block of the decode kernel loads in a single trip: a lane
    loads a 16-byte run of a row (8 bytes for an int8/fp8 row whose ``d`` is
    not a multiple of 16), and a power of two of runs covers the row. Up to
    32 runs a row, one lane holds one run; a row of 64 runs (a float32 row
    above 128 elements) takes 32 lanes holding two runs each, with half as
    many rows a lane in flight (``NR`` and ``kU`` in the kernel), so the
    trip is the same count of rows either way."""
    run = 16 if itemsize > 1 or d % 16 == 0 else 8
    runs = 1
    while runs * run < d * itemsize:
        runs *= 2
    return _DECODE_TRIP_LANES // runs


def _paged_split(max_pages: int, page: int, d: int,
                 itemsize: int) -> Tuple[int, int]:
    """``(chunk, blocks)``: how the decode kernel splits the walk of each
    (slot, head) over one thread-block cluster, from the table's width and
    the pool's row (``d`` elements of ``itemsize`` bytes) alone, never from
    ``lengths``. A chunk is ``DECODE_CHUNK`` tokens or, where a block loads
    more in one trip (an int8/fp8 row at D = 64: 256), that trip — fewer
    blocks wait at the cluster barrier and the launch fits the card in one
    wave; up to ``DECODE_MAX_BLOCKS`` blocks, past which the chunk grows to
    a ``DECODE_MAX_BLOCKS``-th of the table's tokens. The chunk is rounded
    up to a whole page."""
    tokens = max_pages * page
    chunk = max(DECODE_CHUNK, _decode_trip(d, itemsize),
                -(-tokens // DECODE_MAX_BLOCKS))
    chunk = -(-chunk // page) * page
    return chunk, max(1, -(-tokens // chunk))


def _check_scales_given(k_scales, v_scales) -> None:
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")


def _check_paged_shapes(name: str, b: int, h: int, d: int, k_pages, v_pages,
                        page_table, per_slot, k_scales, v_scales) -> None:
    """Pools [P, page, H, D], table [B, max_pages], ``per_slot`` (lengths
    or start) [B], scales [P, H]."""
    num_pages, page = k_pages.shape[:2]
    if (tuple(k_pages.shape) != (num_pages, page, h, d)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match H={h}, D={d}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(per_slot.shape) != (b,):
        raise ValueError(f"{name}: page_table must be [B, max_pages] and "
                         f"lengths/start [B] with B={b}")
    for sc in (k_scales, v_scales):
        if sc is not None and tuple(sc.shape) != (num_pages, h):
            raise ValueError(f"{name}: scales {tuple(sc.shape)} are not "
                             f"[num_pages, H] = {(num_pages, h)}")


def _paged_operands(name: str, q, k_pages, v_pages, page_table, k_scales,
                    v_scales):
    """Check the paged kernels' operands and ready them for a launch:
    returns ``(k_pages, v_pages, table, k_scales, v_scales, pool_code)`` —
    pools contiguous, table int32, scales float32, ``pool_code`` None for a
    pool in the query's dtype."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16 "
                        f"queries, got {q.dtype}")
    for t in (k_pages, v_pages, page_table, k_scales, v_scales):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and {q.device}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: k_pages {k_pages.dtype} and v_pages "
                        f"{v_pages.dtype} differ")
    code = None
    if k_scales is None:
        if k_pages.dtype != q.dtype:
            raise TypeError(f"{name}: a pool without scales holds the "
                            f"query's dtype; got pool {k_pages.dtype}, query "
                            f"{q.dtype}")
    else:
        code = _POOL_CODE.get(k_pages.dtype)
        if code is None:
            raise TypeError(f"{name}: a pool with scales is int8 or "
                            f"float8_e4m3fn, got {k_pages.dtype}")
        k_scales = k_scales.to(torch.float32).contiguous()
        v_scales = v_scales.to(torch.float32).contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: pools must be 16-byte aligned")
    return (k_pages, v_pages, page_table.to(torch.int32).contiguous(),
            k_scales, v_scales, code)


def _gather_dequant(pages, page_table, scales) -> torch.Tensor:
    """Gather each slot's pages and (when quantized) apply the
    per-page-per-head scales: ``[num_pages, page, H, D]`` x ``[B, maxp]``
    -> ``[B, maxp*page, H, D]`` float32. The conversion runs on the gathered
    pages only, never on the whole pool."""
    b, maxp = page_table.shape
    page, h, d = pages.shape[1:]
    idx = page_table.long()
    g = pages[idx].float()                            # [B, maxp, page, H, D]
    if scales is not None:
        g = g * scales[idx].float()[:, :, None, :, None]
    return g.reshape(b, maxp * page, h, d)


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              sm_scale: Optional[float] = None,
                              k_scales=None, v_scales=None):
    """Ground-truth decode attention over a paged KV pool.

    - ``q``: ``[B, H, D]`` — the current token's query per slot;
    - ``k_pages`` / ``v_pages``: ``[num_pages, page_size, H, D]`` pool;
    - ``page_table``: ``[B, max_pages]`` int — slot b's cache lives in pages
      ``page_table[b, :ceil(lengths[b]/page_size)]``, in order (entries past
      that count must still be valid pool indices);
    - ``lengths``: ``[B]`` int — valid tokens per slot; position
      ``p * page_size + t < lengths[b]`` attends. A slot with
      ``lengths == 0`` returns exact zeros;
    - ``k_scales`` / ``v_scales``: optional ``[num_pages, H]`` float32
      scales of an int8/fp8 pool (``row = stored * scale``); both or
      neither.
    """
    _check_scales_given(k_scales, v_scales)
    b, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    k = _gather_dequant(k_pages, page_table, k_scales)
    v = _gather_dequant(v_pages, page_table, v_scales)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    # all-masked rows softmax to uniform garbage; empty slots must be zeros
    out = torch.where((lengths.to(q.device) > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, lengths,
                    sm_scale: Optional[float] = None,
                    k_scales=None, v_scales=None) -> torch.Tensor:
    """Decode attention: one query token per slot against a page-table-
    indirected K/V pool. Same operands and semantics as
    :func:`paged_attention_reference`. On the card an unquantized pool
    launches ``paged_attention_kernel`` of ``csrc/paged_attention.cu`` (the
    port of the TPU ``_paged_kernel``; counter ``paged_attention.launches``)
    and an int8/fp8 pool with ``k_scales``/``v_scales`` its quantized
    instantiation (the port of ``_paged_kernel_quant``; counter
    ``paged_attention.quant_launches``): the walk of each (slot, head) is
    split over one thread-block cluster (:func:`_paged_split`, sized from
    ``page_table``'s width and the pool's row, so the host never reads
    ``lengths``), each block walks only its chunk's tokens below
    ``lengths[b]``, and the blocks merge their partial softmax states
    through distributed shared memory, in a fixed order — one launch,
    nothing allocated but the output. At a head_dim that kernel does not
    take (above 256, or not a multiple of 8) the same call launches the
    column-sliced kernel of ``csrc/paged_sliced.cu`` over the same pool,
    never copied (same counters)."""
    _check_scales_given(k_scales, v_scales)
    b, h, d = q.shape
    _check_paged_shapes("paged_attention", b, h, d, k_pages, v_pages,
                        page_table, lengths, k_scales, v_scales)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    path = _route(q)
    _LAST_PATH.set(path)
    if path == "reference":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, scale, k_scales, v_scales)
    kp, vp, table, ks, vs, code = _paged_operands(
        "paged_attention", q, k_pages, v_pages, page_table, k_scales,
        v_scales)
    if q.stride(-1) != 1:
        q = q.contiguous()
    if lengths.device != q.device:
        raise ValueError(f"paged_attention: lengths on {lengths.device}")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel():
        from . import _build
        lib = _build.load()
        maxp, page = table.shape[1], kp.shape[1]
        chunk, blocks = _paged_split(maxp, page, d, kp.element_size())
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if code is None:
            rc = lib.sf_paged_attention(
                _DTYPE_CODE[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
                kp.data_ptr(), vp.data_ptr(), table.data_ptr(), maxp,
                lens.data_ptr(), out.data_ptr(), b, h, d, page, chunk, blocks,
                float(scale), stream)
            _build.check(rc, "paged_attention")
            _count(paged_attention, "launches")
        else:
            rc = lib.sf_paged_attention_quant(
                _DTYPE_CODE[q.dtype], code, q.data_ptr(), q.stride(0),
                q.stride(1), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), table.data_ptr(), maxp, lens.data_ptr(),
                out.data_ptr(), b, h, d, page, chunk, blocks, float(scale),
                stream)
            _build.check(rc, "paged_attention_quant")
            _count(paged_attention, "quant_launches")
    return out


paged_attention.launches = 0
paged_attention.quant_launches = 0


def paged_attention_verify_reference(q, k_pages, v_pages, page_table, start,
                                     sm_scale: Optional[float] = None,
                                     k_scales=None, v_scales=None):
    """Ground-truth multi-position decode attention over a paged KV pool.

    The speculative verify step scores ``S = k + 1`` consecutive positions
    per slot in one call: slot b's query ``s`` sits at absolute position
    ``start[b] + s`` and attends causally over everything at or before it.

    - ``q``: ``[B, H, S, D]``;
    - pools, ``page_table`` and scales as in
      :func:`paged_attention_reference`, with the K/V of all S positions
      already written;
    - ``start``: ``[B]`` int — tokens committed before this chunk; query
      ``s`` attends positions ``<= start[b] + s``, so ``S == 1`` is
      :func:`paged_attention_reference` with ``lengths = start + 1``.

    Every query attends at least itself, so there is no empty-slot case.
    """
    _check_scales_given(k_scales, v_scales)
    b, h, s, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    k = _gather_dequant(k_pages, page_table, k_scales)
    v = _gather_dequant(v_pages, page_table, v_scales)
    att = torch.einsum("bhsd,bkhd->bhsk", q.float(), k) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    qpos = (start.to(q.device).long()[:, None]
            + torch.arange(s, device=q.device)[None, :])        # [B, S]
    valid = pos[None, None, :] <= qpos[:, :, None]              # [B, S, K]
    att = torch.where(valid[:, None], att, NEG_INF)
    p = torch.softmax(att, dim=-1)
    return torch.einsum("bhsk,bkhd->bhsd", p, v).to(q.dtype)


def paged_attention_verify(q, k_pages, v_pages, page_table, start,
                           sm_scale: Optional[float] = None,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """Speculative-verify attention: ``S`` consecutive query positions per
    slot against the page-table-indirected K/V pool, causal per query. Same
    operands and semantics as :func:`paged_attention_verify_reference`.

    On the card this launches ``csrc/paged_verify.cu`` — the port of the
    TPU ``_paged_verify_kernel`` (counter
    ``paged_attention_verify.launches``) or, for an int8/fp8 pool with
    scales, of ``_paged_verify_kernel_quant`` (counter
    ``paged_attention_verify.quant_launches``; one count per call, which
    launches the split and the combine kernel). The walk of each (slot,
    head) is split into chunks of 128 tokens, one thread block each, that
    read every K/V row once and score it for all S queries; the combine
    kernel folds the chunks' partial softmax states, in order, into O. The
    partial states live in float32 scratch allocated here per call, sized
    from ``page_table``'s width, so the host never reads ``start``. A block
    scores a group of 16 query rows; S above 16 (``spec_k`` above 15) runs
    one split launch a group within the call (one count). q may be a strided view with ``head_dim``
    contiguous; the output is allocated [B,S,H,D]-contiguous and returned as
    its [B,H,S,D] view. At a head_dim the split kernel does not take (above
    256, or not a multiple of 8) the same call launches the column-sliced
    kernel of ``csrc/paged_sliced.cu`` (one block a query row and column
    slice, no scratch) over the same pool."""
    _check_scales_given(k_scales, v_scales)
    b, h, s, d = q.shape
    _check_paged_shapes("paged_attention_verify", b, h, d, k_pages, v_pages,
                        page_table, start, k_scales, v_scales)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    path = _route(q)
    _LAST_PATH.set(path)
    if path == "reference":
        return paged_attention_verify_reference(
            q, k_pages, v_pages, page_table, start, scale, k_scales,
            v_scales)
    kp, vp, table, ks, vs, code = _paged_operands(
        "paged_attention_verify", q, k_pages, v_pages, page_table, k_scales,
        v_scales)
    if q.stride(-1) != 1:
        q = q.contiguous()
    if start.device != q.device:
        raise ValueError(f"paged_attention_verify: start on {start.device}")
    st = start.to(torch.int32).contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel():
        from . import _build
        lib = _build.load()
        strides = _seq_strides(q, out)
        maxp, page = table.shape[1], kp.shape[1]
        chunk = lib.sf_paged_verify_chunk()
        nchunks = -(-maxp * page // chunk)
        part_acc = part_ml = None
        if _vector_head(d):   # the split kernel's scratch
            part_acc = torch.empty((b, h, nchunks, s, d), dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty((b, h, nchunks, s, 2), dtype=torch.float32,
                                  device=q.device)
        rc = lib.sf_paged_verify(
            _DTYPE_CODE[q.dtype], -1 if code is None else code, q.data_ptr(),
            kp.data_ptr(), vp.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None,
            table.data_ptr(), maxp, st.data_ptr(), out.data_ptr(),
            part_acc.data_ptr() if part_acc is not None else None,
            part_ml.data_ptr() if part_ml is not None else None, nchunks,
            b, h, s, d,
            page, ctypes.addressof(strides), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "paged_attention_verify")
        if code is None:
            _count(paged_attention_verify, "launches")
        else:
            _count(paged_attention_verify, "quant_launches")
    return out


paged_attention_verify.launches = 0
paged_attention_verify.quant_launches = 0


# ---------------------------------------------------------------------------
# Ring attention (sequence parallelism over a mesh axis)
#
# q/k/v hold this rank's sequence shard [B,H,S_local,D] (shard i covers
# positions [i * S_local, (i + 1) * S_local)); K/V and the key mask rotate
# around the axis ring with collectives.ppermute_ring, on every rank of the
# bound mesh (parallel.mesh.Mesh.bind). Not a kernel of its own:
# ring_flash_attention composes kernels 1-3 per visit.
# ---------------------------------------------------------------------------


def _block_stats(q, k, v, scale, causal, q_offset, k_offset, kv_mask=None):
    """One blockwise attention step -> (acc, m, l) in float32."""
    s = _masked_scores(q, k, scale, causal, kv_mask, q_offset, k_offset)
    m = s.amax(dim=-1, keepdim=True)                            # [B,H,Sq,1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return acc, m, l


def _merge_stats(acc, m, l, a2, m2, l2):
    """Fold one blockwise (acc, max, sum) triple into the running online
    softmax state."""
    m_new = torch.maximum(m, m2)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m2 - m_new)
    return acc * alpha + a2 * beta, m_new, l * alpha + l2 * beta


class _RingShift(torch.autograd.Function):
    """``ppermute`` by +1 along the axis; its backward shifts by -1 (the
    transpose), so the plain ring differentiates through its rotations."""

    @staticmethod
    def forward(ctx, axis_name, *xs):
        from ..parallel.collectives import ppermute_ring
        from ..parallel.mesh import bound_mesh
        ctx.axis_name, ctx.mesh = axis_name, bound_mesh()
        return ppermute_ring(tuple(x.detach() for x in xs), axis_name, 1)

    @staticmethod
    def backward(ctx, *gs):
        from ..parallel.collectives import ppermute_ring
        # autograd runs a CUDA backward on its own thread: bind the mesh
        with ctx.mesh.bind():
            return (None,) + tuple(ppermute_ring(
                tuple(g.contiguous() for g in gs), ctx.axis_name, -1))


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   sm_scale: Optional[float] = None, kv_mask=None):
    """The plain ring: attention where q/k/v are sequence-sharded over
    ``axis_name`` (the JAX package's ``ring_attention``). K/V (and the
    optional [B, S_local] ``kv_mask``) rotate around the ring; the online
    softmax statistics merge per visit in float32. Differentiable by
    autograd (a rotation's transpose is the rotation the other way)."""
    from ..parallel.collectives import axis_index, axis_size
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    n, idx = axis_size(axis_name), axis_index(axis_name)
    b, h, sl, _ = q.shape
    acc = q.new_zeros((b, h, sl, d), dtype=torch.float32)
    m = q.new_full((b, h, sl, 1), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, sl, 1), dtype=torch.float32)
    kc, vc, mc = k, v, kv_mask
    for step in range(n):
        # the k/v block resident now came from rank (idx - step) % n
        src = (idx - step) % n
        acc, m, l = _merge_stats(acc, m, l, *_block_stats(
            q, kc, vc, scale, causal, idx * sl, src * sl, mc))
        if step < n - 1:
            moved = _RingShift.apply(axis_name, kc, vc,
                                     *(() if mc is None else (mc,)))
            kc, vc = moved[0], moved[1]
            mc = moved[2] if mc is not None else None
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _ring_cases(causal: bool, n: int, idx: int):
    """Per visit ``local_causal``, or None for a skipped visit: with equal
    shards causality is three whole-block cases — source strictly behind
    (full attention), the same shard (locally causal: the local diagonal IS
    the global one), strictly ahead (no contribution, no launch)."""
    out = []
    for step in range(n):
        src = (idx - step) % n
        out.append(False if not causal or src < idx
                   else True if src == idx else None)
    return out


class RingFlashAttentionFunction(torch.autograd.Function):
    """Ring attention over kernels 1-3 — the JAX package's ``_ring_flash``
    (a ``jax.custom_vjp``). ``apply(q, k, v, kv_mask, axis_name, causal,
    scale) -> out``.

    Forward: kernel 1 (:func:`flash_attention` with ``return_lse``) per
    visit, merged exactly through the logsumexp weights ``o = sum_i o_i *
    exp(lse_i - lse)``, ``lse = logaddexp_i lse_i``. Backward: ``delta =
    rowsum(dO * O)`` once, then kernels 2-3 (:func:`flash_bwd_dq`,
    :func:`flash_bwd_dkv`) per visit with the GLOBAL logsumexp, so each
    visit's contribution is exact and they just sum; the dK/dV accumulators
    rotate with their K/V shard and arrive home after the last visit. A
    skipped causal visit launches nothing."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, axis_name, causal, scale):
        from ..parallel.collectives import axis_index, axis_size, ppermute_ring
        n, idx = axis_size(axis_name), axis_index(axis_name)
        b, h, sl, d = q.shape
        o = q.new_zeros((b, h, sl, d), dtype=torch.float32)
        lse = q.new_full((b, h, sl), NEG_INF, dtype=torch.float32)
        kc, vc, mc = k, v, kv_mask
        for step, local_causal in enumerate(_ring_cases(causal, n, idx)):
            if local_causal is None:
                o2 = torch.zeros_like(o)
                lse2 = torch.full_like(lse, NEG_INF)
            else:
                o2, lse2 = flash_attention(q, kc, vc, local_causal, scale,
                                           kv_mask=mc, return_lse=True)
            # exact merge through the logsumexp weights
            lse_new = torch.logaddexp(lse, lse2)
            o = (o * torch.exp(lse - lse_new)[..., None]
                 + o2.float() * torch.exp(lse2 - lse_new)[..., None])
            lse = lse_new
            if step < n - 1:
                moved = ppermute_ring((kc, vc) + (() if mc is None
                                                  else (mc,)), axis_name)
                kc, vc = moved[0], moved[1]
                mc = moved[2] if mc is not None else None
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.axis_name, ctx.causal, ctx.scale = axis_name, causal, scale
        from ..parallel.mesh import bound_mesh
        ctx.mesh = bound_mesh()
        return out

    @staticmethod
    def backward(ctx, dout):
        # autograd runs a CUDA backward on its own thread: bind the mesh
        with ctx.mesh.bind():
            return RingFlashAttentionFunction._backward(ctx, dout)

    @staticmethod
    def _backward(ctx, dout):
        from ..parallel.collectives import axis_index, axis_size, ppermute_ring
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        n, idx = axis_size(ctx.axis_name), axis_index(ctx.axis_name)
        dout = dout.contiguous()
        # the q-side quantities never change across visits: computed once
        delta = _bwd_delta(out, dout)
        lse = lse.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc, mc = k, v, kv_mask
        for step, local_causal in enumerate(_ring_cases(ctx.causal, n, idx)):
            if local_causal is not None:
                dq += flash_bwd_dq(q, kc, vc, dout, lse, delta, local_causal,
                                   ctx.scale, mc).float()
                dk2, dv2 = flash_bwd_dkv(q, kc, vc, dout, lse, delta,
                                         local_causal, ctx.scale, mc)
                dk += dk2.float()
                dv += dv2.float()
            # the accumulators travel with their shard: after the n-th
            # rotation they are home, and K/V need no last trip
            last = step == n - 1
            carry = (dk, dv) + (() if last else (kc, vc)) + (
                () if last or mc is None else (mc,))
            moved = ppermute_ring(carry, ctx.axis_name)
            dk, dv = moved[0], moved[1]
            if not last:
                kc, vc = moved[2], moved[3]
                mc = moved[4] if mc is not None else None
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_flash_attention(q, k, v, axis_name: str, causal: bool = False,
                         sm_scale: Optional[float] = None, kv_mask=None):
    """Ring attention whose per-visit block compute is the flash kernels
    (the JAX package's ``ring_flash_attention``): q/k/v [B,H,S_local,D] are
    this rank's sequence shard, ``kv_mask`` [B,S_local] its key-padding
    mask; returns the local output shard. On the card each visit launches
    kernel 1 (forward) and kernels 2-3 (backward), counted by their
    wrappers' launch counters, or raises; on CPU tensors the visits run the
    plain versions. The kernels take every shape, so there is no fallback
    to the plain ring for untiled shapes as in JAX."""
    _check_shapes("ring_flash_attention", q, k, v)
    if k.shape[2] != q.shape[2]:
        raise ValueError("ring_flash_attention: the q and k/v shards must "
                         "have the same sequence length")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32)
    return RingFlashAttentionFunction.apply(q, k, v, kv_mask, axis_name,
                                            bool(causal), float(scale))


# wrappers launch from several threads at once (the elastic engine's
# replicas): a counter's read-add-write happens under this lock
_COUNT_LOCK = threading.Lock()


def _count(wrapper, attr: str) -> None:
    """Add one to ``wrapper.<attr>``, the launch counter of a kernel."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last
    :func:`reset_launch_counts`, by kernel name."""
    return {"flash_fwd": flash_attention.launches,
            "flash_bwd_dq": flash_bwd_dq.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches,
            "paged_attention": paged_attention.launches,
            "paged_attention_quant": paged_attention.quant_launches,
            "paged_verify": paged_attention_verify.launches,
            "paged_verify_quant": paged_attention_verify.quant_launches}


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counters."""
    flash_attention.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0
    paged_attention.launches = 0
    paged_attention.quant_launches = 0
    paged_attention_verify.launches = 0
    paged_attention_verify.quant_launches = 0
