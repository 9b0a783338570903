"""int8 weight quantization and the quantized paged-KV pool — the port of
the JAX package's ``utils/quant.py``.

**Weights.** A trained params tree quantizes to symmetric
per-output-channel int8 for serving (:func:`quantize_params`): each
selected ``kernel`` leaf becomes ``kernel_q8`` (int8) + ``kernel_scale``
(float32 per output channel), and the models' projections
(``models/transformer.py`` ``_proj``, ``graphdef.py`` dense / conv2d)
consume that form. Two modes, a property of the serving model
(``quant_mode``), not of the tree:

- ``weight_only``: the kernel is dequantized to the activation's dtype at
  the matmul; activations are untouched;
- ``dynamic``: activations are also quantized per row at run time (absmax
  over the contraction) and the product runs int8 x int8 -> int32
  (:func:`int8_matmul`, ``torch._int_mm``) before the int32 accumulator is
  rescaled by ``row_scale x channel_scale``.

Conv kernels always serve weight-only. Numerics follow the JAX package bit
for bit: ``w / scale`` in float32, rounding half to even (``torch.round``
as ``jnp.round``), clipping at +-127, so the ``q8`` and ``scale`` leaves
equal JAX's for the same weights.

**KV pool.** The serving pool stores K/V
rows in int8 or fp8 (e4m3, ``torch.float8_e4m3fn``) with ONE float32 scale
per (layer, page, head), kept in a tensor beside the rows: dequantized row =
stored row * scale[page, head]. A scale of 0 marks a page-head nothing
nonzero was ever written to — its stored rows are exact zeros, so readers
multiply by the raw scale without a guard and still get exact zeros.

Appends keep the scale as a RUNNING absmax: when a new row raises a
page-head's absmax, the page's stored rows are rescaled in place
(``q_new = cast(q_old * old_scale / new_scale)``) so every row in a page
shares the page's current scale. A row landing at offset 0 resets the
running max — the page is being reused and its earlier content (and scale)
is stale. Only the pages being written are touched, never the whole pool.

Numerics follow the JAX package bit for bit: int8 rounds half to even
(``torch.round`` as ``jnp.round``) and clips at +-127; fp8 clamps to +-448
BEFORE the cast (an out-of-range cast to e4m3fn gives NaN in torch) and
rounds to nearest even in the cast. The scale plane is updated by a true
scatter-max (``scatter_reduce_`` with ``"amax"``): several rows may land in
one page (a verify chunk, masked lanes all aimed at scratch page 0), and
plain index assignment would keep an arbitrary one of them.

The pool functions update ``q_pool`` and ``scales`` in place (the JAX
versions return new arrays) and return them for symmetry.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

MODES = ("weight_only", "dynamic")

#: pool layouts the paged KV cache can serve ("bf16" is the unquantized
#: compute-dtype pool; int8/fp8 store quantized rows + per-page-per-head
#: float32 scales)
KV_DTYPES = ("bf16", "int8", "fp8")

_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
#: symmetric quantization ceilings: int8 clips at +-127, e4m3 saturates at
#: +-448 (the format's largest finite value)
_KV_QMAX = {"int8": 127.0, "fp8": 448.0}


# ---------------------------------------------------------------------------
# int8 weights: symmetric per-output-channel scales
# ---------------------------------------------------------------------------


def _over_127(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127`` correctly rounded on every device, as JAX divides.
    (On CUDA, ``tensor / python_scalar`` multiplies by the scalar's
    reciprocal, which can miss by one ulp; a tensor divisor divides.)"""
    return absmax / torch.full_like(absmax, 127.0)


def quantize_tensor(w, axis: int = -1):
    """Symmetric per-channel int8: returns ``(q8, scale)`` with
    ``q8 * scale ~= w``; ``scale`` keeps ``w``'s rank with size-1 axes
    everywhere except ``axis`` (broadcasts back without reshapes)."""
    w = torch.as_tensor(w).float()
    keep = axis % w.dim()
    reduce_axes = tuple(a for a in range(w.dim()) if a != keep)
    absmax = (w.abs().amax(dim=reduce_axes, keepdim=True) if reduce_axes
              else w.abs())
    scale = torch.where(absmax > 0, _over_127(absmax),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_tensor(q8, scale, dtype: torch.dtype = torch.float32):
    return (q8.float() * scale).to(dtype)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a [M, K] @ b [K, N]``, int8 x int8 -> int32, through
    ``torch._int_mm``. Its CUDA rule (M > 16, K and N multiples of 8) is met
    on every device by padding with zero rows and columns, which add
    nothing to any sum, and trimming the result. ``a`` goes in row-major
    and ``b`` column-major: on the H100, cuBLASLt refuses a row-major ``b``
    at some shapes the rule allows (M = 24, K = N = 64, for one) and runs
    the int8 product on slower kernels at others; a column-major ``b``
    takes neither path."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def int8_matmul(x, q8, scale):
    """``x @ dequant(q8)`` with the contraction in int8 x int8 -> int32.

    ``x`` [..., K] float; ``q8`` [K, N] int8; ``scale`` [1, N] (or [N])
    float32. Activations quantize per row (dynamic absmax over K); the int32
    accumulator rescales by ``row_scale * channel_scale``."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)                  # [..., 1]
    xs = torch.where(absmax > 0, _over_127(absmax), torch.ones_like(absmax))
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    n = q8.shape[-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), q8).reshape(
        *xq.shape[:-1], n)                                       # [..., N]
    return acc.float() * xs * scale.reshape((1,) * (acc.dim() - 1) + (-1,))


def quantized_dense(x, layer_params, mode: str = "weight_only",
                    compute_dtype=None, prefix: str = "kernel"):
    """Dense matmul over a possibly-quantized layer dict. Returns None when
    the layer is NOT quantized (the caller runs its normal path). The mode
    is a property of the serving model (``quant_mode``), not of the tree.
    ``prefix`` selects the kernel within a multi-projection layer dict (e.g.
    ``'qkv_kernel'`` in a transformer block); the bias is the matching
    ``*bias`` name."""
    if not isinstance(layer_params, dict) or f"{prefix}_q8" not in layer_params:
        return None
    q8 = layer_params[f"{prefix}_q8"]
    scale = layer_params[f"{prefix}_scale"]
    if mode == "dynamic" and q8.dim() == 2:
        y = int8_matmul(x, q8, scale)
    else:
        k = dequantize_tensor(q8, scale, compute_dtype or torch.promote_types(
            x.dtype, torch.float32))
        y = torch.matmul(x.to(k.dtype), k)
    bias_name = prefix[:-6] + "bias"  # 'kernel' -> 'bias', 'o_kernel' -> 'o_bias'
    if bias_name in layer_params:
        y = y + layer_params[bias_name].to(y.dtype)
    return y


def quantize_for_serving(model, params, mode: str = "weight_only",
                         min_size: int = 4096):
    """Put ``model`` into int8 serving: validate ``mode``, set the model's
    ``quant_mode``, return the quantized tree (``quantize_params`` warns if
    nothing matched). ``InferenceEngine`` places every tree, its first and
    each hot swap's, through it; ``ml_util`` caches the mode-agnostic
    ``quantize_params`` tree on the weights identity instead and sets the
    mode on its cached model."""
    if mode not in MODES:
        raise ValueError(f"quant mode must be one of {MODES}, got {mode!r}")
    model.quant_mode = mode
    return quantize_params(params, min_size=min_size)


def _is_quantizable_kernel(path_leaf: str, arr) -> bool:
    # 'kernel' (graphdef dense/conv2d, the classifier head) or the
    # transformer family's named projections ('qkv_kernel', 'o_kernel',
    # 'fc1_kernel', ...); 2-D matmul or 4-D conv kernels
    return ((path_leaf == "kernel" or path_leaf.endswith("_kernel"))
            and getattr(arr, "ndim", 0) in (2, 4))


def quantize_params(params: Dict[str, Dict[str, Any]],
                    min_size: int = 4096) -> Dict[str, Dict[str, Any]]:
    """Quantize every dense/conv ``kernel`` leaf with >= ``min_size``
    elements in a nested-dict params tree (the shape of both ``GraphModel``
    and registry trees); other leaves (biases, norms, embeddings) pass
    through untouched, on their own device. The quantized tree is
    mode-agnostic; conv kernels always serve weight-only.

    Warns when NO leaf quantized — naming conventions the matcher does not
    know, or every kernel under ``min_size``, would otherwise silently serve
    full precision while the caller believes it is int8."""

    def qlayer(layer):
        if not isinstance(layer, dict):
            return layer
        out = {}
        for name, arr in layer.items():
            if isinstance(arr, dict):
                out[name] = qlayer(arr)
                continue
            size = int(np_size(arr))
            if _is_quantizable_kernel(name, arr) and size >= min_size:
                q8, scale = quantize_tensor(arr, axis=-1)  # per out-channel
                if q8.dim() == 2:
                    # column-major: the layout the int8 product takes, so
                    # dynamic serving copies no weight per call
                    q8 = q8.t().contiguous().t()
                out[f"{name}_q8"] = q8
                out[f"{name}_scale"] = scale
            else:
                out[name] = arr
        return out

    q = {k: qlayer(v) for k, v in params.items()}

    def _count_q8(d):
        return sum(_count_q8(v) if isinstance(v, dict)
                   else int(isinstance(k, str) and k.endswith("_q8"))
                   for k, v in d.items())

    if _count_q8(q) == 0:
        logging.getLogger(__name__).warning(
            "quantize_params: no kernel leaf quantized — every matmul/conv "
            "kernel is either below min_size=%d elements or not named "
            "'kernel'/'*_kernel' (e.g. raw TF1 variables named "
            "'W'/'weights'); serving will run FULL PRECISION", min_size)
    return q


def np_size(arr) -> int:
    if torch.is_tensor(arr):
        return int(arr.numel())
    try:
        return int(arr.size)
    except TypeError:
        import numpy as np

        return int(np.asarray(arr).size)


# ---------------------------------------------------------------------------
# Quantized paged-KV pool: per-page-per-head symmetric scales
# ---------------------------------------------------------------------------


def kv_quant_supported(kv_dtype: str) -> bool:
    """True when this install can serve the given pool layout ("fp8" needs
    ``torch.float8_e4m3fn``; "bf16" and "int8" always work)."""
    return kv_dtype in KV_DTYPES and (kv_dtype != "fp8"
                                      or _FP8_DTYPE is not None)


def kv_pool_dtype(kv_dtype: str) -> Tuple[torch.dtype, float]:
    """``"int8" | "fp8" -> (storage dtype, quantization ceiling)``."""
    if kv_dtype not in ("int8", "fp8"):
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r} (bf16 pools are not quantized)")
    if kv_dtype == "fp8":
        if _FP8_DTYPE is None:
            raise ValueError(
                "kv_dtype='fp8' needs torch.float8_e4m3fn, which this torch "
                "does not expose; use 'int8'")
        return _FP8_DTYPE, _KV_QMAX["fp8"]
    return torch.int8, _KV_QMAX["int8"]


def kv_qmax(dtype: torch.dtype) -> float:
    """The quantization ceiling of a pool storage dtype."""
    return _KV_QMAX["int8"] if dtype == torch.int8 else _KV_QMAX["fp8"]


def kv_cast(x: torch.Tensor, dtype: torch.dtype, qmax: float) -> torch.Tensor:
    """float32 -> pool storage dtype with symmetric saturation. int8 rounds
    half to even; fp8 clamps first, then rounds in the e4m3 cast."""
    if dtype == torch.int8:
        return torch.round(x).clamp(-qmax, qmax).to(torch.int8)
    return x.clamp(-qmax, qmax).to(dtype)


def _quantize_blocks(pf: torch.Tensor, dtype: torch.dtype, qmax: float):
    """``pf [..., page, H, D]`` float32 -> (rows, scale [..., H]), one scale
    per trailing (page, head) block; all-zero blocks get scale 0."""
    scale = pf.abs().amax(dim=(-3, -1)) / qmax
    eff = torch.where(scale > 0, scale, torch.ones_like(scale))
    return kv_cast(pf / eff[..., None, :, None], dtype, qmax), scale


def quantize_kv_pages(pages: torch.Tensor, kv_dtype: str):
    """Quantize whole pages: ``pages [..., page, H, D]`` float ->
    ``(q [..., page, H, D], scale [..., H])`` with one symmetric scale per
    (page, head) — absmax over the page's rows and head_dim."""
    dtype, qmax = kv_pool_dtype(kv_dtype)
    return _quantize_blocks(pages.float(), dtype, qmax)


def dequantize_kv_pages(q: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_pages`: ``q [..., page, H, D]`` with
    ``scale [..., H]`` -> float pages (exact zeros where scale == 0)."""
    return (q.float() * scale[..., None, :, None]).to(dtype)


def paged_quant_write_pages(q_pool, scales, layer: int, page_ids, pages):
    """Commit whole freshly computed pages into the quantized pool (the
    prefill ladder's write): quantize each page with its own per-head scale
    and overwrite its rows and scale entries.

    ``q_pool [L, pages, page, H, D]`` int8/fp8; ``scales [L, pages, H]``
    float32; ``page_ids [N]`` int; ``pages [N, page, H, D]`` float."""
    q, scale = _quantize_blocks(pages.float(), q_pool.dtype,
                                kv_qmax(q_pool.dtype))
    pid = page_ids.long()
    q_pool[layer, pid] = q
    scales[layer, pid] = scale
    return q_pool, scales


def paged_quant_append(q_pool, scales, layer: int, page_ids, offs, rows):
    """Append rows into the quantized pool at ``(layer, page_ids, offs)``,
    keeping the per-page-per-head running scale.

    ``rows [..., H, D]`` float with ``page_ids`` / ``offs [...]`` int of the
    same leading shape (or ``offs`` broadcastable to it) — decode lanes,
    suffix-chunk tokens or the verify grid's [B, S]. Steps, on the touched
    pages only:

    1. scatter-max the new rows' absmax into the scale plane (a row at
       offset 0 first resets its page's running max: page reuse);
    2. rescale the touched pages' stored rows from the old scale to the new
       one (exact no-op where the scale did not grow);
    3. quantize the new rows with the final scale and scatter them in.

    Several rows may target one page: the scatter-max folds their maxima
    and step 2 writes the same values for every duplicate."""
    dtype = q_pool.dtype
    qmax = kv_qmax(dtype)
    num_pages, h, d = q_pool.shape[1], q_pool.shape[-2], q_pool.shape[-1]
    pids = page_ids.reshape(-1).long()
    offv = torch.broadcast_to(offs, page_ids.shape).reshape(-1).long()
    rowsf = rows.float().reshape(-1, h, d)
    rmax = rowsf.abs().amax(dim=-1)                          # [N, H]

    plane = scales[layer]                                    # [pages, H]
    fresh = torch.zeros(num_pages, dtype=torch.float32, device=plane.device)
    fresh.scatter_reduce_(0, pids, (offv == 0).float(), "amax")
    old_plane = plane * (1.0 - fresh[:, None])
    new_plane = old_plane.clone().scatter_reduce_(
        0, pids[:, None].expand(-1, h), rmax / qmax, "amax")

    eff = new_plane[pids]                                    # [N, H]
    eff = torch.where(eff > 0, eff, torch.ones_like(eff))
    rows_q = kv_cast(rowsf / eff[:, :, None], dtype, qmax)
    ratio = old_plane[pids] / eff                            # <= 1; 0 if fresh
    pages_r = kv_cast(q_pool[layer, pids].float() * ratio[:, None, :, None],
                      dtype, qmax)
    q_pool[layer, pids] = pages_r
    q_pool[layer, pids, offv] = rows_q
    scales[layer] = new_plane
    return q_pool, scales


def paged_quant_gather(q_pool, scales, layer: int, page_ids,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather and dequantize pages ``page_ids`` of one layer — the
    suffix-prefill attend's gather. The conversion runs on the gathered
    rows only, never on the whole pool."""
    pid = page_ids.long()
    g = q_pool[layer, pid].float()                           # [..., page, H, D]
    s = scales[layer, pid]                                   # [..., H]
    return (g * s[..., None, :, None]).to(dtype)
