"""Quantized paged-KV pool: per-page-per-head symmetric scales.

The port of the KV layer of the JAX package's ``utils/quant.py`` (the
weight-quantization half is not ported yet). The serving pool stores K/V
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

from typing import Tuple

import torch

#: pool layouts the paged KV cache can serve ("bf16" is the unquantized
#: compute-dtype pool; int8/fp8 store quantized rows + per-page-per-head
#: float32 scales)
KV_DTYPES = ("bf16", "int8", "fp8")

_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
#: symmetric quantization ceilings: int8 clips at +-127, e4m3 saturates at
#: +-448 (the format's largest finite value)
_KV_QMAX = {"int8": 127.0, "fp8": 448.0}


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
