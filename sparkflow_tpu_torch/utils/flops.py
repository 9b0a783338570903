"""FLOPs and MFU accounting — the JAX package's ``utils/flops.py``
rewritten for the card.

Model-FLOPs utilization anchors a throughput number to the hardware: a
fit's ``StepStats`` (``Trainer.fit(trace_spans=...)``) reports
``flops_per_sec`` and ``mfu`` beside examples/sec.

Two FLOPs sources:

- :func:`train_step_flops` — one train step counted by
  ``torch.utils.flop_counter.FlopCounterMode`` while it runs: the matmul
  family (``mm``, ``addmm``, ``bmm``, convolutions, SDPA), forward and
  backward, and nothing elementwise. A hand-written kernel launched through
  ``ctypes`` is invisible to it and counts zero (the JAX package's caveat for
  a Pallas call), so the count is for pure-PyTorch graphs only.
- :func:`transformer_train_step_flops` — the standard analytic count for
  transformer steps, whose attention runs in a hand-written kernel, and
  :func:`moe_train_step_flops`, the same for the MoE LM with its expert
  layers priced at the products the slot dispatch runs.

The JAX module's ``jit_flops`` (XLA's cost analysis of a compiled program)
has no counterpart: PyTorch runs eagerly and compiles nothing to price.

MFU convention (the JAX package's): model FLOPs (the useful work), not
hardware FLOPs — remat replays and padding earn no credit — over the card's
dense **bf16** peak, whatever dtype the step runs in.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

logger = logging.getLogger(__name__)

# Dense bf16 tensor-core peak per card, FLOP/s (NVIDIA data sheet, without
# sparsity, at the full power limit). Keys are substrings matched
# (lowercased) against ``torch.cuda.get_device_name()``.
_PEAK_BF16_FLOPS = (
    ("h100 80gb hbm3", 989e12),  # H100 SXM
)

# An unrecognized card is assumed to be the H100 SXM rather than reporting
# no MFU; the warning says so.
_DEFAULT_PEAK = 989e12

_WARNED_ASSUMED = False


def device_peak_flops(return_assumed: bool = False):
    """Peak dense bf16 FLOP/s of CUDA card 0, or None without a card (an MFU
    against a CPU 'peak' would be noise, not signal).

    With ``return_assumed=True`` returns ``(peak, assumed)`` where
    ``assumed`` is True when the card's name matched no table entry and the
    H100 SXM peak was assumed — an unrecognized faster card would otherwise
    report a silently wrong (possibly > 1) MFU with no indication."""
    import torch

    if not torch.cuda.is_available():
        return (None, False) if return_assumed else None
    name = torch.cuda.get_device_name(0).lower()
    for key, peak in _PEAK_BF16_FLOPS:
        if key in name:
            return (peak, False) if return_assumed else peak
    global _WARNED_ASSUMED
    if not _WARNED_ASSUMED:  # once per process
        _WARNED_ASSUMED = True
        logger.warning(
            "unrecognized CUDA card %r: assuming the H100 SXM bf16 peak "
            "(%s TFLOP/s) for MFU — treat reported MFU as approximate", name,
            _DEFAULT_PEAK / 1e12)
    return (_DEFAULT_PEAK, True) if return_assumed else _DEFAULT_PEAK


def train_step_flops(model, input_name, label_name, optimizer,
                     x, y=None, params=None) -> Optional[float]:
    """FLOPs of ONE train step (loss, gradients, optimizer update) of
    ``model`` at the rows ``x`` (a tuple for a multi-input model), counted
    by ``FlopCounterMode`` while the step runs on a float32 copy of
    ``params`` (default: ``model.init(seed=0)``, which also installs them on
    the model); the caller's tensors are not touched. Counts the matmul
    family only (see the module docstring); None when nothing was counted
    or the step fails."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..core import make_loss_fn, make_train_step
    from ..optimizers import tree_map

    dev = model.device
    try:
        if params is None:
            params = model.init(seed=0)
        params = tree_map(lambda a: torch.as_tensor(a).detach().to(
            dev, torch.float32, copy=True).requires_grad_(True), params)
        opt_state = optimizer.init(params)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=dev)
        xd = tuple(as_dev(a) for a in x) if isinstance(x, tuple) else as_dev(x)
        n = (xd[0] if isinstance(xd, tuple) else xd).shape[0]
        yd = as_dev(y) if y is not None else torch.zeros((n, 1), device=dev)
        mask = torch.ones((n,), device=dev)
        step = make_train_step(make_loss_fn(model, input_name, label_name),
                               optimizer)
        counter = FlopCounterMode(display=False)
        with counter:
            step(params, opt_state, xd, yd, mask)
        flops = float(counter.get_total_flops())
    except Exception:  # noqa: BLE001 - a count is best-effort
        logger.debug("train_step_flops failed", exc_info=True)
        return None
    return flops if flops > 0 else None


def transformer_train_step_flops(batch: int, seq: int, hidden: int,
                                 num_layers: int, mlp_dim: int,
                                 vocab_size: int = 0, num_classes: int = 0,
                                 causal: bool = False) -> float:
    """Analytic model FLOPs for one transformer train step (fwd + bwd).

    Matmul forward = 2 · tokens · matmul-params (qkv/out projections + MLP,
    plus the LM head / classifier head when given); attention forward =
    2 · 2 · B · S² · hidden per layer (QKᵀ and PV), halved when causal.
    Backward = 2 × forward; embedding gathers are free.
    """
    p_mm = num_layers * (4 * hidden * hidden + 2 * hidden * mlp_dim)
    if vocab_size:
        p_mm += hidden * vocab_size  # LM head matmul (tied or not, it runs)
    if num_classes:
        p_mm += hidden * num_classes
    tokens = batch * seq
    fwd = 2.0 * tokens * p_mm
    fwd += 4.0 * batch * seq * seq * hidden * num_layers * (
        0.5 if causal else 1.0)
    return 3.0 * fwd


def moe_train_step_flops(batch: int, seq: int, hidden: int,
                         num_layers: int, mlp_dim: int, num_experts: int,
                         moe_every: int, capacity_factor: float,
                         router_top_k: int = 1, vocab_size: int = 0,
                         causal: bool = True) -> float:
    """Analytic model FLOPs for one train step (fwd + bwd) of
    ``transformer_moe_lm``: :func:`transformer_train_step_flops` with each
    MoE layer's dense MLP replaced by the products the slot dispatch runs —
    the router (2 · N · hidden · E) and the two expert products over every
    one of the ``E · C`` slots (2 · E · C · hidden · mlp_dim each), filled
    or not, C = ceil(capacity_factor · N · k / E) over the step's N =
    batch · seq tokens. Backward = 2 × forward."""
    n = batch * seq
    e, k = int(num_experts), max(1, min(int(router_top_k), num_experts))
    every = max(1, int(moe_every))
    moe_layers = sum(1 for i in range(num_layers) if i % every == every - 1)
    cap = max(1, math.ceil(capacity_factor * n * k / e))
    dense_mlp = 2.0 * n * 2 * hidden * mlp_dim
    routed = 2.0 * n * hidden * e + 2 * (2.0 * e * cap * hidden * mlp_dim)
    return (transformer_train_step_flops(batch, seq, hidden, num_layers,
                                         mlp_dim, vocab_size=vocab_size,
                                         causal=causal)
            + 3.0 * moe_layers * (routed - dense_mlp))


def attention_flops(batch: int, heads: int, seq_q: int, seq_k: int,
                    head_dim: int, causal: bool = False,
                    with_backward: bool = False) -> float:
    """Analytic FLOPs of one attention call: QKᵀ and PV matmuls
    (2 · 2 · B · H · Sq · Sk · D forward), halved for causal masking;
    backward re-runs both plus dQ/dK/dV (≈ 2× forward)."""
    fwd = 4.0 * batch * heads * seq_q * seq_k * head_dim * (
        0.5 if causal else 1.0)
    return fwd * (3.0 if with_backward else 1.0)


def mfu(flops_per_sec: Optional[float],
        peak: Optional[float] = None) -> Optional[float]:
    """Model-FLOPs utilization, or None when either side is unknown (no
    card, or the FLOPs count failed). Nominally in [0, 1]; a value > 1
    means the FLOPs count or the peak table is wrong — warn loudly but
    return the raw ratio so the bad input is visible rather than clamped
    away."""
    if flops_per_sec is None:
        return None
    if peak is None:
        peak = device_peak_flops()
    if not peak:
        return None
    u = flops_per_sec / peak
    if u > 1.0:
        logger.warning(
            "MFU %.3f > 1: the FLOPs count or the device peak (%.0f TFLOP/s) "
            "is wrong — check device_peak_flops()'s table against this card",
            u, peak / 1e12)
    return u
