"""Replica cost models for the fleet simulator, fitted from measurements.

The simulator never runs a model — it *prices* each request against a
:class:`CostModel` whose coefficients come from measurements. Keeping the model
explicitly tiny (a handful of linear coefficients) is deliberate: the
point of the simulator is routing/policy dynamics at fleet scale, and for
those what matters is the *relative* cost structure (prefill scales with
prompt length, decode scales with output length and slows under
concurrency, KV pages scale with total tokens), not cycle accuracy.
:mod:`sparkflow_tpu_torch.sim.calibrate` closes the loop by replaying the same
trace against a real fleet and pinning sim-vs-real agreement.

Default coefficients (``CostModel.from_bench_notes()``) are the JAX
package's, kept value for value so that a trace replayed here gives the
same event-log digest as there. They were fitted from ``BENCH_NOTES.md``
entries that the JAX package measured on a CPU rig — they are NOT times of
this port or of any CUDA card. A card's own coefficients come from
:meth:`CostModel.fit_predict` over a live fleet (``sim/calibrate.py``;
``chip_smoke.py`` phase 15 fits ``predict_ms`` on the card):

- ``token_latency_p50_ms = 2.58`` (continuous-batching decode bench) —
  per-token decode step time at low concurrency.
- ``ttft_cold_ms = 10.9`` at ``prompt_len = 104`` (prefix-cache bench,
  cold path) — prefill throughput ~= 104 / (10.9 - overhead) tokens/ms.
- chunked-prefill bench: inter-token p95 rises from 2.58 p50 to
  ``p95_chunked_ms = 6.92`` when prefill and a full decode batch share
  the device — the ``decode_slowdown`` contention coefficient.
- quantized-KV bench: int8 pools hold ``3.76x`` pages per byte vs the
  float pool — why heterogeneous ``kv_bytes_per_page`` fleets exist at
  all (see the byte-headroom pick rule in ``serving/policies.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

__all__ = ["CostModel"]


@dataclass(frozen=True)
class CostModel:
    """Prices one replica's work in simulated seconds.

    Parameters
    ----------
    ttft_base_ms : float
        Fixed per-request overhead before the first token (dispatch,
        dequeue, kernel launch).
    prefill_tokens_per_s : float
        Prompt tokens prefilled per second.
    decode_token_ms : float
        Per-output-token decode step time with an otherwise idle batch.
    decode_slowdown : float
        Linear contention coefficient: with ``active`` of ``slots``
        decode lanes busy, the per-token time scales by
        ``1 + decode_slowdown * active / slots``. Fitted from the
        chunked-prefill bench's p50 -> p95 spread (6.92 / 2.58 at a full
        batch => slowdown ~= 1.7).
    predict_ms : float
        Flat service time for the predict (non-autoregressive) plane;
        the same contention factor applies.
    page_size : int
        KV page granularity in tokens (matches ``PagedKVCache``).
    net_rtt_ms : float
        Router<->replica round trip added to every request's latency.
    """

    ttft_base_ms: float = 2.0
    prefill_tokens_per_s: float = 9500.0
    decode_token_ms: float = 2.58
    decode_slowdown: float = 1.7
    predict_ms: float = 12.0
    page_size: int = 16
    net_rtt_ms: float = 0.5

    @staticmethod
    def from_bench_notes() -> "CostModel":
        """The JAX package's CPU-rig defaults (see module docstring)."""
        return CostModel()

    def scaled(self, factor: float) -> "CostModel":
        """A copy with every *time* coefficient scaled by ``factor``
        (used by calibration to fit an unknown rig speed)."""
        return replace(
            self, ttft_base_ms=self.ttft_base_ms * factor,
            prefill_tokens_per_s=self.prefill_tokens_per_s / factor,
            decode_token_ms=self.decode_token_ms * factor,
            predict_ms=self.predict_ms * factor,
            net_rtt_ms=self.net_rtt_ms * factor)

    # -- pricing -----------------------------------------------------------

    def contention(self, active: int, slots: int) -> float:
        """Service-time multiplier with ``active`` of ``slots`` busy."""
        if slots <= 0:
            return 1.0
        frac = min(1.0, max(0, active) / float(slots))
        return 1.0 + self.decode_slowdown * frac

    def ttft_s(self, prompt_tokens: int, active: int, slots: int) -> float:
        """Dispatch-to-first-token time for a generate request."""
        prefill = prompt_tokens / self.prefill_tokens_per_s
        mult = self.contention(active, slots)
        return (self.ttft_base_ms + self.net_rtt_ms) / 1e3 + prefill * mult

    def decode_s(self, output_tokens: int, active: int,
                 slots: int) -> float:
        """First-token-to-done time for ``output_tokens`` tokens."""
        mult = self.contention(active, slots)
        return output_tokens * self.decode_token_ms * mult / 1e3

    def predict_s(self, active: int, slots: int) -> float:
        """Full service time for one predict request."""
        mult = self.contention(active, slots)
        return (self.predict_ms * mult + self.net_rtt_ms) / 1e3

    def pages_for(self, prompt_tokens: int, output_tokens: int) -> int:
        """KV pages a generate request pins for its lifetime."""
        total = max(1, prompt_tokens + output_tokens)
        return (total + self.page_size - 1) // self.page_size

    # -- fitting -----------------------------------------------------------

    @staticmethod
    def fit_predict(latencies_ms: Sequence[float],
                    base: Optional["CostModel"] = None) -> "CostModel":
        """Fit ``predict_ms`` from measured per-request latencies (median;
        robust to the tail the sim is supposed to *reproduce*, not
        consume as input)."""
        base = base or CostModel.from_bench_notes()
        if not latencies_ms:
            return base
        srt = sorted(float(x) for x in latencies_ms)
        med = srt[len(srt) // 2]
        # strip the modeled network RTT so it is not double counted
        return replace(base, predict_ms=max(0.1, med - base.net_rtt_ms))
