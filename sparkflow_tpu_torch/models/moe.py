"""Mixture-of-experts transformer LM — the port of the JAX package's
``models/moe.py`` for one card.

Switch-style routing (Fedus et al.) with a fixed capacity per expert and a
load-balancing auxiliary loss. Every ``moe_every``-th block replaces its
dense MLP with a bank of ``num_experts`` feed-forward experts; a float32
router picks each token's top-``router_top_k`` experts, and each expert owns
``capacity = ceil(capacity_factor * tokens * k / E)`` slots. Tokens beyond
an expert's capacity are dropped: their expert output is zero and the
residual stream still carries them.

The dispatch is the JAX module's slot table, in plain PyTorch (the JAX
package leaves it to XLA, no Pallas kernel):

- the router runs in float32 whatever the compute dtype; ``k == 1`` gates
  a token by its largest probability, ``k > 1`` renormalises the chosen
  probabilities (GShard);
- the top-k order is a stable descending sort (``argmax`` for ``k == 1``),
  so a tie picks the lower expert index first, as ``lax.top_k`` does;
- every first choice claims capacity before any second choice: one cumsum
  over the choice-major ``[k*N, E]`` stack of one-hot assignments;
- the slot table has one overflow row: dropped tokens and padding point
  there, read zeros, and the duplicate writes into it are discarded;
- the experts run as two batched products over ``[E, C, hidden]`` with the
  tanh GELU;
- the Switch load-balancing loss is over live tokens (``token_mask``),
  first-choice fractions times mean router probabilities.

The training and classifier path pass the ``attention_mask`` as the token
mask, so padding claims no capacity. Prefill, decode and the suffix and
verify forwards pass none (as in the JAX package): a padded prefill bucket's
pad tokens and a decode batch's idle lanes claim capacity like live tokens,
so the serving engine must present the same batch as the JAX engine does.
On a ``tp`` mesh the attention is Megatron's and the expert MLP is
replicated (its ``P("ep", ...)`` rules filter to replicated there), as in
the JAX package. Expert parallelism (``ep_axis``) is not yet ported and
raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import P
from .registry import register_model
from .transformer import TransformerLM, _gelu, _not_yet


class _MoEMixin:
    """Replaces the dense MLP with a capacity-routed expert bank on the
    MoE layers (those whose block holds a ``router``)."""

    def _init_moe(self, num_experts: int, moe_every: int, aux_weight: float,
                  capacity_factor: float = 1.25, router_top_k: int = 1,
                  ep_axis: Optional[str] = None):
        if ep_axis is not None:
            _not_yet("expert parallelism (ep_axis)")
        self.num_experts = int(num_experts)
        self.moe_every = max(1, int(moe_every))
        self.aux_weight = float(aux_weight)
        self.capacity_factor = float(capacity_factor)
        self.router_top_k = max(1, min(int(router_top_k), self.num_experts))

    def _is_moe_layer(self, i: int) -> bool:
        return (i % self.moe_every) == (self.moe_every - 1)

    def _capacity(self, n_tokens: int) -> int:
        return max(1, int(math.ceil(self.capacity_factor * n_tokens
                                    / self.num_experts)))

    def _moe_block_specs(self):
        h, m, e = self.hidden, self.mlp_dim, self.num_experts
        specs = super()._block_specs()
        for k in ("fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias"):
            del specs[k]
        specs.update({
            "router": ((h, e), "normal(0.02)"),
            "experts_fc1": ((e, h, m), "normal(0.02)"),
            "experts_b1": ((e, m), "zeros"),
            "experts_fc2": ((e, m, h), "normal(0.02)"),
            "experts_b2": ((e, h), "zeros"),
        })
        return specs

    def param_specs(self):
        specs = super().param_specs()
        for i in range(self.num_layers):
            if self._is_moe_layer(i):
                specs[f"block_{i}"] = self._moe_block_specs()
        return specs

    def _moe_block_pspecs(self):
        specs = super()._block_pspecs()
        for k in ("fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias"):
            del specs[k]
        specs.update({
            "router": P(),
            "experts_fc1": P("ep", None, None),
            "experts_b1": P("ep", None),
            "experts_fc2": P("ep", None, None),
            "experts_b2": P("ep", None),
        })
        return specs

    def param_pspecs(self):
        """The JAX package's rules: megatron attention on ``tp``, the
        expert bank on ``ep`` — which a ``tp`` mesh lacks, so there the
        expert MLP is replicated and only the attention sums over ``tp``."""
        specs = super().param_pspecs()
        for i in range(self.num_layers):
            if self._is_moe_layer(i):
                specs[f"block_{i}"] = self._moe_block_pspecs()
        return specs

    def _mlp(self, bp, y, mask=None):
        if "router" not in bp:
            return super()._mlp(bp, y, mask)
        return self._moe_mlp_slots(bp, y, mask)

    def route(self, bp, xf, token_mask=None):
        """The router's decision for the flat tokens ``xf`` [N, hidden]:
        ``(probs [N,E] f32, top_idx [N,k], gates [N,k] f32, live [N] f32 or
        None)``."""
        k = self.router_top_k
        logits = torch.matmul(xf.float(), bp["router"].float())
        probs = torch.softmax(logits, dim=-1)                    # [N, E]
        if k == 1:
            top_idx = probs.argmax(dim=-1, keepdim=True)         # first max
            top_vals = probs.gather(-1, top_idx)
        else:
            top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                           stable=True)
            top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
        if k == 1:
            gates = top_vals  # Switch: the gate is the largest probability
        else:
            gates = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        live = (None if token_mask is None
                else token_mask.reshape(-1).to(torch.float32))
        return probs, top_idx, gates, live

    def _moe_mlp_slots(self, bp, x, token_mask=None):
        """``x`` [B,S,hidden] -> ``(expert output [B,S,hidden] in x's dtype,
        aux loss float32 scalar)`` through the slot table (module
        docstring)."""
        b, s, h = x.shape
        e, k = self.num_experts, self.router_top_k
        n = b * s
        c = self._capacity(n * k)
        xf = x.reshape(n, h)
        probs, top_idx, gates, live = self.route(bp, xf, token_mask)
        onehots = [F.one_hot(top_idx[:, ci], e).to(torch.float32)
                   for ci in range(k)]
        if live is not None:
            onehots = [oh * live[:, None] for oh in onehots]

        # Switch load-balancing loss over the live tokens
        denom = (live.sum() if live is not None
                 else torch.tensor(float(n), device=x.device)).clamp_min(1.0)
        probs_live = probs * live[:, None] if live is not None else probs
        aux = e * torch.sum((onehots[0].sum(0) / denom)
                            * (probs_live.sum(0) / denom))

        # slot positions: all first choices before any second choice
        pos_all = torch.cumsum(torch.cat(onehots, 0), 0) - 1.0   # [k*N, E]
        xf_pad = torch.cat([xf, xf.new_zeros(1, h)], 0)
        token_for_slot = torch.full((e * c + 1,), n, dtype=torch.long,
                                    device=x.device)
        rows = torch.arange(n, device=x.device)
        slots = []
        for ci in range(k):
            oh = onehots[ci]
            pos = (pos_all[ci * n:(ci + 1) * n] * oh).sum(-1).long()
            kept = (pos < c) & (oh.sum(-1) > 0)
            slot = torch.where(kept, top_idx[:, ci] * c + pos, e * c)
            # only the overflow row e*c takes duplicate writes; it is cut
            token_for_slot[slot] = rows
            slots.append(slot)
        xe = xf_pad[token_for_slot[:e * c]].view(e, c, h)        # [E, C, H]

        hmid = torch.bmm(xe, bp["experts_fc1"].to(xe.dtype))
        hmid = _gelu(hmid + bp["experts_b1"].to(hmid.dtype)[:, None, :])
        out = torch.bmm(hmid, bp["experts_fc2"].to(hmid.dtype))
        out = out + bp["experts_b2"].to(out.dtype)[:, None, :]

        # combine: each token reads its k slots back, weighted by its gates
        out_pad = torch.cat([out.reshape(e * c, h), out.new_zeros(1, h)], 0)
        y = out_pad[slots[0]] * gates[:, 0:1].to(out.dtype)
        for ci in range(1, k):
            y = y + out_pad[slots[ci]] * gates[:, ci:ci + 1].to(out.dtype)
        return y.view(b, s, h).to(x.dtype), aux


@register_model("transformer_moe_lm")
class MoETransformerLM(_MoEMixin, TransformerLM):
    """Causal MoE LM: a Switch expert bank every ``moe_every``-th block.

    A :class:`TransformerLM` in every other respect, so the serving engine
    drives it through the same ``prefill`` / ``decode_step`` /
    ``prefill_suffix`` / ``decode_verify`` (the flash and paged kernels on
    the card) and the trainer through the same loss."""

    def __init__(self, vocab_size: int, num_experts: int = 8,
                 moe_every: int = 2, router_aux_weight: float = 0.01,
                 capacity_factor: float = 1.25, router_top_k: int = 1,
                 ep_axis: Optional[str] = None, **kw):
        super().__init__(vocab_size, **kw)
        self._init_moe(num_experts, moe_every, router_aux_weight,
                       capacity_factor, router_top_k, ep_axis)

    def _loss(self, params, feeds, train: bool = True,
              generator: Optional[torch.Generator] = None, **kw):
        """Per-sequence mean next-token NLL [B] plus the summed router aux
        loss times ``router_aux_weight`` (spread over the examples, so the
        trainer's masked mean stays right)."""
        ids = torch.as_tensor(feeds["input_ids"], device=self.device).long()
        x, _, aux = self._encode(params, feeds, True, train, generator, **kw)
        logits = torch.matmul(x.float(), params["embed"]["tok"].float().t())
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, ids[:, 1:, None])[..., 0]
        mask = feeds.get("attention_mask")
        if mask is not None:
            w = torch.as_tensor(mask, device=self.device)[:, 1:].float()
            per = (nll * w).sum(-1) / w.sum(-1).clamp_min(1e-6)
        else:
            per = nll.mean(-1)
        return per + aux * self.aux_weight


__all__ = ["MoETransformerLM"]
