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
- the experts run as two products over ``[E, C, hidden]`` with the tanh
  GELU, batched over the experts; a bank split for serving
  (:class:`~..parallel.tp.EPShards`) runs one 2-D product per expert
  instead, whose bits do not depend on how many experts the bank holds
  (on the card a batched product's kernel follows its batch count), and
  ``per_expert_products = True`` gives a whole bank that arithmetic too;
- the Switch load-balancing loss is over live tokens (``token_mask``),
  first-choice fractions times mean router probabilities.

The training and classifier path pass the ``attention_mask`` as the token
mask, so padding claims no capacity. Prefill, decode and the suffix and
verify forwards pass none (as in the JAX package): a padded prefill bucket's
pad tokens and a decode batch's idle lanes claim capacity like live tokens,
so the serving engine must present the same batch as the JAX engine does.
On a ``tp`` mesh the attention is Megatron's and the expert MLP is
replicated (its ``P("ep", ...)`` rules filter to replicated there), as in
the JAX package.

Expert parallelism, in the JAX package's two forms:

- ``ep_axis`` (a model config key) — the communicating form: on the ranks
  of a bound mesh each holds a batch shard and ``E/ep`` experts, and the
  training forward runs :func:`~..ops.moe_dispatch.all_to_all_moe_ffn`
  (:func:`~..parallel.ep.make_moe_shardmap_train_step`). The serving forms
  (prefill, decode, suffix, verify) take the slot table, as in JAX.
- the local bank (JAX's GSPMD form and its decode plane's ``ep_axis=``):
  rows replicated over ``ep``, each rank (``expert_axis`` set on its copy
  of the model) or each one-process serving shard (``bp["experts"]``, an
  :class:`~..parallel.tp.EPShards`) runs only its experts' slots, and the
  outputs sum over the shards (:meth:`_MoEMixin._moe_mlp_slots`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import P
from .registry import register_model
from .transformer import TransformerLM, _gelu


class _MoEMixin:
    """Replaces the dense MLP with a capacity-routed expert bank on the
    MoE layers (those whose block holds a ``router``)."""

    def _init_moe(self, num_experts: int, moe_every: int, aux_weight: float,
                  capacity_factor: float = 1.25, router_top_k: int = 1,
                  ep_axis: Optional[str] = None):
        self.num_experts = int(num_experts)
        self.moe_every = max(1, int(moe_every))
        self.aux_weight = float(aux_weight)
        self.capacity_factor = float(capacity_factor)
        self.router_top_k = max(1, min(int(router_top_k), self.num_experts))
        # ep_axis: the training forward runs the all_to_all dispatch over
        # this mesh axis (ops/moe_dispatch; the batch sharded over it too);
        # None keeps the slot table. The serving forms always take the slot
        # table, as in the JAX package
        self.ep_axis = ep_axis
        # the mesh axes the batch's rows shard over, set on a rank's copy
        # in a sharded-params fit: routing, capacity and the load-balance
        # term then cover the global batch, as JAX's GSPMD program has them
        self.route_axes: tuple = ()
        # True: every bank runs one 2-D product per expert, as a bank split
        # for serving always does, so a whole bank's outputs equal the
        # split banks' bit for bit (the reference an ep engine is held to)
        self.per_expert_products = False

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
        return self._moe_mlp(bp, y, mask)

    def _moe_mlp(self, bp, x, token_mask=None):
        """``x`` [B,S,hidden] -> (routed expert output, aux loss): the
        all_to_all form on a model built with ``ep_axis`` (inside a bound
        mesh, :mod:`..ops.moe_dispatch`), else the slot table."""
        if self.ep_axis is not None:
            from ..ops.moe_dispatch import all_to_all_moe_ffn
            return all_to_all_moe_ffn(
                x, bp["router"], bp["experts_fc1"], bp["experts_b1"],
                bp["experts_fc2"], bp["experts_b2"], self.ep_axis,
                self.num_experts, self.capacity_factor, token_mask,
                top_k=self.router_top_k)
        return self._moe_mlp_slots(bp, x, token_mask)

    def route(self, bp, xf, token_mask=None):
        """The router's decision for the flat tokens ``xf`` [N, hidden]:
        ``(probs [N,E] f32, top_idx [N,k], gates [N,k] f32, live [N] f32 or
        None)`` (:func:`~..ops.moe_dispatch.route`)."""
        from ..ops.moe_dispatch import route
        return route(xf, bp["router"], self.router_top_k, token_mask)

    def _moe_mlp_slots(self, bp, x, token_mask=None):
        """``x`` [B,S,hidden] -> ``(expert output [B,S,hidden] in x's dtype,
        aux loss float32 scalar)`` through the slot table (module
        docstring). The routing, the capacity and every slot position come
        from the whole batch (over ``route_axes`` when the rows are
        sharded); a bank of experts ``[lo, lo + E_local)``
        serves only the slots of its experts (:meth:`_bank_out`):

        - the whole bank, on one card;
        - on a rank of an ``ep`` mesh (``expert_axis`` set, rows replicated
          over the axis) the rank's ``E/ep`` slice; the output sums over the
          axis (Megatron's *g*), and the dispatched tokens and the gates
          pass *f* so their gradients, partial on each rank, sum too;
        - in one-process serving (``bp["experts"]`` an
          :class:`~..parallel.tp.EPShards`) every shard's slice on its
          device, the partials summed in float32 on ``x``'s device and
          rounded once.

        Each token's output has one real row among the banks and exact
        zeros elsewhere, so the sums equal the one-card output."""
        from ..parallel.tp import EPShards
        b, s, h = x.shape
        e, k = self.num_experts, self.router_top_k
        n = b * s
        xf = x.reshape(n, h)
        probs, top_idx, gates, live = self.route(bp, xf, token_mask)
        onehots = [F.one_hot(top_idx[:, ci], e).to(torch.float32)
                   for ci in range(k)]
        if live is not None:
            onehots = [oh * live[:, None] for oh in onehots]
        probs_live = probs * live[:, None] if live is not None else probs
        counts = torch.stack([oh.sum(0) for oh in onehots])      # [k, E]
        denom = (live.sum() if live is not None
                 else torch.tensor(float(n), device=x.device))
        pmass = probs_live.sum(0)
        # each choice's claims start after every earlier choice's (all first
        # choices before any second choice) and, when the rows shard over
        # route_axes, after the earlier ranks' claims of the same choice
        if self.route_axes:
            from ..parallel import collectives as C
            ax = self.route_axes
            every = C.all_gather(counts[None].contiguous(), ax, axis=0)
            before = every[:C.axis_index(ax)].sum(0)
            counts_g = every.sum(0)
            c = self._capacity(n * every.shape[0] * k)
            denom = C.psum({"d": denom}, ax)["d"]
            pmass = C.psum_grad(pmass, ax)
        else:
            before, counts_g = torch.zeros_like(counts), counts
            c = self._capacity(n * k)

        # Switch load-balancing loss over the live tokens
        denom = denom.clamp_min(1.0)
        aux = e * torch.sum((counts_g[0] / denom) * (pmass / denom))

        # slot positions; the capacity drops are decided here, once, for
        # every bank
        claims = []
        for ci in range(k):
            oh = onehots[ci]
            off = before[ci] + counts_g[:ci].sum(0)                  # [E]
            pos = ((torch.cumsum(oh, 0) - 1.0 + off) * oh).sum(-1).long()
            claims.append((pos, (pos < c) & (oh.sum(-1) > 0)))

        banks = bp.get("experts")
        if isinstance(banks, EPShards):
            e_loc = e // len(banks)
            total = None
            for i, bank in enumerate(banks):
                d = bank["experts_fc1"].device
                part = self._bank_out(
                    bank, i * e_loc, e_loc, c, xf.to(d), top_idx.to(d),
                    [(p.to(d), kp.to(d)) for p, kp in claims], gates.to(d),
                    per_expert=True)
                part = part.float().to(x.device)
                total = part if total is None else total + part
            y = total.to(xf.dtype)
        elif self.expert_axis is not None:
            from ..parallel import collectives as C
            ax = self.expert_axis
            e_loc = bp["experts_fc1"].shape[0]
            y = self._bank_out(bp, C.axis_index(ax) * e_loc, e_loc, c,
                               C.tp_enter(xf, ax), top_idx, claims,
                               C.tp_enter(gates, ax))
            y = C.tp_exit(y, ax)
        else:
            y = self._bank_out(bp, 0, e, c, xf, top_idx, claims, gates)
        return y.view(b, s, h).to(x.dtype), aux

    def _bank_out(self, bank, lo: int, e_loc: int, c: int, xf, top_idx,
                  claims, gates, per_expert: bool = False):
        """The output [N, hidden] of the experts ``[lo, lo + e_loc)`` held
        by ``bank``: their kept slots gathered into ``[e_loc, C, hidden]``
        buffers, the two products with the tanh GELU (batched over the
        experts; one per expert with ``per_expert`` or
        ``per_expert_products``), and each token's slots read back weighted
        by its gates (zero for a token whose choices are dropped or live in
        another bank)."""
        n, h = xf.shape
        xf_pad = torch.cat([xf, xf.new_zeros(1, h)], 0)
        token_for_slot = torch.full((e_loc * c + 1,), n, dtype=torch.long,
                                    device=xf.device)
        rows = torch.arange(n, device=xf.device)
        slots = []
        for ci, (pos, kept) in enumerate(claims):
            loc = top_idx[:, ci] - lo
            if lo or e_loc != self.num_experts:
                kept = kept & (loc >= 0) & (loc < e_loc)
            slot = torch.where(kept, loc * c + pos, e_loc * c)
            # only the overflow row e_loc*c takes duplicate writes; it is cut
            token_for_slot[slot] = rows
            slots.append(slot)
        xe = xf_pad[token_for_slot[:e_loc * c]].view(e_loc, c, h)

        dt = xe.dtype
        w1, w2 = bank["experts_fc1"].to(dt), bank["experts_fc2"].to(dt)
        c1, c2 = bank["experts_b1"].to(dt), bank["experts_b2"].to(dt)
        if per_expert or self.per_expert_products:
            # an expert's arithmetic independent of its bank's size: a
            # token's output is the same bits under any ep split
            out = torch.stack([
                torch.addmm(c2[i], _gelu(torch.addmm(c1[i], xe[i], w1[i])),
                            w2[i]) for i in range(e_loc)])
        else:
            hmid = _gelu(torch.bmm(xe, w1) + c1[:, None, :])
            out = torch.bmm(hmid, w2) + c2[:, None, :]

        out_pad = torch.cat([out.reshape(e_loc * c, h), out.new_zeros(1, h)],
                            0)
        y = out_pad[slots[0]] * gates[:, 0:1].to(out.dtype)
        for ci in range(1, len(slots)):
            y = y + out_pad[slots[ci]] * gates[:, ci:ci + 1].to(out.dtype)
        return y


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
