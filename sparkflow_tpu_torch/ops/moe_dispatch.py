"""all_to_all expert dispatch: the communicating form of expert parallelism
— the port of the JAX package's ``ops/moe_dispatch.py``.

``models/moe.py``'s slot dispatch runs whole on one card, or, on the ranks
of an ``ep`` mesh whose rows are replicated, as each rank's local bank
summed over the axis. This module is the explicit form with the batch
sharded too — the GShard pipeline (Lepikhin et al.):

    route locally -> all_to_all token buffers over the ``ep`` axis ->
    each rank runs ONLY its local experts -> all_to_all back -> combine

Every rank holds a batch shard AND ``E/n`` experts of the bank; tokens move
to their expert's rank and return. Used on the ranks of a bound mesh (see
:func:`~sparkflow_tpu_torch.parallel.ep.make_moe_shardmap_train_step`).

Routing is top-k (k=1 gives Switch semantics, k>1 the GShard renormalized
gates), with first choices claiming buffer capacity before any second
choice — the same priority rule as the slot dispatch, so the two forms
compute identical outputs when capacity covers every choice. The JAX
package leaves this to XLA (no Pallas kernel), so it is plain PyTorch
here: :func:`~..parallel.collectives.all_to_all` for the exchanges and
batched products for the experts; the attention of the same blocks runs
the flash kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route(xf, router_w, top_k: int, token_mask=None):
    """The router's decision for flat tokens ``xf`` [N, hidden]: ``(probs
    [N,E] f32, top_idx [N,k], gates [N,k] f32, live [N] f32 or None)``.
    The router runs in float32; the top-k order is a stable descending sort
    (``argmax`` for ``k == 1``), so a tie picks the lower expert index
    first, as ``lax.top_k`` does; ``k == 1`` gates a token by its largest
    probability, ``k > 1`` renormalises the chosen probabilities
    (GShard)."""
    k = top_k
    logits = torch.matmul(xf.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)                        # [N, E]
    if k == 1:
        top_idx = probs.argmax(dim=-1, keepdim=True)             # first max
        top_vals = probs.gather(-1, top_idx)
        gates = top_vals  # Switch: the gate is the largest probability
    else:
        top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
        top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
        gates = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    live = (None if token_mask is None
            else token_mask.reshape(-1).to(torch.float32))
    return probs, top_idx, gates, live


def all_to_all_moe_ffn(x, router_w, experts_fc1, experts_b1, experts_fc2,
                       experts_b2, axis_name: str, num_experts: int,
                       capacity_factor: float = 1.25, token_mask=None,
                       top_k: int = 1, return_overflow: bool = False):
    """Top-k routed expert FFN with all_to_all dispatch.

    Args (this rank's views, inside a bound mesh with ``axis_name``):
      x            [B_local, S, H] token activations (batch sharded)
      router_w     [H, E] replicated router
      experts_fc1  [E_local, H, M] — THIS rank's slice of the expert bank
      experts_b1   [E_local, M]
      experts_fc2  [E_local, M, H]
      experts_b2   [E_local, H]
      token_mask   optional [B_local, S]; masked tokens claim no capacity
      top_k        experts per token (1 = Switch; >1 = GShard renormalized)
      return_overflow  also return the fraction of live routed choices this
                       rank DROPPED for lack of send-buffer capacity

    Returns ``(combined [B_local, S, H], aux_loss scalar)`` — plus the
    overflow fraction when requested. The aux loss is the Switch
    load-balance term from GLOBALLY summed routing statistics (first-choice
    counts, router probabilities, live-token count) over ``axis_name``, so
    it is the same on every rank and equals the one-card term over the
    whole batch; the sums are :func:`~..parallel.collectives.psum_grad`,
    whose backward sums the cotangents over the axis as JAX's transpose of
    ``psum`` does, so the router gets the gradient of the global term.
    """
    from ..parallel import collectives as C
    from ..parallel.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise NameError(
            f"mesh axis {axis_name!r} is not bound: an ep_axis MoE model "
            f"must run inside shard_map over that axis — use "
            f"parallel.ep.make_moe_shardmap_train_step (or build the model "
            f"without ep_axis for the GSPMD dispatch)")
    n = C.axis_size(axis_name)
    b, s, h = x.shape
    nl = b * s                      # local tokens
    e = int(num_experts)
    k = max(1, min(int(top_k), e))
    e_local = experts_fc1.shape[0]
    assert e_local * n == e, (e_local, n, e)
    # per (rank -> peer) buffer capacity: routed choices THIS rank may send
    # to one peer; cf * nl * k / n is the balanced share across the k
    # choices, generous by design
    cap = max(1, int(-(-capacity_factor * nl * k // n)))
    dev = x.device

    xf = x.reshape(nl, h)
    probs, top_idx, gates, live = route(xf, router_w, k, token_mask)
    if live is None:
        live = torch.ones(nl, dtype=torch.float32, device=dev)

    onehot1 = F.one_hot(top_idx[:, 0], e).to(torch.float32) * live[:, None]
    # global routing statistics, summed over the axis BEFORE the product
    count1_g = C.psum_grad(onehot1.sum(0), axis_name)                 # [E]
    pmass_g = C.psum_grad((probs * live[:, None]).sum(0), axis_name)  # [E]
    nlive_g = C.psum_grad(live.sum(), axis_name).clamp_min(1.0)
    aux = e * torch.sum((count1_g / nlive_g) * (pmass_g / nlive_g))

    # destination peer per (choice, token); positions by a cumsum over the
    # choice-major stack: ALL first choices claim send-buffer slots before
    # any second choice
    dest = torch.div(top_idx, e_local, rounding_mode="floor")       # [Nl, k]
    dest_oh = F.one_hot(dest, n).to(torch.float32) * live[:, None, None]
    stacked = dest_oh.transpose(0, 1).reshape(k * nl, n)
    pos_all = torch.cumsum(stacked, 0) - 1.0                      # [k*Nl, n]

    xf_pad = torch.cat([xf, xf.new_zeros(1, h)], 0)
    # token_for_slot holds the FLAT choice-token id ci*nl + t (sentinel
    # k*nl); the flat id recovers both the token row and its expert. Only
    # the overflow entry n*cap takes duplicate writes, and it is cut
    token_for_slot = torch.full((n * cap + 1,), k * nl, dtype=torch.long,
                                device=dev)
    rows = torch.arange(nl, device=dev)
    slots, kept_live = [], []
    for ci in range(k):
        oh = stacked[ci * nl:(ci + 1) * nl]                       # [Nl, n]
        pos = (pos_all[ci * nl:(ci + 1) * nl] * oh).sum(-1).long()
        kept = (pos < cap) & (live > 0)
        slot = torch.where(kept, dest[:, ci] * cap + pos, n * cap)
        token_for_slot[slot] = ci * nl + rows
        slots.append(slot)
        kept_live.append(kept)
    tfs = token_for_slot[:n * cap]
    tok_idx = torch.where(tfs < k * nl, tfs % nl, nl)        # pad row if empty
    send_x = xf_pad[tok_idx].reshape(n, cap, h)
    # sidecars: which LOCAL expert on the destination, and validity
    le_flat = (top_idx % e_local).t().reshape(k * nl)             # choice-major
    le_pad = torch.cat([le_flat, le_flat.new_zeros(1)])
    send_le = le_pad[torch.clamp_max(tfs, k * nl)].reshape(n, cap)
    send_valid = (tfs < k * nl).to(torch.float32).reshape(n, cap)

    # the exchange: slab j of send goes to peer j; recv slab j came from j
    recv_x = C.all_to_all(send_x, axis_name)
    recv_le = C.all_to_all(send_le, axis_name)
    recv_valid = C.all_to_all(send_valid, axis_name)

    # local experts over the n*cap received tokens; one-hot combine over
    # E_local only
    rt = recv_x.reshape(n * cap, h)
    le_oh = (F.one_hot(recv_le.reshape(-1), e_local).to(torch.float32)
             * recv_valid.reshape(-1)[:, None])               # [n*cap, E_l]
    hid = torch.einsum("th,ehm->etm", rt, experts_fc1.to(rt.dtype))
    hid = F.gelu(hid + experts_b1.to(hid.dtype)[:, None, :],
                 approximate="tanh")
    out = torch.einsum("etm,emh->eth", hid, experts_fc2.to(hid.dtype))
    out = out + experts_b2.to(out.dtype)[:, None, :]
    out = torch.einsum("eth,te->th", out, le_oh.to(out.dtype))

    # results home; each token reads its k result slots back, weighted by
    # its gates (the overflow row is zero: dropped choices add nothing)
    back = C.all_to_all(out.reshape(n, cap, h).contiguous(), axis_name)
    back_pad = torch.cat([back.reshape(n * cap, h), back.new_zeros(1, h)], 0)
    y = back_pad[slots[0]] * gates[:, 0:1].to(back.dtype)
    for ci in range(1, k):
        y = y + back_pad[slots[ci]] * gates[:, ci:ci + 1].to(back.dtype)
    y = y.reshape(b, s, h).to(x.dtype)
    if not return_overflow:
        return y, aux
    routed = (live.sum() * k).clamp_min(1.0)
    kept_n = sum(torch.where(kl, live, 0.0).sum() for kl in kept_live)
    return y, aux, 1.0 - kept_n / routed


__all__ = ["all_to_all_moe_ffn", "route"]
