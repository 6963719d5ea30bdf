"""Mixture-of-Experts layer: FlInt top-k routing + capacity-factor dispatch.

The PyTorch counterpart of the JAX package's ``models/moe.py``, its
single-program path (the expert-parallel path waits for the sharding
slice).  Expert selection only needs the *order* of router logits, so top-k
runs on FlInt int32 keys (``repro_torch.core.flint``): a stable descending
sort of the keys, which puts the lower expert index first among equal keys,
as ``lax.top_k`` does (``torch.topk`` promises no order on ties).

Dispatch is scatter-based: each (token, expert) pair lands in an (E, C, d)
buffer at (expert, slot), its slot the count of earlier pairs routed to the
same expert, in token order.  Pairs at slot >= capacity are dropped and read
0 at the combine (Switch/GShard semantics with ``capacity_factor``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.flint import float_to_key
from repro_torch.models.layers import Init, act_fn, dense_init


def moe_params(init: Init, d_model: int, n_experts: int, d_ff: int):
    return {
        "w_router": dense_init(init, (d_model, n_experts)),
        "w_gate_e": dense_init(init, (n_experts, d_model, d_ff), in_axis=1),
        "w_up_e": dense_init(init, (n_experts, d_model, d_ff), in_axis=1),
        "w_down_e": dense_init(init, (n_experts, d_ff, d_model), in_axis=1),
    }


def flint_topk(logits, k: int):
    """Top-k on int32 FlInt keys: integer compares only, the reference's
    order (lower index first on equal keys).

    Returns (gate_weights (T,k) f32 softmaxed over the k, expert_ids (T,k)
    int64).
    """
    keys = float_to_key(logits.float())
    ids = torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]
    sel = torch.gather(logits.float(), -1, ids)
    w = torch.softmax(sel, dim=-1)  # normalize over the selected k (qwen3/olmoe)
    return w, ids


def _aux_loss(logits, ids, n_experts):
    """Switch-style load-balancing loss: E * sum_e f_e * p_e."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(ids[:, 0], n_experts).float().mean(dim=0)
    return n_experts * torch.sum(me * ce)


def moe_block(params, x, *, n_experts: int, k: int, act: str = "silu",
              capacity_factor: float = 1.25):
    """x: (B, S, D) -> (B, S, D), plus the aux load-balancing loss.  One
    card has no mesh, so this is always the single-program path."""
    return _moe_block_jit(params, x, n_experts=n_experts, k=k, act=act,
                          capacity_factor=capacity_factor)


def dispatch_slots(ids_flat, n_experts: int):
    """Each routed pair's slot: its exclusive prefix count among the pairs
    routed to the same expert, in pair order."""
    onehot = F.one_hot(ids_flat, n_experts)  # (T*k, E)
    slots = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(slots, 1, ids_flat[:, None])[:, 0]


def route(params, xt, k: int):
    """The router of (T, D) tokens: (logits (T, E) float32, gate weights
    (T, k), expert ids (T, k))."""
    # the reference rounds its bf16 product to bf16 and casts it back to
    # float32 for routing, and its compiler drops that round trip (XLA's
    # excess precision), so routing reads the float32 sum
    logits = xt.float() @ params["w_router"].to(xt.dtype).float()
    return (logits, *flint_topk(logits, k))


def _moe_block_jit(params, x, *, n_experts: int, k: int, act: str, capacity_factor: float):
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits, gates, ids = route(params, xt, k)  # (T,E), (T,k), (T,k)
    aux_loss = _aux_loss(logits, ids, n_experts)

    capacity = int(max(1, (t * k * capacity_factor) // n_experts))

    ids_flat = ids.reshape(-1)  # (T*k,)
    slot_flat = dispatch_slots(ids_flat, n_experts)
    in_cap = slot_flat < capacity

    xrep = torch.repeat_interleave(xt, k, dim=0)  # (T*k, D) token copies per pair
    # overflow pairs land in a spare slot that is cut off (no mask select, so
    # no wait for the device to count the kept pairs)
    buf = torch.zeros((n_experts, capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[ids_flat, torch.where(in_cap, slot_flat, capacity)] = xrep
    buf = buf[:, :capacity]

    a = act_fn(act)
    gate = a(torch.einsum("ecd,edf->ecf", buf, params["w_gate_e"].to(x.dtype)))
    up = torch.einsum("ecd,edf->ecf", buf, params["w_up_e"].to(x.dtype))
    out_e = torch.einsum("ecf,efd->ecd", gate * up, params["w_down_e"].to(x.dtype))

    # combine: read back each pair's slot; dropped pairs (slot >= capacity) -> 0
    safe_slot = torch.clamp(slot_flat, max=capacity - 1)
    yrep = out_e[ids_flat, safe_slot]  # (T*k, D)
    yrep = torch.where(in_cap[:, None], yrep, 0.0)
    # the gated products are summed in float32 and rounded once, as the
    # reference's bf16 multiply fused into its float32 sum is
    y = (yrep.reshape(t, k, d).float() * gates[..., None].to(x.dtype).float()).sum(dim=1)
    y = y.to(x.dtype)
    return y.reshape(b, s, d), aux_loss
