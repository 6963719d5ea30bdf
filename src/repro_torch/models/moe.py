"""Mixture-of-Experts layer: FlInt top-k routing + capacity-factor dispatch.

The PyTorch counterpart of the JAX package's ``models/moe.py``: the
single-program path, and under a mesh with a ``model`` axis the
expert-parallel path (``moe_block_ep``; with the expert weights as this
rank's ``model`` block, as the sharded train step gives them, its body
runs directly on the rows the rank is given, ``moe_block_tp``; serving on
each rank's rows, ``_moe_block_rows`` drops the pairs the reference's
program on the whole batch drops).  Expert
selection only needs the *order* of router logits, so top-k runs on FlInt
int32 keys (``repro_torch.core.flint``): a stable descending sort of the
keys, which puts the lower expert index first among equal keys, as
``lax.top_k`` does (``torch.topk`` promises no order on ties).

Dispatch is scatter-based: each (token, expert) pair lands in an (E, C, d)
buffer at (expert, slot), its slot the count of earlier pairs routed to the
same expert, in token order.  Pairs at slot >= capacity are dropped and read
0 at the combine (Switch/GShard semantics with ``capacity_factor``).
"""
from __future__ import annotations

import math

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
    """x: (B, S, D) -> (B, S, D), plus the aux load-balancing loss.

    Dispatches to the expert-parallel path when a mesh with a non-trivial
    ``model`` axis is active (``moe_block_ep``), or when the expert
    weights are this rank's ``model`` block (``moe_block_tp``); otherwise
    the single-program scatter path below (CPU tests, 1-device meshes).
    On each rank's rows (``sharding.ops.use_rows``: serving on a mesh) the
    block drops the pairs the reference's program on the whole batch drops
    (``_moe_block_rows``).
    """
    from repro_torch.sharding.ops import current_mesh, rows_split, tp_mesh

    tpm = tp_mesh()
    split = tpm is not None and params["w_gate_e"].shape[0] != n_experts
    kw = dict(n_experts=n_experts, k=k, act=act, capacity_factor=capacity_factor)
    if rows_split() is not None:
        return _moe_block_rows(params, x, rows=rows_split(), tpm=tpm if split else None, **kw)
    if split:
        return moe_block_tp(params, x, mesh=tpm, **kw)
    mesh = current_mesh()
    b, s, _ = x.shape
    if _takes_ep(mesh, n_experts, k, b * s):
        return moe_block_ep(params, x, mesh=mesh, **kw)
    return _moe_block_jit(params, x, **kw)


def _takes_ep(mesh, n_experts: int, k: int, tokens: int) -> bool:
    """Whether the reference's ``moe_block`` takes its expert-parallel path
    for ``tokens`` tokens of the whole batch on ``mesh``: ``model`` splits
    the experts, and each of the ``pod`` x ``data`` shards has enough tokens.
    EP only pays off when the per-shard expert batch amortizes the weight
    gather and keeps capacity sane; at decode (a few tokens per shard) the
    single-program path is both faster and drop-free."""
    if mesh is None or mesh.shape.get("model", 1) <= 1 or n_experts % mesh.shape["model"]:
        return False
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    return (tokens // max(dp, 1)) * k >= 4 * n_experts


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


# ---------------------------------------------------------------------------
# expert-parallel path
# ---------------------------------------------------------------------------
#
# Rank (i, j) of a (data, model) mesh owns data shard i's tokens AND model
# shard j's experts, so dispatch, the expert FFN and the partial combine are
# local; the one collective is a sum of the combined output over `model`
# (and a mean of the aux loss over the batch axes).  No all-to-all.  The
# sum is autograd-aware (``reduce_from_model``), and the tokens and gate
# weights enter the rank's experts through ``copy_to_model``, so in
# training each rank's experts get their gradients and the router and the
# tokens get the sum of every rank's.

def ep_dispatch(ids, gates, lo: int, e_loc: int, capacity: int):
    """The compact dispatch of a rank holding experts [lo, lo + e_loc):
    (src_tok (e_loc, capacity) int64, the token of each (expert, slot) or
    t where the slot is empty; gate_slot (e_loc, capacity) float32, its
    gate weight).  A pair's slot is its exclusive prefix count among the
    local pairs of its expert, in pair order; pairs of other ranks' experts
    and pairs at slot >= capacity land nowhere (the reference's scatter
    with ``mode="drop"``)."""
    t = ids.shape[0]
    k = ids.shape[1]
    ids_loc = torch.where((ids >= lo) & (ids < lo + e_loc), ids - lo, e_loc)
    ids_flat = ids_loc.reshape(-1)  # (t*k,): e_loc == "not mine"
    slot_flat = dispatch_slots(ids_flat, e_loc + 1)
    # dropped pairs go to a spare row and column that are cut off
    keep = (ids_flat < e_loc) & (slot_flat < capacity)
    row = torch.where(keep, ids_flat, e_loc)
    col = torch.where(keep, slot_flat, capacity)
    pair_tok = torch.arange(t * k, device=ids.device) // k
    src_tok = torch.full((e_loc + 1, capacity + 1), t, dtype=torch.int64, device=ids.device)
    src_tok[row, col] = pair_tok
    gate_slot = torch.zeros((e_loc + 1, capacity + 1), dtype=torch.float32, device=ids.device)
    gate_slot[row, col] = gates.reshape(-1).float()
    return src_tok[:e_loc, :capacity], gate_slot[:e_loc, :capacity]


def _ep_body(wr, wg, wu, wd, xb, *, n_experts, e_loc, k, act, capacity_factor, batch_axes, mesh):
    from repro_torch.sharding.ops import axis_index, copy_to_model, pmean, reduce_from_model

    b, s, d = xb.shape
    t = b * s
    xt = xb.reshape(t, d)
    logits, gates, ids = route({"w_router": wr}, xt, k)  # (t_loc, E): full expert range
    aux = pmean(_aux_loss(logits, ids, n_experts), batch_axes, mesh)  # alike over `model`

    # capacity from the local token count, as the reference's
    capacity = int(max(1, (t * k * capacity_factor) // n_experts))
    src_tok, gate_slot = ep_dispatch(ids, copy_to_model(gates, mesh),
                                     axis_index("model", mesh) * e_loc, e_loc, capacity)
    # gather the landed rows (row t is the empty slots' zero row), in
    # float32 so a token's gradient is summed over its pairs and the ranks
    # before it is rounded
    xt_pad = torch.cat([copy_to_model(xt.float(), mesh),
                        torch.zeros((1, d), dtype=torch.float32, device=xt.device)], dim=0)
    buf = xt_pad[src_tok].to(xb.dtype)  # (e_loc, capacity, d)

    a = act_fn(act)
    gate = a(torch.einsum("ecd,edf->ecf", buf, wg.to(xb.dtype)))
    up = torch.einsum("ecd,edf->ecf", buf, wu.to(xb.dtype))
    out_e = torch.einsum("ecf,efd->ecd", gate * up, wd.to(xb.dtype))

    # combine: the gated expert rows added into their tokens in float32
    # (row t takes the empty slots), summed over `model`, rounded once
    contrib = out_e.float() * gate_slot.to(xb.dtype).float()[..., None]
    y = torch.zeros((t + 1, d), dtype=torch.float32, device=xb.device)
    y.index_add_(0, src_tok.reshape(-1), contrib.reshape(-1, d))
    y = reduce_from_model(y[:t], mesh)
    return y.to(xb.dtype).reshape(b, s, d), aux


def moe_block_ep(params, x, *, n_experts: int, k: int, act: str, capacity_factor: float, mesh):
    """The expert-parallel MoE block: each rank routes its data shard's
    tokens (the router replicated), runs its ``model`` shard's experts and
    the combined output is summed over ``model``.  Returns (y, aux) as
    plain global tensors on every rank."""
    from repro_torch.sharding.ops import P, gather, shard_map

    tp = mesh.shape["model"]
    e_loc = n_experts // tp
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    bspec = P(batch_axes, None, None)

    def body(wr, wg, wu, wd, xb):
        return _ep_body(wr, wg, wu, wd, xb, n_experts=n_experts, e_loc=e_loc, k=k, act=act,
                        capacity_factor=capacity_factor, batch_axes=batch_axes, mesh=mesh)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(),  # router weight: replicated (tiny)
            P("model", None, None),  # expert weights: local experts, full d
            P("model", None, None),
            P("model", None, None),
            bspec,  # tokens: local batch shard, replicated over model
        ),
        out_specs=(bspec, P()),
    )
    y, aux = fn(params["w_router"], params["w_gate_e"], params["w_up_e"], params["w_down_e"], x)
    return gather(y), aux.to_local()


def moe_block_tp(params, x, *, n_experts: int, k: int, act: str, capacity_factor: float, mesh):
    """The expert-parallel body on the rows this rank is given, with the
    expert weights already its ``model`` block (``sharding.ops.use_tp``):
    the router replicated, as ``w_router``'s rule leaves it; the aux loss
    of these rows (the train step averages it over the batch axes)."""
    return _ep_body(params["w_router"], params["w_gate_e"], params["w_up_e"],
                    params["w_down_e"], x, n_experts=n_experts,
                    e_loc=n_experts // mesh.shape["model"], k=k, act=act,
                    capacity_factor=capacity_factor, batch_axes=(), mesh=mesh)


# ---------------------------------------------------------------------------
# serving on each rank's rows
# ---------------------------------------------------------------------------
#
# The reference jits the serving program on the mesh with the whole batch,
# so which pairs its capacity drops is decided over the whole batch: per
# ``pod`` x ``data`` shard where it takes expert parallelism (``_ep_body``'s
# capacity counts the shard's tokens, its slots the shard's pairs), and
# over every token where it takes its one program (decode: the capacity
# counts the whole batch, a pair's slot every earlier pair of its expert in
# the batch).  On each rank's rows the port drops the same pairs.

def _moe_block_rows(params, x, *, n_experts: int, k: int, act: str, capacity_factor: float,
                    rows, tpm):
    """``moe_block`` on this rank's rows ``x`` of a batch split over the
    mesh axes of ``rows`` (``sharding.ops.rows_split``), the expert weights
    this rank's ``model`` block where ``tpm`` is the mesh: where the
    reference's program takes expert parallelism, ``moe_block_tp``'s body
    on these rows (the shard's capacity and slots, as its per-shard body);
    else its one program's drops (``_moe_one_program_rows``).  The aux loss
    (not used in serving) is 0."""
    mesh, axes = rows
    b, s, _ = x.shape
    n = math.prod(mesh.shape[a] for a in axes)
    kw = dict(n_experts=n_experts, k=k, act=act, capacity_factor=capacity_factor)
    if tpm is not None and _takes_ep(mesh, n_experts, k, b * s * n):
        y, _ = moe_block_tp(params, x, mesh=tpm, **kw)
    else:
        y = _moe_one_program_rows(params, x, mesh=mesh, axes=axes, tpm=tpm, **kw)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def _moe_one_program_rows(params, x, *, n_experts: int, k: int, act: str,
                          capacity_factor: float, mesh, axes, tpm):
    """The reference's one-program MoE (``_moe_block_jit`` on the whole
    batch) from this rank's rows: every rank's tokens are gathered over the
    batch axes (a few at decode), routed, and given their slots among the
    whole batch's pairs, so the same pairs drop as in one program.  Each
    rank computes its experts' (its ``model`` block's, or all) slots in its
    share of the capacity (a range over the batch axes), and the gated
    expert rows, summed in float32 over the mesh, are rounded once; the
    rank keeps its rows."""
    from repro_torch.sharding.ops import gather_rows, psum, rows_index

    b, s, d = x.shape
    t_own = b * s
    xt = gather_rows(x.reshape(t_own, d), mesh, axes)  # (T, d): the batch's tokens in order
    t = xt.shape[0]
    _, gates, ids = route(params, xt, k)
    capacity = int(max(1, (t * k * capacity_factor) // n_experts))
    ids_flat = ids.reshape(-1)
    slot_flat = dispatch_slots(ids_flat, n_experts)

    e_loc = params["w_gate_e"].shape[0]
    lo = tpm.axis_index("model") * e_loc if tpm is not None else 0
    r, n = rows_index(mesh, axes), math.prod(mesh.shape[a] for a in axes)
    per = -(-capacity // n)  # this rank's slots: [r * per, (r + 1) * per) of the capacity
    col = slot_flat - r * per
    mine = (ids_flat >= lo) & (ids_flat < lo + e_loc) & (slot_flat < capacity) & \
        (col >= 0) & (col < per)
    # pairs of other ranks' experts or slots, and dropped pairs, land in a
    # spare row and column that are cut off
    row = torch.where(mine, ids_flat - lo, e_loc)
    col = torch.where(mine, col, per)
    buf = torch.zeros((e_loc + 1, per + 1, d), dtype=x.dtype, device=x.device)
    buf[row, col] = torch.repeat_interleave(xt, k, dim=0)
    buf = buf[:e_loc, :per]

    a = act_fn(act)
    gate = a(torch.einsum("ecd,edf->ecf", buf, params["w_gate_e"].to(x.dtype)))
    up = torch.einsum("ecd,edf->ecf", buf, params["w_up_e"].to(x.dtype))
    out_e = torch.einsum("ecf,efd->ecd", gate * up, params["w_down_e"].to(x.dtype))

    yrep = out_e[row.clamp(max=e_loc - 1), col.clamp(max=per - 1)]
    yrep = torch.where(mine[:, None], yrep, 0.0)
    y = (yrep.reshape(t, k, d).float() * gates[..., None].to(x.dtype).float()).sum(dim=1)
    y = psum(y, tuple(axes) + (("model",) if tpm is not None else ()), mesh)
    return y.narrow(0, r * t_own, t_own).to(x.dtype).reshape(b, s, d)
