"""Mamba2 (SSD — state-space duality) layer with chunked scan + decode step.

The PyTorch counterpart of the JAX package's ``models/ssm.py``.  Follows
arXiv:2405.21060: per-head scalar decay A, input-dependent dt/B/C, causal
depthwise conv on (x, B, C), gated output.  The chunked algorithm computes
intra-chunk contributions as masked (Q x Q) matmuls and carries an
(H, N, P) state across chunks, a Python loop over chunks in place of the
reference's ``lax.scan`` (sequential over chunks, parallel over the rest).
Contractions the reference runs on bf16 inputs with float32 results
(``preferred_element_type``) run here on the bf16 values cast to float32.

Decode is O(1) per token: conv ring buffer + state update
``S <- exp(dt A) S + dt B (x)``, ``y = C . S + D x``.

With ``w_out`` as this rank's ``model`` block (``sharding.ops.use_tp``:
the sharded train step, and serving on blocks) the layer computes its
rank's heads only, as the reference's partitioned program does where it
pins them to ``"tp"``: its columns of the whole in-projection, its heads'
conv channels beside B and C (computed alike on every rank), the SSD on
its heads, the gated norm with its sum of squares summed over ``model``,
and ``w_out`` row-parallel (``_ssd_forward_tp``, ``_ssd_decode_step_tp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Init, dense_init, rms_norm, silu, softplus

HEADDIM = 64  # P: mamba2 default head dim
CONV_K = 4


def ssm_dims(d_model: int, expand: int, state: int):
    d_inner = expand * d_model
    n_heads = d_inner // HEADDIM
    conv_dim = d_inner + 2 * state  # x, B, C share the conv
    return d_inner, n_heads, conv_dim


def ssm_params(init: Init, d_model: int, expand: int, state: int):
    d_inner, h, conv_dim = ssm_dims(d_model, expand, state)
    return {
        # [z, x, B, C, dt]
        "w_in": dense_init(init, (d_model, 2 * d_inner + 2 * state + h)),
        "conv_w": dense_init(init, (conv_dim, CONV_K)),
        "a_log": init.zeros((h,)),  # A = -exp(a_log) in (-inf,0)
        "dt_bias": init.zeros((h,)),
        "d_skip": init.ones((h,)),
        "norm_gamma": init.zeros((d_inner,)),
        "w_out": dense_init(init, (d_inner, d_model)),
    }


def _split_in(params, x, d_inner, state, h):
    zxbcdt = x @ params["w_in"].to(x.dtype)
    return torch.split(zxbcdt, [d_inner, d_inner, state, state, h], dim=-1)


def _causal_conv(u, w):
    """u: (B, S, C), w: (C, K) depthwise causal conv + silu."""
    k = w.shape[1]
    upad = F.pad(u, (0, 0, k - 1, 0))
    # windows: out[t] = sum_j u[t-K+1+j] * w[:, j], added in j order
    out = sum(upad[:, j:j + u.shape[1], :] * w[None, None, :, j].to(u.dtype) for j in range(k))
    return silu(out)


def _gated_norm(y, z, gamma):
    """``rms_norm(y * silu(z))``, the gated product in float32: the
    reference's compiled program folds that product's bf16 rounding into the
    norm's float32 cast (XLA's excess precision)."""
    return rms_norm(y.float() * silu(z).float(), gamma).to(y.dtype)


def _f32_einsum(eq: str, *operands):
    return torch.einsum(eq, *(o.float() for o in operands))


def _ssd_scan(hp, xs, b, c, dt, *, chunk: int, s_real: int):
    """The chunked SSD of the heads whose channels ``xs`` (B, S, H * P)
    holds (after the conv), with their ``dt`` (B, S, H) before the
    softplus and their leaves ``hp`` (``a_log``, ``dt_bias``, ``d_skip``):
    (y (B, S, H * P) in ``xs``'s dtype, before the gate; the final state
    (B, H, N, P) in float32).  Each head's values depend on its own
    channels and on ``b``, ``c`` alone."""
    bsz, s, _ = xs.shape
    h, state, p = dt.shape[-1], b.shape[-1], HEADDIM
    xh = xs.reshape(bsz, s, h, p)
    dt = softplus(dt.float() + hp["dt_bias"])  # (B,S,H)
    if s > s_real:
        # padded steps must be state-identities: dt=0 -> decay=1, no input
        valid = (torch.arange(s, device=xs.device) < s_real)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    a = -torch.exp(hp["a_log"])  # (H,)
    da = dt * a  # (B,S,H) log-decay per step, negative

    nc = s // chunk
    dac = da.reshape(bsz, nc, chunk, h)
    dtc = dt.reshape(bsz, nc, chunk, h)
    xc = xh.reshape(bsz, nc, chunk, h, p)
    bc = b.reshape(bsz, nc, chunk, state)
    cc = c.reshape(bsz, nc, chunk, state)

    lcum = torch.cumsum(dac, dim=2)  # (B,nc,Q,H) inclusive cumulative log-decay
    ltot = lcum[:, :, -1]  # (B,nc,H)
    bf = xs.dtype  # bf16 for the (Q x Q) work; the recurrence stays float32

    # --- intra-chunk: masked (Q x Q) attention-like matmul
    # decay(q,s) = exp(lcum_q - lcum_s) for s <= q; exp in f32, product in bf16
    dq = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device))
    dec = torch.exp(torch.where(mask[None, None, :, :, None], dq, float("-inf"))).to(bf)
    scores = torch.einsum("bnqs,bnts->bnqt", cc.to(bf), bc.to(bf))
    w = scores[..., None] * dec * dtc[:, :, None, :, :].to(bf)  # (B,nc,Q,Q,H)
    y_intra = _f32_einsum("bnqth,bnthp->bnqhp", w, xc.to(bf))

    # --- per-chunk end-state: S_c = sum_s exp(ltot - lcum_s) dt_s B_s x_s
    decay_to_end = torch.exp(ltot[:, :, None, :] - lcum)  # (B,nc,Q,H)
    sc = _f32_einsum("bnqs,bnqh,bnqhp->bnhsp", bc.to(bf), (decay_to_end * dtc).to(bf),
                     xc.to(bf))  # (B,nc,H,N,P)

    # --- inter-chunk recurrence over nc (sequential, float32 carry)
    s_run = torch.zeros((bsz, h, state, p), dtype=torch.float32, device=xs.device)
    s_in = []
    for i in range(nc):
        s_in.append(s_run.to(bf))  # state entering chunk i
        s_run = s_run * torch.exp(ltot[:, i])[:, :, None, None] + sc[:, i]
    s_in = torch.stack(s_in, dim=1)  # (B,nc,H,N,P)

    # --- inter-chunk output: y_q += C_q . S_entry * exp(lcum_q)
    y_inter = _f32_einsum("bnqs,bnhsp,bnqh->bnqhp", cc.to(bf), s_in, torch.exp(lcum).to(bf))

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + hp["d_skip"][None, None, :, None] * xh.float()
    return y.reshape(bsz, s, h * p).to(bf), s_run


def ssd_forward(params, x, *, d_model: int, expand: int, state: int, chunk: int = 128,
                return_final_state: bool = False):
    """Full-sequence SSD.  x: (B, S, D) -> (B, S, D).  A sequence that is no
    multiple of ``chunk`` is padded with steps that leave the state as it
    is.  With ``return_final_state`` also returns the decode cache
    {conv, ssm} so prefill hands off exactly to ``ssd_decode_step``.

    With ``w_out`` as this rank's ``model`` block (``sharding.ops.use_tp``)
    the layer computes this rank's heads only (``_ssd_forward_tp``)."""
    from repro_torch.sharding.ops import tp_mesh

    d_inner, h, conv_dim = ssm_dims(d_model, expand, state)
    mesh = tp_mesh()
    if mesh is not None and params["w_out"].shape[0] != d_inner:
        return _ssd_forward_tp(params, x, mesh, d_model=d_model, expand=expand, state=state,
                               chunk=chunk, return_final_state=return_final_state)
    bsz, s_real, _ = x.shape
    pad = (-s_real) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    z, xs, b, c, dt = _split_in(params, x, d_inner, state, h)
    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"])
    xs, b, c = torch.split(conv_out, [d_inner, state, state], dim=-1)
    y, s_run = _ssd_scan(params, xs, b, c, dt, chunk=chunk, s_real=s_real)
    y = _gated_norm(y, z, params["norm_gamma"])
    out = (y @ params["w_out"].to(x.dtype))[:, :s_real]
    if return_final_state:
        final_cache = {
            "conv": conv_in[:, s_real - (CONV_K - 1):s_real, :],
            "ssm": s_run,
        }
        return out, final_cache
    return out


# ---------------------------------------------------------------------------
# the split over ``model``: a rank's heads
# ---------------------------------------------------------------------------
#
# ``w_in``'s packed columns [z | x | B | C | dt] and ``conv_w``'s channels
# [x | B | C] are cut by their rules into contiguous blocks that do not line
# up with heads, so the layer gathers both whole (the backward sums the
# ranks' gradients over ``model``) and takes rank r's columns: its heads'
# z, x and dt, and the whole of B and C, which every head reads (the
# reference pins them replicated).  ``w_out``'s rows are the rank's heads'
# channels: row-parallel on its ``model`` block.

HEAD_LEAVES = ("a_log", "dt_bias", "d_skip")


def tp_share(params, r: int, n: int, *, d_model: int, expand: int, state: int) -> dict:
    """Rank ``r`` of ``n``'s share of the whole SSM parameters (every leaf
    but ``w_out``): ``w_in``'s columns [z_r | x_r | B | C | dt_r],
    ``conv_w``'s channels [x_r | B | C], its heads' ``a_log``, ``dt_bias``
    and ``d_skip`` and its channels' ``norm_gamma``."""
    d_inner, h, _ = ssm_dims(d_model, expand, state)
    cl, hl = d_inner // n, h // n
    w_in = params["w_in"]
    share = {
        "w_in": torch.cat([w_in.narrow(1, r * cl, cl), w_in.narrow(1, d_inner + r * cl, cl),
                           w_in.narrow(1, 2 * d_inner, 2 * state),
                           w_in.narrow(1, 2 * d_inner + 2 * state + r * hl, hl)], dim=1),
        "conv_w": torch.cat([params["conv_w"].narrow(0, r * cl, cl),
                             params["conv_w"].narrow(0, d_inner, 2 * state)], dim=0),
        "norm_gamma": params["norm_gamma"].narrow(0, r * cl, cl),
    }
    share.update({k: params[k].narrow(0, r * hl, hl) for k in HEAD_LEAVES})
    return share


def gated_norm_tp(g, gamma, mesh, width: int, dtype, eps: float = 1e-6):
    """``layers.rms_norm`` of the gated product ``g`` (float32) over
    ``width`` channels split over ``model``, rounded to ``dtype``: each
    rank's float32 sum of squares, summed over ``model`` forward
    (``reduce_from_model``) and backward (``copy_to_model``: every rank's
    channels depend on the total), divided by the whole width."""
    from repro_torch.sharding.ops import copy_to_model, reduce_from_model

    total = copy_to_model(reduce_from_model((g * g).sum(dim=-1, keepdim=True), mesh), mesh)
    return ((g * torch.rsqrt(total / width + eps)) * (1.0 + gamma.float())).to(dtype)


def _ssd_forward_tp(params, x, mesh, *, d_model: int, expand: int, state: int, chunk: int,
                    return_final_state: bool):
    """``ssd_forward`` on this rank's ``h / tp`` heads: ``w_in``,
    ``conv_w`` and the per-head leaves whole (each rank takes its
    ``tp_share``; the gradients are summed over ``model`` where they were
    gathered), ``x``'s gradient summed over ``model`` in float32
    (``column_mm``), the gated norm's sum of squares summed over ``model``
    (``gated_norm_tp``), ``w_out`` row-parallel.  The final state is the
    rank's heads'; the conv history is whole (its x channels gathered over
    ``model``)."""
    from repro_torch.models.layers import _row_parallel, column_mm
    from repro_torch.sharding.ops import axis_index, gather_from_model

    d_inner, h, _ = ssm_dims(d_model, expand, state)
    n = mesh.shape["model"]
    if h % n:
        raise ValueError(f"{h} SSM heads do not split over a model axis of {n}")
    share = tp_share(params, axis_index("model", mesh), n, d_model=d_model, expand=expand,
                     state=state)
    hl, cl = h // n, d_inner // n
    s_real = x.shape[1]
    pad = (-s_real) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    z, xs, b, c, dt = torch.split(column_mm(x, share["w_in"], mesh), [cl, cl, state, state, hl],
                                  dim=-1)
    conv_in = torch.cat([xs, b, c], dim=-1)  # the rank's channels [x_r | B | C]
    xs, b, c = torch.split(_causal_conv(conv_in, share["conv_w"]), [cl, state, state], dim=-1)
    y, s_run = _ssd_scan(share, xs, b, c, dt, chunk=chunk, s_real=s_real)
    y = gated_norm_tp(y.float() * silu(z).float(), share["norm_gamma"], mesh, d_inner, x.dtype)
    out = _row_parallel(y, params["w_out"], mesh)[:, :s_real]
    if return_final_state:
        tail = conv_in[:, s_real - (CONV_K - 1):s_real, :]
        conv = torch.cat([gather_from_model(tail[..., :cl].contiguous(), 2, mesh),
                          tail[..., cl:]], dim=-1)
        return out, {"conv": conv, "ssm": s_run}
    return out


def ssm_cache_layout(batch: int, d_model: int, expand: int, state: int, dtype=torch.float32):
    """The SSM cache's leaves as (shape, dtype): the conv history
    (B, K - 1, conv channels) in ``dtype`` and the state (B, H, N, P) in
    float32."""
    _, h, conv_dim = ssm_dims(d_model, expand, state)
    return {"conv": ((batch, CONV_K - 1, conv_dim), dtype),
            "ssm": ((batch, h, state, HEADDIM), torch.float32)}


def ssm_init_cache(batch: int, d_model: int, expand: int, state: int, dtype=torch.float32,
                   device=None):
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in ssm_cache_layout(batch, d_model, expand, state, dtype).items()}


def _ssd_decode_heads(hp, xs, b, c, dt, state):
    """One decode step of the heads whose channels ``xs`` (B, H * P) holds
    (after the conv), with their ``dt`` (B, H) before the softplus, their
    leaves ``hp`` (``a_log``, ``dt_bias``, ``d_skip``) and their state
    (B, H, N, P) float32: (y (B, H * P) in ``xs``'s dtype, before the gate;
    the new state)."""
    bsz, h = dt.shape
    xh = xs.reshape(bsz, h, HEADDIM).float()
    dt = softplus(dt.float() + hp["dt_bias"])  # (B,H)
    a = -torch.exp(hp["a_log"])
    decay = torch.exp(dt * a)  # (B,H)
    s_new = state * decay[:, :, None, None] + torch.einsum("bn,bh,bhp->bhnp", b.float(), dt, xh)
    y = torch.einsum("bn,bhnp->bhp", c.float(), s_new)
    y = y + hp["d_skip"][None, :, None] * xh
    return y.reshape(bsz, h * HEADDIM).to(xs.dtype), s_new


def ssd_decode_step(params, x, cache, *, d_model: int, expand: int, state: int):
    """One-token decode.  x: (B, 1, D) -> (B, 1, D), updated cache (new
    tensors; the given cache is left as it was).  With ``w_out`` as this
    rank's ``model`` block the cache's ``ssm`` state is its heads' and the
    new one too (``_ssd_decode_step_tp``)."""
    from repro_torch.sharding.ops import tp_mesh

    d_inner, h, conv_dim = ssm_dims(d_model, expand, state)
    mesh = tp_mesh()
    if mesh is not None and params["w_out"].shape[0] != d_inner:
        return _ssd_decode_step_tp(params, x, cache, mesh, d_model=d_model, expand=expand,
                                   state=state)
    z, xs, b, c, dt = _split_in(params, x[:, 0], d_inner, state, h)
    conv_in = torch.cat([xs, b, c], dim=-1)  # (B, conv_dim)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)  # (B,K,C)
    w = params["conv_w"].to(x.dtype)  # (C,K)
    conv_out = silu(torch.einsum("bkc,ck->bc", hist, w))
    new_conv = hist[:, 1:]
    xs, b, c = torch.split(conv_out, [d_inner, state, state], dim=-1)

    y, s_new = _ssd_decode_heads(params, xs, b, c, dt, cache["ssm"])
    y = _gated_norm(y, z, params["norm_gamma"])
    out = y @ params["w_out"].to(x.dtype)
    return out[:, None], {"conv": new_conv, "ssm": s_new}


def _ssd_decode_step_tp(params, x, cache, mesh, *, d_model: int, expand: int, state: int):
    """``ssd_decode_step`` on this rank's heads.  ``cache``: the conv
    history whole (B, K - 1, conv_dim) and the state of the rank's heads
    (B, h / tp, N, P); returns the new ones alike, the new history's x
    channels gathered over ``model``."""
    from repro_torch.models.layers import _row_parallel, column_mm
    from repro_torch.sharding.ops import axis_index, gather_from_model

    d_inner, h, _ = ssm_dims(d_model, expand, state)
    n = mesh.shape["model"]
    if h % n:
        raise ValueError(f"{h} SSM heads do not split over a model axis of {n}")
    r = axis_index("model", mesh)
    share = tp_share(params, r, n, d_model=d_model, expand=expand, state=state)
    hl, cl = h // n, d_inner // n
    z, xs, b, c, dt = torch.split(column_mm(x[:, 0], share["w_in"], mesh),
                                  [cl, cl, state, state, hl], dim=-1)
    conv_in = torch.cat([xs, b, c], dim=-1)  # (B, cl + 2N): the rank's channels
    old = cache["conv"]
    hist = torch.cat([torch.cat([old.narrow(2, r * cl, cl), old[..., d_inner:]], dim=-1),
                      conv_in[:, None]], dim=1)  # (B,K,cl+2N)
    conv_out = silu(torch.einsum("bkc,ck->bc", hist, share["conv_w"].to(x.dtype)))
    xs, b, c = torch.split(conv_out, [cl, state, state], dim=-1)

    y, s_new = _ssd_decode_heads(share, xs, b, c, dt, cache["ssm"])
    g = y.float() * silu(z).float()
    out = _row_parallel(gated_norm_tp(g, share["norm_gamma"], mesh, d_inner, x.dtype),
                        params["w_out"], mesh)
    new_in = torch.cat([gather_from_model(conv_in[:, :cl].contiguous(), 1, mesh),
                        conv_in[:, cl:]], dim=-1)
    new_conv = torch.cat([old, new_in[:, None]], dim=1)[:, 1:]
    return out[:, None], {"conv": new_conv, "ssm": s_new}
