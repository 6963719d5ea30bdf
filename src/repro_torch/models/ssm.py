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
rank's share only, as the reference's partitioned program does: its
heads' z, x and dt columns of the in-projection and ``state / tp`` columns
each of B and C (so the ranks' columns make the whole in-projection once),
the conv on those channels alone, B and C then gathered over ``model``
(their gradients summed and scattered back), the SSD on its heads, the
gated norm with its sum of squares summed over ``model``, and ``w_out``
row-parallel (``_ssd_forward_tp``, ``_ssd_decode_step_tp``).
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
# the split over ``model``: a rank's heads, and its share of B and C
# ---------------------------------------------------------------------------
#
# Rank r of n computes ``w_in``'s packed columns [z_r | x_r | B_r | C_r |
# dt_r]: its heads' z, x and dt and the r-th ``state / n`` of B and of C
# (``in_columns``), and convolves its channels [x_r | B_r | C_r] of
# ``conv_w`` (``conv_channels``; the conv is per channel).  The rules cut
# both leaves into contiguous ``model`` blocks that do not line up with
# these, so the layer gathers its pieces from the ranks that hold them
# (``sharding.ops.Block.model_pieces``).  B and C are gathered whole over
# ``model`` after the conv, since every head reads them
# (``_gather_bc``).  ``w_out``'s rows are the rank's heads' channels:
# row-parallel on its ``model`` block.

HEAD_LEAVES = ("a_log", "dt_bias", "d_skip")


def splits_over(n: int, *, d_model: int, expand: int, state: int) -> bool:
    """Whether the layer splits over a ``model`` axis of ``n``: its heads
    and its state both divide ``n``."""
    return ssm_dims(d_model, expand, state)[1] % n == 0 and state % n == 0


def in_columns(r: int, n: int, *, d_model: int, expand: int, state: int) -> tuple:
    """Rank ``r`` of ``n``'s columns of ``w_in``, ((start, length), ...)
    ascending: [z_r | x_r | B_r | C_r | dt_r]."""
    d_inner, h, _ = ssm_dims(d_model, expand, state)
    cl, sl, hl = d_inner // n, state // n, h // n
    return ((r * cl, cl), (d_inner + r * cl, cl), (2 * d_inner + r * sl, sl),
            (2 * d_inner + state + r * sl, sl), (2 * d_inner + 2 * state + r * hl, hl))


def conv_channels(r: int, n: int, *, d_model: int, expand: int, state: int) -> tuple:
    """Rank ``r`` of ``n``'s channels of ``conv_w`` (and of the conv
    history), ((start, length), ...) ascending: [x_r | B_r | C_r]."""
    d_inner = ssm_dims(d_model, expand, state)[0]
    cl, sl = d_inner // n, state // n
    return ((r * cl, cl), (d_inner + r * sl, sl), (d_inner + state + r * sl, sl))


def tp_share(params, r: int, n: int, *, d_model: int, expand: int, state: int) -> dict:
    """Rank ``r`` of ``n``'s share of the SSM parameters (every leaf but
    ``w_out``): ``w_in`` and ``conv_w`` as given (the rank's pieces,
    ``in_columns`` and ``conv_channels``), its heads' ``a_log``,
    ``dt_bias`` and ``d_skip`` and its channels' ``norm_gamma`` cut from the
    whole."""
    d_inner, h, _ = ssm_dims(d_model, expand, state)
    cl, hl = d_inner // n, h // n
    share = {"w_in": params["w_in"], "conv_w": params["conv_w"],
             "norm_gamma": params["norm_gamma"].narrow(0, r * cl, cl)}
    share.update({k: params[k].narrow(0, r * hl, hl) for k in HEAD_LEAVES})
    return share


def _gather_bc(bc, mesh, state: int):
    """B and C whole (each (..., state)) from this rank's channels ``bc``
    [B_r | C_r] after the conv: one gather over ``model``, whose backward
    sums the ranks' gradients (each rank's heads read all of B and C) and
    scatters them back."""
    from repro_torch.sharding.ops import gather_from_model

    n = mesh.shape["model"]
    whole = gather_from_model(bc.contiguous(), bc.dim() - 1, mesh, summed=True)
    parts = whole.unflatten(-1, (n, 2, state // n))
    return parts.select(-2, 0).flatten(-2), parts.select(-2, 1).flatten(-2)


def _whole_channels(t, mesh, d_inner: int, state: int):
    """The conv history's channels whole, [x | B | C], from this rank's
    [x_r | B_r | C_r] ``t`` (no gradient)."""
    from repro_torch.sharding.ops import gather_from_model

    n = mesh.shape["model"]
    cl, sl = d_inner // n, state // n
    ranks = gather_from_model(t.contiguous(), t.dim() - 1, mesh).unflatten(-1, (n, cl + 2 * sl))
    return torch.cat([ranks.narrow(-1, a, l).flatten(-2)
                      for a, l in ((0, cl), (cl, sl), (cl + sl, sl))], dim=-1)


def gated_norm_tp(g, gamma, mesh, width: int, dtype, eps: float = 1e-6):
    """``layers.rms_norm`` of the gated product ``g`` (float32) over
    ``width`` channels split over ``model``, rounded to ``dtype``: each
    rank's float32 sum of squares, summed over ``model`` forward
    (``reduce_from_model``) and backward (``copy_to_model``: every rank's
    channels depend on the total), divided by the whole width."""
    from repro_torch.sharding.ops import copy_to_model, reduce_from_model

    total = copy_to_model(reduce_from_model((g * g).sum(dim=-1, keepdim=True), mesh), mesh)
    return ((g * torch.rsqrt(total / width + eps)) * (1.0 + gamma.float())).to(dtype)


def _split_check(n: int, **dims) -> None:
    if not splits_over(n, **dims):
        raise ValueError(f"an SSM of {dims} does not split over a model axis of {n}")


def _ssd_forward_tp(params, x, mesh, *, d_model: int, expand: int, state: int, chunk: int,
                    return_final_state: bool):
    """``ssd_forward`` on this rank's ``h / tp`` heads and ``state / tp``
    columns each of B and C: ``w_in`` and ``conv_w`` as the rank's pieces
    (``tp_share``), ``x``'s gradient summed over ``model`` in float32
    (``column_mm``), B and C gathered over ``model`` after the conv
    (``_gather_bc``), the gated norm's sum of squares summed over ``model``
    (``gated_norm_tp``), ``w_out`` row-parallel.  The final state is the
    rank's heads'; the conv history is whole (the ranks' channels gathered
    over ``model``)."""
    from repro_torch.models.layers import _row_parallel, column_mm
    from repro_torch.sharding.ops import axis_index

    d_inner, h, _ = ssm_dims(d_model, expand, state)
    n = mesh.shape["model"]
    _split_check(n, d_model=d_model, expand=expand, state=state)
    share = tp_share(params, axis_index("model", mesh), n, d_model=d_model, expand=expand,
                     state=state)
    hl, cl, sl = h // n, d_inner // n, state // n
    s_real = x.shape[1]
    pad = (-s_real) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    z, conv_in, dt = torch.split(column_mm(x, share["w_in"], mesh), [cl, cl + 2 * sl, hl],
                                 dim=-1)  # conv_in: the rank's channels [x_r | B_r | C_r]
    xs, bc = torch.split(_causal_conv(conv_in, share["conv_w"]), [cl, 2 * sl], dim=-1)
    b, c = _gather_bc(bc, mesh, state)
    y, s_run = _ssd_scan(share, xs, b, c, dt, chunk=chunk, s_real=s_real)
    y = gated_norm_tp(y.float() * silu(z).float(), share["norm_gamma"], mesh, d_inner, x.dtype)
    out = _row_parallel(y, params["w_out"], mesh)[:, :s_real]
    if return_final_state:
        conv = _whole_channels(conv_in[:, s_real - (CONV_K - 1):s_real], mesh, d_inner, state)
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
    """``ssd_decode_step`` on this rank's heads and its share of B and C.
    ``cache``: the conv history whole (B, K - 1, conv_dim) and the state of
    the rank's heads (B, h / tp, N, P); returns the new ones alike, the new
    history's channels gathered over ``model``."""
    from repro_torch.models.layers import _row_parallel, column_mm
    from repro_torch.sharding.ops import axis_index

    d_inner, h, _ = ssm_dims(d_model, expand, state)
    n = mesh.shape["model"]
    _split_check(n, d_model=d_model, expand=expand, state=state)
    r = axis_index("model", mesh)
    share = tp_share(params, r, n, d_model=d_model, expand=expand, state=state)
    hl, cl, sl = h // n, d_inner // n, state // n
    z, conv_in, dt = torch.split(column_mm(x[:, 0], share["w_in"], mesh), [cl, cl + 2 * sl, hl],
                                 dim=-1)  # conv_in (B, cl + 2 sl): the rank's channels
    old = cache["conv"]
    mine = torch.cat([old.narrow(2, a, l) for a, l in
                      conv_channels(r, n, d_model=d_model, expand=expand, state=state)], dim=2)
    hist = torch.cat([mine, conv_in[:, None]], dim=1)  # (B,K,cl+2sl)
    conv_out = silu(torch.einsum("bkc,ck->bc", hist, share["conv_w"].to(x.dtype)))
    xs, bc = torch.split(conv_out, [cl, 2 * sl], dim=-1)
    b, c = _gather_bc(bc, mesh, state)

    y, s_new = _ssd_decode_heads(share, xs, b, c, dt, cache["ssm"])
    g = y.float() * silu(z).float()
    out = _row_parallel(gated_norm_tp(g, share["norm_gamma"], mesh, d_inner, x.dtype),
                        params["w_out"], mesh)
    new_in = _whole_channels(conv_in, mesh, d_inner, state)
    new_conv = torch.cat([old, new_in[:, None]], dim=1)[:, 1:]
    return out[:, None], {"conv": new_conv, "ssm": s_new}
