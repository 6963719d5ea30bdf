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


def ssd_forward(params, x, *, d_model: int, expand: int, state: int, chunk: int = 128,
                return_final_state: bool = False):
    """Full-sequence SSD.  x: (B, S, D) -> (B, S, D).  A sequence that is no
    multiple of ``chunk`` is padded with steps that leave the state as it
    is.  With ``return_final_state`` also returns the decode cache
    {conv, ssm} so prefill hands off exactly to ``ssd_decode_step``."""
    d_inner, h, conv_dim = ssm_dims(d_model, expand, state)
    bsz, s_real, _ = x.shape
    pad = (-s_real) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    s = s_real + pad
    z, xs, b, c, dt = _split_in(params, x, d_inner, state, h)
    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"])
    xs, b, c = torch.split(conv_out, [d_inner, state, state], dim=-1)

    p = HEADDIM
    xh = xs.reshape(bsz, s, h, p)
    dt = softplus(dt.float() + params["dt_bias"])  # (B,S,H)
    if pad:
        # padded steps must be state-identities: dt=0 -> decay=1, no input
        valid = (torch.arange(s, device=x.device) < s_real)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    a = -torch.exp(params["a_log"])  # (H,)
    da = dt * a  # (B,S,H) log-decay per step, negative

    nc = s // chunk
    dac = da.reshape(bsz, nc, chunk, h)
    dtc = dt.reshape(bsz, nc, chunk, h)
    xc = xh.reshape(bsz, nc, chunk, h, p)
    bc = b.reshape(bsz, nc, chunk, state)
    cc = c.reshape(bsz, nc, chunk, state)

    lcum = torch.cumsum(dac, dim=2)  # (B,nc,Q,H) inclusive cumulative log-decay
    ltot = lcum[:, :, -1]  # (B,nc,H)
    bf = x.dtype  # bf16 for the (Q x Q) work; the recurrence stays float32

    # --- intra-chunk: masked (Q x Q) attention-like matmul
    # decay(q,s) = exp(lcum_q - lcum_s) for s <= q; exp in f32, product in bf16
    dq = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    dec = torch.exp(torch.where(mask[None, None, :, :, None], dq, float("-inf"))).to(bf)
    scores = torch.einsum("bnqs,bnts->bnqt", cc.to(bf), bc.to(bf))
    w = scores[..., None] * dec * dtc[:, :, None, :, :].to(bf)  # (B,nc,Q,Q,H)
    y_intra = _f32_einsum("bnqth,bnthp->bnqhp", w, xc.to(bf))

    # --- per-chunk end-state: S_c = sum_s exp(ltot - lcum_s) dt_s B_s x_s
    decay_to_end = torch.exp(ltot[:, :, None, :] - lcum)  # (B,nc,Q,H)
    sc = _f32_einsum("bnqs,bnqh,bnqhp->bnhsp", bc.to(bf), (decay_to_end * dtc).to(bf),
                     xc.to(bf))  # (B,nc,H,N,P)

    # --- inter-chunk recurrence over nc (sequential, float32 carry)
    s_run = torch.zeros((bsz, h, state, p), dtype=torch.float32, device=x.device)
    s_in = []
    for i in range(nc):
        s_in.append(s_run.to(bf))  # state entering chunk i
        s_run = s_run * torch.exp(ltot[:, i])[:, :, None, None] + sc[:, i]
    s_in = torch.stack(s_in, dim=1)  # (B,nc,H,N,P)

    # --- inter-chunk output: y_q += C_q . S_entry * exp(lcum_q)
    y_inter = _f32_einsum("bnqs,bnhsp,bnqh->bnqhp", cc.to(bf), s_in, torch.exp(lcum).to(bf))

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm_gamma"])
    out = (y @ params["w_out"].to(x.dtype))[:, :s_real]
    if return_final_state:
        final_cache = {
            "conv": conv_in[:, s_real - (CONV_K - 1):s_real, :],
            "ssm": s_run,
        }
        return out, final_cache
    return out


def ssm_init_cache(batch: int, d_model: int, expand: int, state: int, dtype=torch.float32,
                   device=None):
    d_inner, h, conv_dim = ssm_dims(d_model, expand, state)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, state, HEADDIM), dtype=torch.float32, device=device),
    }


def ssd_decode_step(params, x, cache, *, d_model: int, expand: int, state: int):
    """One-token decode.  x: (B, 1, D) -> (B, 1, D), updated cache (new
    tensors; the given cache is left as it was)."""
    d_inner, h, conv_dim = ssm_dims(d_model, expand, state)
    bsz = x.shape[0]
    z, xs, b, c, dt = _split_in(params, x[:, 0], d_inner, state, h)
    conv_in = torch.cat([xs, b, c], dim=-1)  # (B, conv_dim)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)  # (B,K,C)
    w = params["conv_w"].to(x.dtype)  # (C,K)
    conv_out = silu(torch.einsum("bkc,ck->bc", hist, w))
    new_conv = hist[:, 1:]
    xs, b, c = torch.split(conv_out, [d_inner, state, state], dim=-1)

    p = HEADDIM
    xh = xs.reshape(bsz, h, p).float()
    dt = softplus(dt.float() + params["dt_bias"])  # (B,H)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a)  # (B,H)
    s_new = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", b.float(), dt, xh)
    y = torch.einsum("bn,bhnp->bhp", c.float(), s_new)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm_gamma"])
    out = y @ params["w_out"].to(x.dtype)
    return out[:, None], {"conv": new_conv, "ssm": s_new}
