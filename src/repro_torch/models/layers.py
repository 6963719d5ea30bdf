"""Shared transformer building blocks (plain functions, params as dicts).

The PyTorch counterpart of the JAX package's ``models/layers.py``, its
single-device branches only (no mesh: the sharded attention core and the
sequence-sharded flash decode wait for the sharding slice).

Conventions, as in the reference:
  * activations are bf16 in compute; params are float32 as drawn, and every
    matmul weight is cast to the activation dtype at use (``w.to(x.dtype)``
    is free once ``LMEngine`` has cast the matmul weights to bf16, which
    gives the same bits); norm gammas stay float32,
  * attention is exact and chunked over queries: float32 scores, a -1e30
    mask, softmax in float32, then the probabilities cast to the value dtype.
    It is computed with ``torch.einsum``, never a fused attention call, so
    the numbers follow the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Init:
    """Where parameters are drawn: a seeded ``torch.Generator`` on
    ``device`` (``None`` on the ``meta`` device, which only gives shapes),
    and the leading axes every leaf gets (``lead=(n_layers,)`` for stacked
    blocks)."""
    generator: Optional[torch.Generator]
    device: torch.device
    lead: tuple = ()

    def stacked(self, n: int) -> "Init":
        return dataclasses.replace(self, lead=self.lead + (n,))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(self.lead + tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(self.lead + tuple(shape), device=self.device, dtype=torch.float32)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(self.lead + tuple(shape), device=self.device, dtype=torch.float32)


def dense_init(init: Init, shape, in_axis: int = 0) -> torch.Tensor:
    fan_in = shape[in_axis]
    return init.normal(shape).mul_(1.0 / np.sqrt(max(fan_in, 1)))


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(x.dtype)


def silu(x):
    """``jax.nn.silu`` op by op in ``x``'s dtype: ``x * (1 / (1 + exp(-x)))``,
    each op rounded to that dtype as the reference rounds it (a fused
    ``F.silu`` rounds once and differs in a third of bf16 outputs)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (a host scalar, so
    using it copies nothing to the device)."""
    return float(torch.tensor(value, dtype=dtype))


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form, op by op in ``x``'s dtype,
    its constants rounded to that dtype as the reference's are."""
    c = lambda v: _rounded(v, x.dtype)
    inner = c(float(np.sqrt(2 / np.pi))) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (1.0 + torch.tanh(inner)))


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def act_fn(name: str):
    return {"silu": silu, "gelu": gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The float32 frequencies on ``device``, copied there once (a copy
    from pageable host memory waits for the device's queue to drain)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh), positions: broadcastable to (..., S).  Split
    halves (not interleaved pairs), computed in float32."""
    dh = x.shape[-1]
    freqs = _rope_freqs_on(dh, float(theta), x.device)
    ang = positions[..., :, None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int


def attn_params(init: Init, d_model: int, dims: AttnDims):
    h, k, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    return {
        "wq": dense_init(init, (d_model, h * dh)),
        "wk": dense_init(init, (d_model, k * dh)),
        "wv": dense_init(init, (d_model, k * dh)),
        "wo": dense_init(init, (h * dh, d_model)),
    }


def _chunked_softmax_attn(q, k, v, *, causal: bool, window: int, q_chunk: int,
                          q_offset: int = 0, kv_len: Optional[int] = None):
    """Exact attention, queries chunked.  q: (B,Sq,K,G,Dh) k/v: (B,Skv,K,Dh).

    ``window`` > 0 masks keys older than ``window`` positions (sliding
    window); 0 means full attention.  ``q_offset`` is the absolute position
    of q[0] (decode with cache).  ``kv_len`` masks out the cache's tail
    beyond the valid length.
    """
    b, sq, kh, g, dh = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    scale = 1.0 / np.sqrt(dh)
    kpos = torch.arange(skv, device=q.device)
    k32 = k.float()
    outs = []
    for start in range(0, sq, q_chunk):
        qi = q[:, start:start + q_chunk]
        n = qi.shape[1]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qi.float(), k32) * scale
        qpos = q_offset + start + torch.arange(n, device=q.device)
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= (kpos < kv_len)[None, :]
        scores = torch.where(mask, scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v))
    return torch.cat(outs, dim=1)


def attention(params, x, dims: AttnDims, *, positions, causal=True, window: int = 0,
              rope_theta=10000.0, q_chunk=512, kv_cache=None, cache_pos: Optional[int] = None):
    """Full attention layer.  x: (B, S, D).

    If ``kv_cache`` is given (dict with k/v of shape (B, Smax, K, Dh)), the
    new K/V are written into it at ``cache_pos`` (slice assignment, in
    place) and attention runs over the cache with its tail beyond
    ``cache_pos + S`` masked.  Returns (out, the cache or None).
    """
    b, s, _ = x.shape
    h, kh, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // kh
    xq = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, dh)
    xk = (x @ params["wk"].to(x.dtype)).reshape(b, s, kh, dh)
    xv = (x @ params["wv"].to(x.dtype)).reshape(b, s, kh, dh)
    xq = apply_rope(xq, positions, rope_theta).reshape(b, s, kh, g, dh)
    xk = apply_rope(xk, positions, rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        if cache_pos + s > ck.shape[1]:
            raise ValueError(f"cache of {ck.shape[1]} positions cannot take {s} more "
                             f"at position {cache_pos}")
        ck[:, cache_pos:cache_pos + s] = xk.to(ck.dtype)
        cv[:, cache_pos:cache_pos + s] = xv.to(cv.dtype)
        out = _chunked_softmax_attn(xq, ck, cv, causal=causal, window=window, q_chunk=q_chunk,
                                    q_offset=cache_pos, kv_len=cache_pos + s)
    else:
        out = _chunked_softmax_attn(xq, xk, xv, causal=causal, window=window, q_chunk=q_chunk)
    out = out.reshape(b, s, h * dh)
    return out @ params["wo"].to(x.dtype), kv_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(init: Init, d_model: int, d_ff: int):
    return {
        "w_gate": dense_init(init, (d_model, d_ff)),
        "w_up": dense_init(init, (d_model, d_ff)),
        "w_down": dense_init(init, (d_ff, d_model)),
    }


def mlp(params, x, act: str = "silu"):
    a = act_fn(act)
    gate = a(x @ params["w_gate"].to(x.dtype))
    up = x @ params["w_up"].to(x.dtype)
    return (gate * up) @ params["w_down"].to(x.dtype)


def no_tf32() -> None:
    """The reference computes attention scores and the SSD's einsums in
    float32, and accumulates bf16 products in float32: keep TF32 and reduced
    precision reductions off on the card, so cuBLAS does the same."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

