"""Shared transformer building blocks (plain functions, params as dicts).

The PyTorch counterpart of the JAX package's ``models/layers.py``.  Under
an active mesh (``sharding.ops.use_mesh``) the attention core runs as the
reference's ``shard_map`` does: batch x heads split over the mesh, or the
KV sequence split with a partial-softmax combine (distributed flash
decode); see ``_attn_core``.  Activations are plain tensors, the same
global values on every rank, so the reference's ``constrain`` calls on
q/k/v, which steer its compiler's placement, have nothing to act on here:
the placements they pin are the core's in specs.

Where the weights come as ``model`` blocks (``sharding.ops.use_tp``: the
sharded train step and the dry run hand the model ``Block``s), the layers
split their work over ``model`` as the reference's partitioned program
does (``_attention_tp``, ``mlp``): ``wq``/``wk``/``wv``/``w_gate``/``w_up``
column-parallel on the rank's heads or FFN columns, ``wo``/``w_down``
row-parallel, then one all-reduce over ``model``.  Serving on each rank's
rows (``transformer._rows_of``) the ambient mesh is put aside: the layers
are given the rank's rows and cut or gather none, and a cache whose
positions split over ``model`` is read by a flash decode over ``model``
(``_core_on_position_shares``).  A partial that is
summed over the ranks, forward (a row-parallel output) or backward (each
column-parallel matmul's input gradient), is the float32 product of the
bf16 operands, summed in float32 and rounded once where the whole layer's
matmul rounds (``_ColumnMM``, ``_RowMM``); everything else is the bf16
matmul the whole layer runs.  So a split layer gives the whole layer's
bits but for the order of the float32 adds.  (Partials rounded to bf16
before the sum moved the smoke models' updates several times farther from
the one-device step's and flipped MoE routing on near-ties.)
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


def _flash_decode_partial(q, k, v, window: int, q_offset: int, kv_len: int, seq_axis, mesh):
    """Exact attention over a sequence-sharded KV cache (distributed flash
    decode): each shard computes unnormalized (m, l, o) over its local keys;
    a pmax/psum pair over ``seq_axis`` combines them.  q: (B,Sq,KH,G,Dh),
    k/v local: (B,S_loc,KH,Dh)."""
    from repro_torch.sharding.ops import axis_index, pmax, psum

    b, sq, kh, g, dh = q.shape
    s_loc = k.shape[1]
    scale = 1.0 / np.sqrt(dh)
    offset = axis_index(seq_axis, mesh) * s_loc
    kpos = offset + torch.arange(s_loc, device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    mask = kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask &= (kpos < kv_len)[None, :]
    scores = torch.where(mask, scores, -torch.inf)
    m_loc = scores.amax(dim=-1)  # (B,KH,G,Sq)
    p = torch.exp(scores - m_loc[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)  # all-masked shard -> zeros
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    m = pmax(m_loc, seq_axis, mesh)
    corr = torch.where(torch.isfinite(m_loc), torch.exp(m_loc - m), 0.0)
    l = psum(l_loc * corr, seq_axis, mesh)
    o = psum(o_loc * corr[..., None], seq_axis, mesh)
    out = o / torch.clamp(l[..., None], min=1e-30)
    # (B,KH,G,Sq,Dh) -> (B,Sq,KH,G,Dh)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


def _attn_specs(mesh, b, kh, g, skv, sq):
    """(batch_axes, kv_sharded, seq_axis) placement decisions shared with
    ``repro_torch.sharding.rules.cache_shardings``: keep the two in sync.

    Sequence sharding (partial-softmax combine) pays a psum of the (.., Sq,
    Dh) output per call, so it is taken for decode only (sq == 1): over
    ``model`` where the kv heads do not divide it, and over ``data`` for a
    long cache at batch 1."""
    tp = mesh.shape.get("model", 1)
    batch_axes = []
    total = 1
    for a in ("pod", "data"):
        size = mesh.shape.get(a, 1)
        if size > 1 and b % (total * size) == 0:
            batch_axes.append(a)
            total *= size
    kv_sharded = tp > 1 and kh % tp == 0
    seq_axis = None
    if sq == 1:
        if not kv_sharded and tp > 1 and skv is not None and skv % tp == 0:
            seq_axis = "model"
        if skv is not None and "data" not in batch_axes and mesh.shape.get("data", 1) > 1 \
                and skv % (mesh.shape["data"] * (tp if seq_axis else 1)) == 0 and b == 1:
            # long-context decode at batch 1: shard the cache seq over data
            seq_axis = seq_axis or "data"
    return tuple(batch_axes), kv_sharded, seq_axis


def _write_cache(cache, pos: int, new) -> None:
    """``new`` (B, S, K, Dh) into the cache at positions [pos, pos + S), in
    place; a ``sharding.ops.Block`` cache (a rank's share, placed by
    ``rules.cache_shardings``) takes this rank's share of it."""
    from repro_torch.sharding.ops import Block

    if isinstance(cache, Block):
        cache.put(1, pos, new.to(cache.dtype))
    else:
        cache[:, pos:pos + new.shape[1]] = new.to(cache.dtype)


def attention(params, x, dims: AttnDims, *, positions, causal=True, window: int = 0,
              rope_theta=10000.0, q_chunk=512, kv_cache=None, cache_pos: Optional[int] = None):
    """Full attention layer.  x: (B, S, D).

    If ``kv_cache`` is given (dict with k/v of shape (B, Smax, K, Dh), or
    their ``Block``s under a mesh), the new K/V are written into it at
    ``cache_pos`` (slice assignment, in place) and attention runs over the
    cache with its tail beyond ``cache_pos + S`` masked.  Returns (out, the
    cache or None).

    Under an active mesh the score/softmax core runs per rank
    (``_attn_core``).  Where the kv heads do not divide the ``model`` axis
    but the query heads do, K/V are repeated to one head per query head
    before a prefill core, so the merged heads split over ``model``.  With
    the query weights as ``model`` blocks the layer is tensor-parallel
    (``_attention_tp``).
    """
    from repro_torch.sharding.ops import Block, current_mesh, tp_mesh

    b, s, _ = x.shape
    h, kh, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // kh
    tpm = tp_mesh()
    if tpm is not None and params["wq"].shape[1] != h * dh:
        return _attention_tp(params, x, dims, tpm, positions=positions, causal=causal,
                             window=window, rope_theta=rope_theta, q_chunk=q_chunk,
                             kv_cache=kv_cache, cache_pos=cache_pos)
    mesh = current_mesh()
    tp = mesh.shape.get("model", 1) if mesh else 1
    xq = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, dh)
    xk = (x @ params["wk"].to(x.dtype)).reshape(b, s, kh, dh)
    xv = (x @ params["wv"].to(x.dtype)).reshape(b, s, kh, dh)
    xq = apply_rope(xq, positions, rope_theta)
    xk = apply_rope(xk, positions, rope_theta)
    merged_tp = tp > 1 and h % tp == 0 and kh % tp != 0

    if kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        if cache_pos + s > ck.shape[1]:
            raise ValueError(f"cache of {ck.shape[1]} positions cannot take {s} more "
                             f"at position {cache_pos}")
        _write_cache(ck, cache_pos, xk)
        _write_cache(cv, cache_pos, xv)
        q = xq.reshape(b, s, kh, g, dh)
        if mesh is None and isinstance(ck, Block):
            # this rank's rows of a cache whose positions split over `model`
            out = _core_on_position_shares(q, xk, xv, ck, cv, causal=causal, window=window,
                                           q_chunk=q_chunk, cache_pos=cache_pos)
        else:
            out = _attn_core(q, ck, cv, causal=causal, window=window, q_chunk=q_chunk,
                             q_offset=cache_pos, kv_len=cache_pos + s, mesh=mesh)
    else:
        if merged_tp and s > 1:
            # repeat KV to one head per query head; merged heads shard cleanly
            xk = torch.repeat_interleave(xk, g, dim=2)
            xv = torch.repeat_interleave(xv, g, dim=2)
            xq = xq.reshape(b, s, h, 1, dh)
        else:
            xq = xq.reshape(b, s, kh, g, dh)
        out = _attn_core(xq, xk, xv, causal=causal, window=window, q_chunk=q_chunk, mesh=mesh)
    out = out.reshape(b, s, h * dh)
    return out @ params["wo"].to(x.dtype), kv_cache


class _ColumnMM(torch.autograd.Function):
    """``x @ w`` with ``x`` held alike by the ``model`` ranks and ``w`` this
    rank's columns: forward the matmul (a column block of the whole layer's
    product), backward ``x``'s gradient as the ranks' float32 partials
    summed over ``model`` and rounded once to ``x``'s dtype (where the
    whole layer's matmul rounds it), and ``w``'s as the matmul gives it."""

    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return x @ w

    @staticmethod
    def backward(ctx, g):
        from repro_torch.sharding.ops import sum_over_model

        x, w = ctx.saved_tensors
        gx = sum_over_model(g.float() @ w.float().t(), ctx.mesh).to(x.dtype)
        gw = x.reshape(-1, w.shape[0]).t() @ g.reshape(-1, w.shape[1])
        return gx, gw, None


class _RowMM(torch.autograd.Function):
    """``y @ w``'s backward: both gradients as the ``w.dtype`` matmul gives
    them.  Its forward saves ``y`` and ``w`` and returns a placeholder of the
    product's shape (no memory) through which the product's gradient
    arrives; ``_RowProduct`` computes the product after it.  So a
    rematerialized block (``transformer._checkpointed``, whose recompute
    stops early at the last tensor the block saved) stops before this
    matmul, as it stops before the whole layer's last one: a custom
    function saves its tensors only after its forward has run."""

    @staticmethod
    def forward(ctx, y, w):
        ctx.save_for_backward(y, w)
        return y.new_zeros((), dtype=torch.float32).expand(*y.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.to(w.dtype)
        return g @ w.t(), y.reshape(-1, w.shape[0]).t() @ g.reshape(-1, w.shape[1])


class _RowProduct(torch.autograd.Function):
    """``y @ w`` forward as the float32 product of the ``w.dtype`` operands
    (a partial that ``reduce_from_model`` sums before anything rounds it);
    its gradient passes to ``_RowMM``'s placeholder."""

    @staticmethod
    def forward(ctx, placeholder, y, w):
        return y.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def column_mm(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """A column-parallel matmul's share: ``x`` times this rank's columns of
    ``w`` rounded to ``x``'s dtype (``_ColumnMM``)."""
    return _ColumnMM.apply(x, w.to(x.dtype), mesh)


def _row_parallel(y: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``y @ w`` where ``y``'s columns and ``w``'s rows are this rank's
    ``model`` share: the float32 partial products summed over ``model``,
    rounded once."""
    from repro_torch.sharding.ops import reduce_from_model

    w = w.to(y.dtype)
    partial = _RowProduct.apply(_RowMM.apply(y, w), y.detach(), w.detach())
    return reduce_from_model(partial, mesh).to(y.dtype)


def _attention_tp(params, x, dims: AttnDims, mesh, *, positions, causal, window, rope_theta,
                  q_chunk, kv_cache, cache_pos):
    """The attention layer with its weights as this rank's ``model``
    blocks: ``wq`` (and ``wk``/``wv`` where their columns divide ``model``)
    column-parallel, ``wo`` row-parallel.  A rank computes its ``h / tp``
    query heads.  Where the kv heads divide ``model`` its ``wk``/``wv``
    columns are its heads' kv heads; where they do not, K/V are made whole
    (gathered from the rank's columns, or computed whole where the rule
    leaves ``wk`` whole), as the reference pins them replicated, and the
    rank reads the kv head of each of its query heads (the merged-head
    split; a head is never cut).  The core runs on the rank's heads of the
    rows it is given; with a cache (serving), on the rows and positions the
    cache holds on this rank (``_cached_core_tp``)."""
    from repro_torch.sharding.ops import axis_index, copy_to_model, gather_from_model

    b, s, _ = x.shape
    h, kh, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // kh
    tp = mesh.shape["model"]
    if h % tp:
        raise ValueError(f"{h} query heads do not split over a model axis of {tp}")
    hl = h // tp
    kv_local = kh % tp == 0

    def project(w):
        if w.shape[1] == kh * dh:  # the rule leaves it whole: computed alike on every rank
            return (x @ w.to(x.dtype)).reshape(b, s, kh, dh)
        part = column_mm(x, w, mesh)
        if kv_local:
            return part.reshape(b, s, kh // tp, dh)
        return gather_from_model(part, 2, mesh).reshape(b, s, kh, dh)

    # in the whole layer's order (q, k and v, then the rotations), so the
    # backward pass sums the three input gradients in its order
    xq = column_mm(x, params["wq"], mesh).reshape(b, s, hl, dh)
    xk = project(params["wk"])
    xv = project(params["wv"])
    xq = apply_rope(xq, positions, rope_theta)
    xk = apply_rope(xk, positions, rope_theta)

    if kv_cache is not None:
        out = _cached_core_tp(xq, xk, xv, kv_cache, dims, mesh, causal=causal, window=window,
                              q_chunk=q_chunk, cache_pos=cache_pos)
        return _row_parallel(out, params["wo"], mesh), kv_cache

    if kv_local:
        xq = xq.reshape(b, s, kh // tp, g, dh)
    else:
        # each of this rank's query heads reads its kv head; the kv heads
        # are held alike, so their gradient is summed over the ranks
        heads = (torch.arange(hl, device=x.device) + axis_index("model", mesh) * hl) // g
        pick = lambda t: copy_to_model(t.float(), mesh).index_select(2, heads).to(t.dtype)
        xk, xv = pick(xk), pick(xv)
        xq = xq.reshape(b, s, hl, 1, dh)
    out = _chunked_softmax_attn(xq, xk, xv, causal=causal, window=window, q_chunk=q_chunk)
    return _row_parallel(out.reshape(b, s, hl * dh), params["wo"], mesh), None


def _core_on_position_shares(q, xk, xv, ck, cv, *, causal, window, q_chunk, cache_pos):
    """Attention of ``q`` (B, S, KH, G, Dh) on this rank's rows over a
    ``Block`` cache whose positions split over ``model``, the new K/V
    (B, S, KH, Dh) already written into it: at position 0 over the new K/V
    themselves (all the cache holds; its zero tail is masked anyway), else a
    flash decode over the ``model`` shares of the positions."""
    if cache_pos == 0:
        return _chunked_softmax_attn(q, xk, xv, causal=causal, window=window, q_chunk=q_chunk)
    return _flash_decode_partial(q, ck.local, cv.local, window, cache_pos,
                                 cache_pos + q.shape[1], "model", ck.mesh)


def _cached_core_tp(xq, xk, xv, kv_cache, dims: AttnDims, mesh, *, causal, window, q_chunk,
                    cache_pos):
    """``_attention_tp``'s core with a cache: this rank's new K/V written
    into it, and its query heads' output (B, S, h / tp * Dh) over the cache.
    A plain cache holds every row and head, so the new K/V are written
    whole; a ``Block`` cache (``rules.cache_shardings``) holds this rank's
    rows, its kv heads where they split over ``model``, and its positions
    where they split over ``data``, so the rank writes its heads.  The
    core runs on the rows it is given, and nothing cuts or gathers them:
    on each rank's rows (``transformer._rows_of``) they are the rank's own,
    and under the ambient mesh the batch axes do not divide the batch (a
    batch they divide takes the rows' route), so every rank holds every row
    and runs a flash decode over ``data`` where the positions split.  A
    cache whose positions split over ``model`` (kv heads that do not divide
    it) needs every query head on every rank: q is gathered and the mesh
    core runs (``_attn_core``), or on the rank's rows a flash decode over
    ``model`` (``_core_on_position_shares``; at position 0 the rank's query
    heads read the new K/V)."""
    from repro_torch.sharding.ops import (Block, P, axis_index, current_mesh, entry_axes,
                                          gather_from_model)

    ck, cv = kv_cache["k"], kv_cache["v"]
    b, s = xq.shape[:2]
    h, kh, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    tp = mesh.shape["model"]
    hl, kv_local, me = h // tp, kh % tp == 0, axis_index("model", mesh)
    ambient = current_mesh()
    if cache_pos + s > ck.shape[1]:
        raise ValueError(f"cache of {ck.shape[1]} positions cannot take {s} more "
                         f"at position {cache_pos}")
    spec = ck.spec if isinstance(ck, Block) else P(None, None, None, None)
    if "model" in entry_axes(spec[1]):
        _write_cache(ck, cache_pos, xk)
        _write_cache(cv, cache_pos, xv)
        if ambient is None and cache_pos == 0:  # the rank's heads over the new K/V
            heads = (torch.arange(hl, device=xq.device) + me * hl) // (h // kh)
            out = _core_on_position_shares(
                xq.reshape(b, s, hl, 1, dh), xk.index_select(2, heads),
                xv.index_select(2, heads), ck, cv, causal=causal, window=window,
                q_chunk=q_chunk, cache_pos=0)
            return out.reshape(b, s, hl * dh)
        q = gather_from_model(xq, 2, mesh).reshape(b, s, kh, h // kh, dh)
        if ambient is None:
            out = _core_on_position_shares(q, xk, xv, ck, cv, causal=causal, window=window,
                                           q_chunk=q_chunk, cache_pos=cache_pos)
        else:
            out = _attn_core(q, ck, cv, causal=causal, window=window, q_chunk=q_chunk,
                             q_offset=cache_pos, kv_len=cache_pos + s, mesh=ambient)
        return out.reshape(b, s, h * dh).narrow(2, me * hl * dh, hl * dh)
    heads_split = bool(entry_axes(spec[2]))
    for c, new in ((ck, xk), (cv, xv)):
        if kv_local and not heads_split:
            new = gather_from_model(new, 2, mesh)
        if isinstance(c, Block):  # the heads are already this rank's: cut rows and positions
            Block(c.local, P(spec[0], spec[1], None, None), c.mesh).put(1, cache_pos, new)
        else:
            c[:, cache_pos:cache_pos + s] = new.to(c.dtype)
    kc, vc = (ck.local, cv.local) if isinstance(ck, Block) else (ck, cv)
    if kv_local:
        if not heads_split:
            kc, vc = (t.narrow(2, me * (kh // tp), kh // tp) for t in (kc, vc))
        q = xq.reshape(b, s, kh // tp, h // kh, dh)
    else:  # each query head reads its kv head
        heads = (torch.arange(hl, device=xq.device) + me * hl) // (h // kh)
        kc, vc = (t.index_select(2, heads) for t in (kc, vc))
        q = xq.reshape(b, s, hl, 1, dh)
    seq = entry_axes(spec[1])
    if seq:
        out = _flash_decode_partial(q, kc, vc, window, cache_pos, cache_pos + s, seq[0], mesh)
    else:
        out = _chunked_softmax_attn(q, kc, vc, causal=causal, window=window, q_chunk=q_chunk,
                                    q_offset=cache_pos, kv_len=cache_pos + s)
    return out.reshape(b, s, hl * dh)


def _attn_core(xq, xk, xv, *, causal=True, window: int = 0, q_chunk=512, q_offset: int = 0,
               kv_len: Optional[int] = None, mesh=None):
    """Dispatch: local chunked attention, or the per-rank core (batch x
    heads split over the mesh; the seq-sharded partial-softmax flash decode
    where ``_attn_specs`` picks a sequence axis).  Under a mesh whose every
    axis is 1 the local path runs.  The per-rank result is gathered, so the
    return is a plain global tensor on every rank."""
    from repro_torch.sharding.ops import P, gather, is_trivial, shard_map

    b, sq, kh, g, dh = xq.shape
    skv = xk.shape[1]
    if is_trivial(mesh):
        return _chunked_softmax_attn(xq, xk, xv, causal=causal, window=window, q_chunk=q_chunk,
                                     q_offset=q_offset, kv_len=kv_len)
    batch_axes, kv_sharded, seq_axis = _attn_specs(mesh, b, kh, g, skv, sq)
    tp = mesh.shape.get("model", 1)
    if sq > 1 and not kv_sharded:
        if tp > 1 and (kh * g) % tp == 0:
            # merged-head TP: kh doesn't divide the model axis but H = kh*g
            # does: repeat KV to one head per query head and split merged
            # heads
            xk = torch.repeat_interleave(xk, g, dim=2)
            xv = torch.repeat_interleave(xv, g, dim=2)
            out = _attn_core(xq.reshape(b, sq, kh * g, 1, dh), xk, xv, causal=causal,
                             window=window, q_chunk=q_chunk, q_offset=q_offset, kv_len=kv_len,
                             mesh=mesh)
            return out.reshape(b, sq, kh, g, dh)
        # MQA/small-GQA fallback: the local core, the same on every rank
        return _chunked_softmax_attn(xq, xk, xv, causal=causal, window=window, q_chunk=q_chunk,
                                     q_offset=q_offset, kv_len=kv_len)
    bax = batch_axes or None
    head_kh = "model" if kv_sharded else None
    head_g = "model" if (not kv_sharded and g % tp == 0 and tp > 1
                         and seq_axis != "model") else None
    q_spec = P(bax, None, head_kh, head_g, None)
    kv_spec = P(bax, seq_axis, head_kh, None)

    if seq_axis is None:
        def body(q, k, v):
            return _chunked_softmax_attn(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                                         q_offset=q_offset, kv_len=kv_len)
    else:
        def body(q, k, v):
            return _flash_decode_partial(q, k, v, window, q_offset,
                                         skv if kv_len is None else kv_len, seq_axis, mesh)

    fn = shard_map(body, mesh=mesh, in_specs=(q_spec, kv_spec, kv_spec), out_specs=q_spec)
    return gather(fn(xq, xk, xv))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(init: Init, d_model: int, d_ff: int):
    return {
        "w_gate": dense_init(init, (d_model, d_ff)),
        "w_up": dense_init(init, (d_model, d_ff)),
        "w_down": dense_init(init, (d_ff, d_model)),
    }


def mlp(params, x, act: str = "silu", d_ff: Optional[int] = None):
    """The gated MLP.  With ``d_ff`` given and the weights as ``model``
    blocks of fewer columns (``sharding.ops.use_tp``), ``w_gate``/``w_up``
    are column-parallel and ``w_down`` row-parallel, joined by one
    all-reduce over ``model``."""
    from repro_torch.sharding.ops import tp_mesh

    a = act_fn(act)
    mesh = tp_mesh()
    if mesh is not None and d_ff is not None and params["w_gate"].shape[1] != d_ff:
        gate = a(column_mm(x, params["w_gate"], mesh))
        up = column_mm(x, params["w_up"], mesh)
        return _row_parallel(gate * up, params["w_down"], mesh)
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

