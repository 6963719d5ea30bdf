"""Unified model definition for all assigned LM families.

The PyTorch counterpart of the JAX package's ``models/transformer.py`` on
one device.  One functional model covers dense / moe / ssm / hybrid / vlm /
audio:
  * blocks are stacked on a leading ``n_layers`` axis, as in the reference,
    and applied one layer at a time (``params["blocks"]["attn"]["wq"][l]``
    is a view),
  * zamba2's hybrid runs groups of ``hybrid_attn_every`` Mamba blocks, each
    followed by a shared attention+MLP block whose parameter set alternates,
  * vlm/audio prepend/replace inputs with stub frontend embeddings through a
    linear projector,
  * gemma3's local layers mask keys older than the sliding window; every
    ``global_every``-th layer attends to all keys (window 0),
  * the LM loss never materializes (B, S, V) logits: cross-entropy is
    computed in sequence chunks, each recomputed in the backward pass.

Params are plain nested dicts.  ``init_params`` draws them from a seeded
``torch.Generator`` on the device it is given; ``params_from_numpy`` takes
the JAX package's ``init_params`` output as numpy arrays, so both packages
compute the same thing from the same weights.  The caches carry their
position as a Python int; ``decode_step`` advances a cache in place.

Handed ``sharding.ops.Block``s (the sharded train step, the dry run),
the model is tensor-parallel over the mesh's ``model`` axis
(``sharding.ops.use_tp``): each layer's parameters are gathered over the
batch axes only, into this rank's ``model`` blocks (``_layer_params``),
and the layers split their work with them, as the reference's
partitioned program does: attention over query heads, the MLP over its
FFN columns, the experts, the SSM blocks over their heads, and the
embedding, head and cross-entropy over the vocabulary where it divides
``model`` (a dimension that does not divide stays whole, and every
``model`` rank computes that piece alike).  Attention whose query heads
do not divide ``model``, and an SSM whose heads or state do not, gather
their parameters whole.  Each rank gathers only its pieces of the SSM's
packed in-projection and conv: its heads' columns and its share of B's
and C's (``ssm.in_columns``, ``ssm.conv_channels``), each from the rank
whose block holds it.  ``loss_fn`` then takes this rank's rows.  So do
``forward_logits``, ``prefill`` and ``decode_step`` wherever
``rules.batch_pspec`` splits the batch over the batch axes (``pod`` x
``data``), as the reference's partitioned serving program computes each
device's rows: each batch leaf is the rank's rows (a ``DTensor`` placed
over the batch axes gives its local tensor, a plain whole tensor is cut,
with no communication), the cache a tree of ``Block``s placed by
``rules.cache_shardings`` for the whole batch of which the rank
allocates and writes its share only, and the logits come back as the
rank's rows (a ``DTensor``) for ``DTensor`` inputs, or gathered over the
batch axes for plain ones (``_rows_of``).  Where the batch axes do not
divide the batch (batch 1), every rank takes the whole batch under the
ambient mesh, as the reference does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    AttnDims,
    Init,
    attention,
    attn_params,
    dense_init,
    mlp,
    mlp_params,
    rms_norm,
)
from repro_torch.models.moe import moe_block, moe_params

# leaves that stay float32 at use; every other leaf is a matmul (or
# embedding) weight that the reference casts to bf16 where it is used
FLOAT32_LEAVES = frozenset({"ln1", "ln2", "final_norm", "norm_gamma", "a_log", "dt_bias",
                            "d_skip"})


def _attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def window_schedule(cfg: ModelConfig):
    """Per-layer sliding-window size; 0 = full attention."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.global_every:
            out.append(0 if (i + 1) % cfg.global_every == 0 else cfg.sliding_window)
        else:
            out.append(cfg.sliding_window)
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (all of one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _select(tree, idx: int):
    return tree_map(lambda a: a[idx], tree)


def _gathered(tree, *, split: bool = False, name: str = "", weights: bool = False):
    """``tree`` (a leaf named ``name``, or a dict of them) with each
    ``sharding.ops.Block`` (a rank's share of a parameter, as the sharded
    train step passes them) gathered whole, or (``split``) into this rank's
    ``model`` block; its gradient flows back to the block.  Plain tensors
    pass as they are; the ``weights`` of a model are gathered as
    ``_for_rows`` gives them."""
    from repro_torch.sharding.ops import Block

    def one(k, a):
        if isinstance(a, dict):
            return {kk: one(kk, v) for kk, v in a.items()}
        if not isinstance(a, Block):
            return a
        a = _for_rows(k, a) if weights else a
        return a.model_block() if split else a.whole()

    return one(name, tree)


def _for_rows(name: str, block):
    """A parameter's ``Block`` as it is gathered: serving on each rank's
    rows (no gradient), a matmul weight's block in the compute dtype, which
    every use casts it to (half the bytes moved and held, the same
    values); else as it is."""
    from repro_torch.sharding.ops import Block, rows_split

    if rows_split() is None or name in FLOAT32_LEAVES:
        return block
    return Block(block.local.to(COMPUTE_DTYPE), block.spec, block.mesh)


def _blocks_mesh(params):
    """The mesh of the parameters' ``Block``s, or None for plain tensors."""
    from repro_torch.sharding.ops import Block
    from repro_torch.train.tree import tree_leaves

    return next((t.mesh for t in tree_leaves(params) if isinstance(t, Block)), None)


def _ssm_dims(cfg: ModelConfig) -> dict:
    return dict(d_model=cfg.d_model, expand=cfg.ssm_expand, state=cfg.ssm_state)


def _ssm_split_params(cfg: ModelConfig, tree, n: int):
    """An SSM layer's parameters for its split over a ``model`` axis of
    ``n``: ``w_out`` as this rank's ``model`` block (row-parallel), ``w_in``
    and ``conv_w`` as the rank's pieces (``ssm.in_columns``,
    ``ssm.conv_channels``: gathered from the ranks whose blocks hold them,
    each piece's gradient sent back), every other leaf whole, its gradient
    summed over ``model`` (each rank uses its heads' part of it)."""
    from repro_torch.sharding.ops import Block

    dims = _ssm_dims(cfg)
    pieces = {"w_in": (1, tuple(ssm_mod.in_columns(r, n, **dims) for r in range(n))),
              "conv_w": (0, tuple(ssm_mod.conv_channels(r, n, **dims) for r in range(n)))}

    def one(k, a):
        if not isinstance(a, Block):
            return a
        a = _for_rows(k, a)
        if k in pieces:
            return a.model_pieces(*pieces[k])
        return a.model_block() if k == "w_out" else a.whole(sum_over_model=True)

    return {k: one(k, v) for k, v in tree.items()}


def _layer_params(cfg: ModelConfig, tree):
    """One layer's parameters gathered where they are blocks: the ``model``
    blocks of every part that splits its work over ``model``; the SSM's
    ``w_out`` block and pieces of ``w_in`` and ``conv_w`` beside its other
    leaves whole (``_ssm_split_params``); the whole tensors of attention
    whose query heads do not divide ``model``, and of an SSM whose heads or
    state do not (it runs unsplit, its parameters gathered over ``model``
    too)."""
    mesh = _blocks_mesh(tree)
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    whole = ({"attn"} if cfg.n_heads % tp else set()) | \
        ({"ssm"} if "ssm" in tree and not ssm_mod.splits_over(tp, **_ssm_dims(cfg)) else set())
    return {k: (_ssm_split_params(cfg, v, tp) if k == "ssm" and tp > 1 and k not in whole
                else _gathered(v, split=k not in whole, name=k, weights=True))
            for k, v in tree.items()}


def _layer(cfg: ModelConfig, tree, idx: int):
    """Layer ``idx`` of stacked parameters, gathered where they are
    blocks (``_layer_params``)."""
    return _layer_params(cfg, _select(tree, idx))


def gather_top(params):
    """The leaves outside the stacked blocks (embedding, head, projector,
    final norm) gathered where they are blocks, into this rank's ``model``
    blocks: once a forward pass, or once a step where the step gathers
    them first."""
    return {k: v if k in ("blocks", "shared") else _gathered(v, split=True, name=k, weights=True)
            for k, v in params.items()}


@contextlib.contextmanager
def _split_over(params, *, own_rows: bool):
    """The layers split over the ``model`` axis of the parameters' blocks
    (``use_tp``); with ``own_rows`` the inputs are this rank's rows, so
    no layer splits them again (the ambient mesh is put aside).  Without
    blocks, nothing changes."""
    from repro_torch.sharding.ops import use_mesh, use_tp

    mesh = _blocks_mesh(params)
    with use_tp(mesh), (use_mesh(None) if own_rows and mesh is not None
                        else contextlib.nullcontext()):
        yield


def _rows_of(params, b: int, cache=None):
    """(mesh, batch axes) where the model runs on each rank's rows: the
    parameters are ``Block``s and ``rules.batch_pspec`` splits ``b`` rows
    over the batch axes of their mesh (and a ``Block`` cache, if given,
    splits its rows over the same axes); else None, and the model takes the
    whole batch."""
    from repro_torch.sharding.ops import Block, entry_axes
    from repro_torch.sharding.rules import batch_pspec
    from repro_torch.train.tree import tree_leaves

    mesh = _blocks_mesh(params)
    if mesh is None:
        return None
    spec = batch_pspec(mesh, b)
    axes = entry_axes(spec[0]) if len(spec) else ()
    if not axes or any(isinstance(t, Block) and entry_axes(t.spec[1]) != axes
                       for t in tree_leaves(cache or {})):
        return None
    return mesh, axes


def _own_rows(batch: dict, mesh, axes) -> dict:
    """This rank's rows of each batch leaf: a ``DTensor`` placed over the
    batch axes gives its local tensor, a plain whole tensor is cut (a view;
    no communication)."""
    from repro_torch.sharding.ops import P, to_local

    return {k: to_local(v, mesh, P(axes)) for k, v in batch.items()}


def _whole(batch: dict) -> dict:
    """Each batch leaf whole: a ``DTensor`` gathered (a replicated one with
    no communication), a plain tensor as it is."""
    from repro_torch.sharding.ops import gather

    return {k: gather(v) for k, v in batch.items()}


def _rows_out(logits, mesh, axes, batch: dict):
    """The rank's rows of the logits as the caller reads them: a ``DTensor``
    over the batch axes where the inputs were ``DTensor``s, else gathered
    over the batch axes (the one collective on those axes)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.ops import P, from_local, gather_rows

    if any(isinstance(v, DTensor) for v in batch.values()):
        return from_local(logits.contiguous(), mesh, P(axes))
    return gather_rows(logits, mesh, axes)


def _rows_view(cache, mesh, axes):
    """The cache as the layers see it on this rank's rows (sharing its
    memory, so their writes land in it): a ``Block`` with its rows taken as
    whole (its local rows are this rank's), or its local tensor where
    nothing else of it is split; a plain whole tensor cut to this rank's
    rows (no communication)."""
    from repro_torch.sharding.ops import Block, P, entry_axes, local_block

    def one(t):
        if isinstance(t, Block):
            spec = P(*(None if d == 1 else e for d, e in enumerate(t.spec)))
            return Block(t.local, spec, t.mesh) if any(map(entry_axes, spec)) else t.local
        return local_block(t, mesh, P(None, axes)) if torch.is_tensor(t) else t

    return tree_map(one, cache)


def _block_cache(cfg: ModelConfig, b: int, max_seq: int, mesh, device):
    """Zeroed caches for ``b`` rows (the whole batch) as ``Block``s placed
    by ``rules.cache_shardings``: this rank allocates its share only."""
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import Block, local_shape

    layout = cache_layout(cfg, b, max_seq)
    pos = layout.pop("pos")
    zeros = lambda leaf, s: Block(torch.zeros(local_shape(leaf.shape, mesh, s.spec),
                                              dtype=leaf.dtype, device=device), s.spec, mesh)
    return {**tree_map(zeros, layout, rules.cache_shardings(mesh, layout)), "pos": pos}


@contextlib.contextmanager
def _on_rows(params, mesh, axes):
    """The layers split over ``model`` on this rank's rows (``_split_over``
    with ``own_rows``), the rows' split set for the layers that read it
    (``sharding.ops.use_rows``)."""
    from repro_torch.sharding.ops import use_rows

    with _split_over(params, own_rows=True), use_rows(mesh, axes):
        yield


def _unbind(tree, n: int) -> list:
    """The ``n`` sets stacked on the leading axis of ``tree``'s leaves, as a
    list of trees of views.  In the backward pass one unbind stacks every
    set's gradient once; indexing a set at a time would build a zero-filled
    gradient of the whole stack for each set."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(cfg: ModelConfig, init: Init):
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {
            "ln1": init.zeros((d,)),
            "ssm": ssm_mod.ssm_params(init, d, cfg.ssm_expand, cfg.ssm_state),
        }
    block = {
        "ln1": init.zeros((d,)),
        "ln2": init.zeros((d,)),
        "attn": attn_params(init, d, _attn_dims(cfg)),
    }
    if cfg.family == "moe":
        block["moe"] = moe_params(init, d, cfg.n_experts, cfg.d_ff)
    else:
        block["mlp"] = mlp_params(init, d, cfg.d_ff)
    return block


def _shared_block_init(cfg: ModelConfig, init: Init):
    d = cfg.d_model
    return {
        "ln1": init.zeros((d,)),
        "ln2": init.zeros((d,)),
        "attn": attn_params(init, d, _attn_dims(cfg)),
        "mlp": mlp_params(init, d, cfg.d_ff),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """float32 parameters drawn on ``device`` (``cuda`` unless the caller
    passes another; ``meta`` gives the shapes only) from a
    ``torch.Generator`` seeded with ``seed``.  Blocks are stacked on a
    leading ``n_layers`` axis, the zamba2 shared sets on a
    ``hybrid_shared_sets`` axis, as in the reference."""
    from repro_torch.device import resolve_device

    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    init = Init(gen, dev)
    params = {}
    if cfg.family != "audio":
        params["embed"] = dense_init(init, (cfg.vocab_size, cfg.d_model), in_axis=1)
    if cfg.frontend != "none":
        params["frontend_proj"] = dense_init(init, (cfg.frontend_dim, cfg.d_model))
    params["blocks"] = _block_init(cfg, init.stacked(cfg.n_layers))
    if cfg.hybrid_attn_every:
        params["shared"] = _shared_block_init(cfg, init.stacked(cfg.hybrid_shared_sets))
    params["final_norm"] = init.zeros((cfg.d_model,))
    if not cfg.tie_embeddings or cfg.family == "audio":
        params["head"] = dense_init(init, (cfg.d_model, cfg.vocab_size))
    return params


def param_shapes(cfg: ModelConfig):
    """The parameters' shapes and dtypes as ``meta`` tensors (no memory),
    for the sharding rules and the cost models."""
    return init_params(cfg, device="meta")


def params_from_numpy(cfg: ModelConfig, tree, *, device=None):
    """The JAX package's ``init_params(cfg, key)`` output, as numpy arrays
    (blocks stacked on a leading ``n_layers`` axis), as this package's
    float32 parameters on ``device``.  Raises if a leaf is missing, extra or
    of another shape than ``init_params`` gives here."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    want = param_shapes(cfg)

    def convert(w, path, node):
        if isinstance(w, dict):
            if not isinstance(node, dict) or set(node) != set(w):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"params{path}: keys {got}, expected {sorted(w)}")
            return {k: convert(w[k], f"{path}[{k!r}]", node[k]) for k in w}
        a = np.asarray(node)
        if tuple(a.shape) != tuple(w.shape):
            raise ValueError(f"params{path}: shape {a.shape}, expected {tuple(w.shape)}")
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return convert(want, "", tree)


def cast_matmul_weights(params, dtype=COMPUTE_DTYPE):
    """Every matmul and embedding weight cast to ``dtype`` once; norm gammas
    and the SSM's ``a_log``, ``dt_bias`` and ``d_skip`` stay float32.  The
    reference casts the same weights at each use, so the bits are equal."""
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v if k in FLOAT32_LEAVES else v.to(dtype))
                for k, v in tree.items()}

    return walk(params)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_attn_block(cfg, bp, x, positions, window, kv_cache=None, cache_pos=None,
                      causal=True, q_chunk=512):
    h, new_cache = attention(
        bp["attn"],
        rms_norm(x, bp["ln1"], cfg.norm_eps),
        _attn_dims(cfg),
        positions=positions,
        causal=causal,
        window=window,
        rope_theta=cfg.rope_theta,
        q_chunk=q_chunk,
        kv_cache=kv_cache,
        cache_pos=cache_pos,
    )
    # the second norm reads the residual sum in float32: the reference's
    # compiled program folds the bf16 rounding of ``x + h`` into the norm's
    # float32 cast (XLA's excess precision); the residual stream itself
    # stays bf16
    normed = rms_norm(x.float() + h.float(), bp["ln2"], cfg.norm_eps).to(x.dtype)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "moe":
        m, aux = moe_block(
            bp["moe"],
            normed,
            n_experts=cfg.n_experts,
            k=cfg.experts_per_token,
            act=cfg.act,
            capacity_factor=cfg.moe_capacity_factor,
        )
    else:
        m = mlp(bp["mlp"], normed, cfg.act, d_ff=cfg.d_ff)
    return x + m, new_cache, aux


def _apply_ssm_block(cfg, bp, x):
    h = ssm_mod.ssd_forward(
        bp["ssm"],
        rms_norm(x, bp["ln1"], cfg.norm_eps),
        d_model=cfg.d_model,
        expand=cfg.ssm_expand,
        state=cfg.ssm_state,
        chunk=cfg.ssm_chunk,
    )
    return x + h


def _hybrid_groups(cfg):
    """zamba2's layout: ``n_groups`` groups of ``every`` Mamba blocks, each
    followed by shared set ``g % hybrid_shared_sets``."""
    every = cfg.hybrid_attn_every
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is no multiple of "
                         f"hybrid_attn_every {every}")
    return cfg.n_layers // every, every


def _positions(b: int, s: int, device, start: int = 0):
    return (start + torch.arange(s, device=device)).expand(b, s)


# ---------------------------------------------------------------------------
# forward (encoder / prefill-logits)
# ---------------------------------------------------------------------------

def _embed_rows(cfg: ModelConfig, embed, tokens):
    """The float32 embedding rows of ``tokens``.  With the table as this
    rank's ``model`` block of vocabulary rows, each rank reads the tokens in
    its range, zeros elsewhere, and the rows are summed over ``model``
    (exact: one rank holds each row)."""
    from repro_torch.sharding.ops import axis_index, reduce_from_model, tp_mesh

    tokens = tokens.long()
    mesh = tp_mesh()
    if mesh is None or embed.shape[0] == cfg.vocab_size:
        return embed[tokens]
    n = embed.shape[0]
    local = tokens - axis_index("model", mesh) * n
    inside = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0), mesh)


def _project(cfg: ModelConfig, inputs, w):
    """A frontend's stub embeddings through the projector; with the
    projector as this rank's ``model`` block of output columns, the
    columns are gathered over ``model``."""
    from repro_torch.sharding.ops import gather_from_model, tp_mesh

    out = inputs.to(COMPUTE_DTYPE) @ w.to(COMPUTE_DTYPE)
    mesh = tp_mesh()
    if mesh is None or w.shape[1] == cfg.d_model:
        return out
    return gather_from_model(out, out.dim() - 1, mesh)


def embed_inputs(cfg: ModelConfig, params, batch):
    """Token/frontend embedding.  Returns (x (B,S,D), label_offset)."""
    if cfg.family == "audio":
        return _project(cfg, batch["frames"], params["frontend_proj"]), 0
    tok = _embed_rows(cfg, params["embed"], batch["tokens"]).to(COMPUTE_DTYPE)
    if cfg.family == "vlm":
        patches = _project(cfg, batch["patches"], params["frontend_proj"])
        return torch.cat([patches, tok], dim=1), cfg.vision_patches
    return tok, 0


def _checkpointed(fn, remat: bool):
    """``fn``, or ``fn`` whose activations are recomputed in the backward
    pass (``jax.checkpoint``'s counterpart) when ``remat``.  The recompute
    runs under the ambient mesh and ``use_tp`` mesh of the forward call
    (the backward pass runs after the caller's contexts are gone), so its
    collectives over ``model`` run again: each tensor-parallel layer's
    all-reduces, once in the forward pass and once more in the backward.
    The recompute stops early, at the last tensor the block saved
    (``set_checkpoint_early_stop``, asked for here rather than taken as
    torch's default): a built-in matmul saves its operands before it
    runs, so the block's last matmul is never recomputed, and a
    row-parallel one (``layers._row_parallel``) saves them in ``_RowMM``,
    ahead of the product, so that it is not either.  Without the early
    stop each block would recompute its last matmul and, with a split,
    its row-parallel product and all-reduce."""
    from repro_torch.sharding import ops

    if not remat:
        return fn

    def run(*args):
        mesh, tp = ops.current_mesh(), ops.tp_mesh()

        def body(*a):
            with ops.use_mesh(mesh), ops.use_tp(tp):
                return fn(*a)

        with torch.utils.checkpoint.set_checkpoint_early_stop(True):
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)

    return run


def backbone(cfg: ModelConfig, params, x, *, remat: bool = True):
    """Run all blocks (no cache).  x: (B,S,D) -> (B,S,D), aux_loss.

    With ``remat`` (training) each block keeps only its input for the
    backward pass and recomputes the rest, as the reference's
    ``jax.checkpoint`` per scanned block does.  The reference also fences
    the scan carry with an XLA scheduling barrier (``_fence``, identity
    derivative) so its compiler cannot hoist casts out of the loop; eager
    PyTorch runs the blocks in order, so nothing stands in for it here.
    """
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    causal = not cfg.encoder_only
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    # each block's parameters are gathered inside its (recomputed) body,
    # where the caller passes them as blocks (the sharded train step)
    if cfg.family in ("ssm", "hybrid"):
        ssm_block = _checkpointed(lambda bp, x: _apply_ssm_block(cfg, _layer_params(cfg, bp), x),
                                  remat)

    blocks = _unbind(params["blocks"], cfg.n_layers)
    if cfg.family == "ssm":
        for bp in blocks:
            x = ssm_block(bp, x)
        return x, zero

    if cfg.family == "hybrid":
        n_groups, every = _hybrid_groups(cfg)
        shared_block = _checkpointed(
            lambda sp, x: _apply_attn_block(cfg, _layer_params(cfg, sp), x, positions, 0)[0],
            remat)
        shared = _unbind(params["shared"], cfg.hybrid_shared_sets)
        for g in range(n_groups):
            for j in range(every):
                x = ssm_block(blocks[g * every + j], x)
            x = shared_block(shared[g % cfg.hybrid_shared_sets], x)
        return x, zero

    # dense / moe / vlm / audio: one block per layer with its window
    def block(bp, x, w):
        h, _, aux = _apply_attn_block(cfg, _layer_params(cfg, bp), x, positions, w,
                                      causal=causal)
        return h, aux

    block = _checkpointed(block, remat)
    auxs = []
    for l, w in enumerate(window_schedule(cfg)):
        x, aux = block(blocks[l], x, w)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def head_weights(cfg: ModelConfig, params):
    if "head" in params:
        return params["head"]
    return params["embed"].T


def _logits(cfg: ModelConfig, params, x):
    """float32 logits of ``x``; with the head as this rank's ``model``
    block of vocabulary columns, the columns are gathered over ``model``."""
    from repro_torch.models.layers import column_mm
    from repro_torch.sharding.ops import gather_from_model, tp_mesh

    w = head_weights(cfg, params)
    mesh = tp_mesh()
    if mesh is None or w.shape[1] == cfg.vocab_size:
        return (x @ w.to(x.dtype)).float()
    part = column_mm(x, w, mesh).float()
    return gather_from_model(part, x.dim() - 1, mesh)


def _split_vocab_ce(xi, li, w, mesh):
    """Each position's (log Z - gold logit) with the head as this rank's
    ``model`` block of vocabulary columns: the distributed log-softmax the
    reference's partitioner derives from ``constrain(logits, "batch",
    None, "tp")``.  The max over ``model`` (held fixed), the sum of the
    exponentials over ``model``, and the label's logit from the rank that
    holds its column."""
    from repro_torch.models.layers import column_mm
    from repro_torch.sharding.ops import axis_index, max_over_model, reduce_from_model

    logits = column_mm(xi, w, mesh).float()
    n = logits.shape[-1]
    m = max_over_model(logits.detach().amax(dim=-1), mesh)
    logz = m + torch.log(reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1), mesh))
    local = li - axis_index("model", mesh) * n
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return logz - reduce_from_model(torch.where((local >= 0) & (local < n), picked, 0.0), mesh)


def chunked_cross_entropy(cfg, params, x, labels, *, chunk: int = 512, label_offset: int = 0):
    """Mean CE over positions without materializing (B, S, V) logits: the
    sequence is cut into chunks (padded with label -1, which counts for
    nothing), and each chunk's logits are recomputed in the backward pass.
    With the head as a ``model`` block of vocabulary columns, each rank
    computes its columns' logits (``_split_vocab_ce``)."""
    from repro_torch.sharding.ops import tp_mesh

    if label_offset:
        x = x[:, label_offset:]
    b, s, d = x.shape
    w = head_weights(cfg, params).to(COMPUTE_DTYPE)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    labels = labels.long()
    mesh = tp_mesh()
    split = mesh is not None and w.shape[1] != cfg.vocab_size

    def one(xi, li, w):
        if split:
            nll = _split_vocab_ce(xi, li, w, mesh)
        else:
            logits = (xi @ w).float()
            logz = torch.logsumexp(logits, dim=-1)
            nll = logz - torch.gather(logits, -1, torch.clamp(li, min=0)[..., None])[..., 0]
        valid = li >= 0
        return torch.where(valid, nll, 0.0).sum(), valid.sum(dtype=torch.int32)

    one = _checkpointed(one, True)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    for start in range(0, x.shape[1], chunk):
        loss, valid = one(x[:, start:start + chunk], labels[:, start:start + chunk], w)
        tot, cnt = tot + loss, cnt + valid
    return tot / torch.clamp(cnt, min=1)


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01):
    """(CE + ``aux_weight`` x the MoE load-balancing loss, {"ce", "aux"}) of
    a batch of tensors: ``tokens`` (or ``frames``; ``patches`` for the vlm)
    and ``labels`` (-1 where a position has no target).  With the
    parameters as ``Block``s (the sharded train step) the batch is this
    rank's rows, the model split over ``model``, and the loss the mean over
    these rows."""
    with _split_over(params, own_rows=True):
        params = gather_top(params)
        x, label_offset = embed_inputs(cfg, params, batch)
        x, aux = backbone(cfg, params, x)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        ce = chunked_cross_entropy(cfg, params, x, batch["labels"], label_offset=label_offset)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def forward_logits(cfg: ModelConfig, params, batch):
    """Full logits (B, S, V) float32 (smoke tests / small models only).
    With the parameters as ``Block``s and a batch that splits over the
    batch axes, each rank computes its rows (``_rows_of``): ``DTensor``
    inputs give the rank's rows as a ``DTensor``, plain ones every row."""
    rows = _rows_of(params, next(iter(batch.values())).shape[0])
    if rows is None:
        with _split_over(params, own_rows=False):
            return _forward_logits(cfg, gather_top(params), _whole(batch))
    with _on_rows(params, *rows):
        logits = _forward_logits(cfg, gather_top(params), _own_rows(batch, *rows))
    return _rows_out(logits, *rows, batch)


def _forward_logits(cfg: ModelConfig, params, batch):
    x, _ = embed_inputs(cfg, params, batch)
    x, _ = backbone(cfg, params, x, remat=False)
    return _logits(cfg, params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def _last_logits(cfg, params, x):
    return _logits(cfg, params, rms_norm(x, params["final_norm"], cfg.norm_eps)[:, -1])


# ---------------------------------------------------------------------------
# serving: prefill + decode with caches
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheLeaf:
    """One serving-cache leaf's global shape and dtype (no memory)."""
    shape: tuple
    dtype: torch.dtype


def cache_layout(cfg: ModelConfig, batch: int, max_seq: int, dtype=None):
    """The serving caches' tree with each leaf a ``CacheLeaf``: K/V (layers
    or groups, B, max_seq, K, Dh) in ``dtype`` (the activations' unless
    given); the SSM's conv history (L, B, K - 1, conv channels) in ``dtype``
    and state (L, B, H, N, P) in float32; ``pos`` 0."""
    dtype = dtype or COMPUTE_DTYPE
    dims = _attn_dims(cfg)
    kv = lambda n: CacheLeaf((n, batch, max_seq, dims.n_kv_heads, dims.head_dim), dtype)
    cache = {"pos": 0}
    if cfg.family in ("ssm", "hybrid"):
        per = ssm_mod.ssm_cache_layout(batch, cfg.d_model, cfg.ssm_expand, cfg.ssm_state, dtype)
        cache["ssm"] = {k: CacheLeaf((cfg.n_layers,) + shape, dt)
                        for k, (shape, dt) in per.items()}
        if cfg.family == "hybrid":
            cache["k"] = cache["v"] = kv(_hybrid_groups(cfg)[0])
        return cache
    cache["k"] = cache["v"] = kv(cfg.n_layers)
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None):
    """Zeroed caches of ``cache_layout`` on ``device``."""
    return tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
                    if isinstance(leaf, CacheLeaf) else leaf,
                    cache_layout(cfg, batch, max_seq, dtype))


def _ssm_split_mesh(cfg: ModelConfig, bp):
    """The ``use_tp`` mesh where the SSM layer's parameters ``bp`` are
    split over its ``model`` axis (``w_out`` a ``model`` block), else
    None."""
    from repro_torch.sharding.ops import tp_mesh

    mesh = tp_mesh()
    d_inner = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_state)[0]
    return mesh if mesh is not None and bp["ssm"]["w_out"].shape[0] != d_inner else None


def _heads_block(state, mesh):
    """A ``Block`` state cache (L, B, H, N, P) whose heads split over
    ``model``, seen with its heads as this rank's whole: its layers take
    and give the rank's heads of every row, cut to the rank's rows."""
    from repro_torch.sharding.ops import Block, P, entry_axes

    if not isinstance(state, Block) or "model" not in entry_axes(state.spec[2]):
        return None
    return Block(state.local, P(*(None if d == 2 else e for d, e in enumerate(state.spec))),
                 state.mesh)


def _ssm_state_heads(cfg, cache, l: int, mesh):
    """Layer ``l``'s SSM state of this rank's heads (B, h / tp, N, P): a
    ``Block`` cache split by heads gathers its rows only, a plain one (or
    one that holds every head) is cut."""
    from repro_torch.sharding.ops import Block, axis_index

    state = cache["ssm"]["ssm"]
    if _heads_block(state, mesh) is not None:
        return state[l].model_block()
    whole = state[l].whole() if isinstance(state, Block) else state[l]
    hl = ssm_mod.ssm_dims(**_ssm_dims(cfg))[1] // mesh.shape["model"]
    return whole.narrow(1, axis_index("model", mesh) * hl, hl)


def _put_ssm_layer(cache, l: int, new: dict, mesh) -> None:
    """Write layer ``l``'s new conv history (whole) and state.  Under a
    split (``mesh``) the state is this rank's heads': into a ``Block`` cache
    split by heads as it is (cut to its rows), into any other the heads
    gathered over ``model``."""
    from repro_torch.sharding.ops import gather_from_model

    cache["ssm"]["conv"][l] = new["conv"]
    state = cache["ssm"]["ssm"]
    heads = _heads_block(state, mesh) if mesh is not None else None
    if heads is not None:
        heads[l] = new["ssm"]
    else:
        state[l] = new["ssm"] if mesh is None else gather_from_model(new["ssm"], 1, mesh)


def _ssm_decode_layer(cfg, bp, x, cache, l: int):
    mesh = _ssm_split_mesh(cfg, bp)
    if mesh is None:
        layer_cache = _gathered(_select(cache["ssm"], l))
    else:  # the history whole (tiny), the state of this rank's heads
        layer_cache = {"conv": _gathered(cache["ssm"]["conv"][l]),
                       "ssm": _ssm_state_heads(cfg, cache, l, mesh)}
    h, new_c = ssm_mod.ssd_decode_step(
        bp["ssm"],
        rms_norm(x, bp["ln1"], cfg.norm_eps),
        layer_cache,
        d_model=cfg.d_model,
        expand=cfg.ssm_expand,
        state=cfg.ssm_state,
    )
    _put_ssm_layer(cache, l, new_c, mesh)
    return x + h


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens: (B, 1) -> last-token logits (B, V) float32;
    ``cache`` advances in place (and is returned, as the reference returns
    its new cache).  On each rank's rows (``_rows_of``) the rank reads and
    writes its rows of the cache: of a ``Block`` cache (``prefill``'s) its
    share, of a whole plain one its rows (no communication); the logits
    come back as in ``forward_logits``."""
    rows = _rows_of(params, tokens.shape[0], cache)
    if rows is None:
        with _split_over(params, own_rows=False):
            return _decode_step(cfg, gather_top(params), cache, _whole({"t": tokens})["t"])
    with _on_rows(params, *rows):
        view = _rows_view(cache, *rows)
        logits, view = _decode_step(cfg, gather_top(params), view,
                                    _own_rows({"tokens": tokens}, *rows)["tokens"])
    cache["pos"] = view["pos"]
    return _rows_out(logits, *rows, {"tokens": tokens}), cache


def _decode_step(cfg: ModelConfig, params, cache, tokens):
    pos = cache["pos"]
    b = tokens.shape[0]
    x = _embed_rows(cfg, params["embed"], tokens).to(COMPUTE_DTYPE)
    positions = _positions(b, 1, x.device, start=pos)

    if cfg.family == "ssm":
        for l in range(cfg.n_layers):
            x = _ssm_decode_layer(cfg, _layer(cfg, params["blocks"], l), x, cache, l)
    elif cfg.family == "hybrid":
        n_groups, every = _hybrid_groups(cfg)
        for g in range(n_groups):
            for j in range(every):
                l = g * every + j
                x = _ssm_decode_layer(cfg, _layer(cfg, params["blocks"], l), x, cache, l)
            sp = _layer(cfg, params["shared"], g % cfg.hybrid_shared_sets)
            x, _, _ = _apply_attn_block(cfg, sp, x, positions, 0,
                                        kv_cache={"k": cache["k"][g], "v": cache["v"][g]},
                                        cache_pos=pos)
    else:
        for l, w in enumerate(window_schedule(cfg)):
            x, _, _ = _apply_attn_block(cfg, _layer(cfg, params["blocks"], l), x, positions, w,
                                        kv_cache={"k": cache["k"][l], "v": cache["v"][l]},
                                        cache_pos=pos)
    cache["pos"] = pos + 1
    return _last_logits(cfg, params, x), cache


def _ssm_block_prefill(cfg, bp, x):
    h, state = ssm_mod.ssd_forward(
        bp["ssm"],
        rms_norm(x, bp["ln1"], cfg.norm_eps),
        d_model=cfg.d_model,
        expand=cfg.ssm_expand,
        state=cfg.ssm_state,
        chunk=cfg.ssm_chunk,
        return_final_state=True,
    )
    return x + h, state


def prefill(cfg: ModelConfig, params, batch, max_seq: Optional[int] = None):
    """Prefill: forward over the prompt, return (last-token logits, cache).

    Attention families: each layer's K/V are written into a cache of
    ``max_seq`` positions as the forward pass computes them.  SSM/hybrid:
    the chunked SSD returns the final (conv, state) pair per layer, handing
    off exactly to ``ssd_decode_step``.

    On each rank's rows (``_rows_of``) the cache is a tree of ``Block``s
    placed by ``rules.cache_shardings`` for the whole batch, of which this
    rank holds and writes its share only; the logits come back as in
    ``forward_logits``.
    """
    rows = _rows_of(params, next(iter(batch.values())).shape[0])
    if rows is None:
        with _split_over(params, own_rows=False):
            return _prefill(cfg, gather_top(params), _whole(batch), max_seq)
    with _on_rows(params, *rows):
        logits, cache = _prefill(cfg, gather_top(params), _own_rows(batch, *rows), max_seq, rows)
    return _rows_out(logits, *rows, batch), cache


def _prefill(cfg: ModelConfig, params, batch, max_seq, rows=None):
    x, _ = embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    max_seq = max_seq or s
    if rows is None:
        out = cache = init_cache(cfg, b, max_seq, device=x.device)
    else:  # the whole batch's cache as blocks; the layers write this rank's rows
        mesh, axes = rows
        out = _block_cache(cfg, b * math.prod(mesh.shape[a] for a in axes), max_seq, mesh,
                           x.device)
        cache = _rows_view(out, mesh, axes)

    def ssm_layer(l, x):
        bp = _layer(cfg, params["blocks"], l)
        x, state = _ssm_block_prefill(cfg, bp, x)
        _put_ssm_layer(cache, l, state, _ssm_split_mesh(cfg, bp))
        return x

    if cfg.family == "ssm":
        for l in range(cfg.n_layers):
            x = ssm_layer(l, x)
    elif cfg.family == "hybrid":
        n_groups, every = _hybrid_groups(cfg)
        for g in range(n_groups):
            for j in range(every):
                x = ssm_layer(g * every + j, x)
            sp = _layer(cfg, params["shared"], g % cfg.hybrid_shared_sets)
            x, _, _ = _apply_attn_block(cfg, sp, x, positions, 0,
                                        kv_cache={"k": cache["k"][g], "v": cache["v"][g]},
                                        cache_pos=0)
    else:
        for l, w in enumerate(window_schedule(cfg)):
            x, _, _ = _apply_attn_block(cfg, _layer(cfg, params["blocks"], l), x, positions, w,
                                        kv_cache={"k": cache["k"][l], "v": cache["v"][l]},
                                        cache_pos=0, causal=not cfg.encoder_only)
    out["pos"] = s
    return _last_logits(cfg, params, x), out
