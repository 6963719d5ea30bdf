"""K5, the QuickScorer scorer, beside its plain version.

  * K5 ``tree_bitvector``: the CUDA kernel ``bitvector_tile<staged>`` in
    ``repro_torch/csrc/bitvector.cu``.  It replaces the JAX package's
    ``kernels/bitvector.py::_bitvector_partials``, which is jnp, not Pallas:
    XLA scores every entry slot of every tree over a (B, T, W32) cleared-bit
    tensor.

The function, per (row, tree): the masks of the false nodes (entries with
``key[entry_feat] > entry_key``) are ORed as cleared-bit sets, ANDed with NOT
into ``init_mask``, and the lowest surviving bit is the tree's exit leaf,
whose ``leaf_fixed`` row adds into the row's (C,) uint32 partials (mod 2^32).
Entries are visited in any order (OR commutes), which is why the tree-major
slot grid of :func:`bitvector_device_arrays` serves as well as the layout's
feature-sorted stream.

Bitvectors are uint32 words (``W32 = 2 * words``): ``mask.view(np.uint32)``
of the layout's little-endian uint64 words lists them low to high, so word
``b // 32`` holds leaf bit ``b``.  Where no bit survives (never, on a layout
built from a real tree) both versions take leaf 32 of word 0, which is what
``_bitvector_partials`` computes there (``argmax`` of no nonzero word is 0,
``popcount(0 - 1)`` is 32), and clamp the leaf row into the table.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches K5 or raises.  It counts its launches in
``tree_traverse.LAUNCHES["bitvector"]`` and records its CTA shape in
``tree_traverse.LAUNCH_SHAPES["bitvector"]``, under the walks' lock.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import tree_traverse as tt

#: int32 max: ``key > this`` never holds, so a padding slot applies nothing
_NEVER_KEY = np.int32(0x7FFFFFFF)
_U32_MASK = 0xFFFFFFFF
#: the plain version's (rows, T, W32) int32 cleared-bit tensor per chunk of
#: rows: 64 MiB, 4,096 rows of the full-width model
_PLAIN_CHUNK_BYTES = 64 << 20
#: the words of the cleared-bit set K5 keeps in registers; a wider
#: bitvector is scored in chunks of that many words, lowest first
CHUNK_WORDS = 32


def bitvector_device_arrays(bv, device=None) -> dict:
    """The tree-major slot grid that both versions read, as tensors on
    ``device`` (``cuda`` unless ``device="cpu"``): the same arrays as the
    JAX package's ``bitvector_device_arrays``.

    ``entry_feat``/``entry_key`` (T, M) int32 and ``inv_mask`` (T, M, W32)
    uint32, the bits each false node clears, with M the most entries of one
    tree; a tree's entries keep the layout's stream order, and its padding
    slots hold ``_NEVER_KEY`` and an empty clear set.  ``init_mask``
    (T, W32) uint32, ``leaf_off`` (T,) int32 and ``leaf_fixed`` (L, C)
    uint32 the leaves in the layout's in-order sequence.  ``n_entry_slots``
    is M.
    """
    T, F = bv.n_trees, bv.n_features
    W32 = 2 * bv.words
    E = bv.total_entries
    feat_of_entry = np.repeat(
        np.arange(F, dtype=np.int32), np.diff(bv.feat_offsets).astype(np.int64))
    counts = np.bincount(bv.thr_tree, minlength=T) if E else np.zeros(T, np.int64)
    M = int(counts.max()) if E else 0
    entry_feat = np.zeros((T, M), np.int32)
    entry_key = np.full((T, M), _NEVER_KEY, np.int32)
    inv_mask = np.zeros((T, M, W32), np.uint32)
    if E:
        # slot of entry e: how many entries of its tree come before it in
        # the stream (a stable sort by tree keeps the stream order)
        order = np.argsort(bv.thr_tree, kind="stable")
        starts = np.cumsum(counts) - counts
        tree = bv.thr_tree[order]
        slot = np.arange(E) - starts[tree]
        entry_feat[tree, slot] = feat_of_entry[order]
        entry_key[tree, slot] = bv.thr_key[order]
        inv_mask[tree, slot] = (~bv.thr_mask).view(np.uint32).reshape(E, W32)[order]
    dev = resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(
        entry_feat=as_t(entry_feat),
        entry_key=as_t(entry_key),
        inv_mask=as_t(inv_mask),
        init_mask=as_t(bv.init_mask.view(np.uint32).reshape(T, W32)),
        leaf_off=as_t(bv.leaf_offsets[:-1].astype(np.int32)),
        leaf_fixed=as_t(bv.leaf_fixed),
        n_entry_slots=M,
    )


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a value in [0, 2^32)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _U32_MASK) >> 24


def _exit_leaves(live: torch.Tensor) -> torch.Tensor:
    """(..., W32) int32 live-leaf words -> (...) int64 lowest set bit: the
    first nonzero word (word 0 when none is), then its lowest bit as
    ``popcount(lsb - 1)``."""
    w_idx = (live != 0).to(torch.int32).argmax(-1)
    word = live.gather(-1, w_idx[..., None])[..., 0].to(torch.int64) & _U32_MASK
    lsb = word & (-word & _U32_MASK)
    return w_idx.to(torch.int64) * 32 + _popcount32((lsb - 1) & _U32_MASK)


def bitvector_plain(x_keys, entry_feat, entry_key, inv_mask, init_mask,
                    leaf_off, leaf_fixed, *, chunk_rows=None) -> torch.Tensor:
    """K5's function in plain PyTorch, the twin of ``_bitvector_partials``:
    (B, F) int32 keys -> (B, C) uint32 partials.

    One step per entry slot ORs the slot's clear set into every (row, tree)
    whose compare is false, as the jnp form does; the (rows, T, W32)
    cleared-bit tensor is built for ``chunk_rows`` rows at a time (by
    default as many as fit in 64 MiB), so 65,536 rows of the full-width
    model fit on the card.  The leaves add in int64 masked to 32 bits,
    because torch's uint32 has no add.
    """
    b = x_keys.shape[0]
    t, m = entry_feat.shape
    w32 = init_mask.shape[-1]
    inv = inv_mask.view(torch.int32)
    init = init_mask.view(torch.int32)
    leaf = leaf_fixed.view(torch.int32).to(torch.int64) & _U32_MASK
    feat = entry_feat.long()
    off = leaf_off.long()
    step = chunk_rows or max(1, _PLAIN_CHUNK_BYTES // max(1, t * w32 * 4))
    out = torch.empty((b, leaf.shape[-1]), dtype=torch.int32, device=x_keys.device)
    for r0 in range(0, b, step):
        x = x_keys[r0:r0 + step]
        cleared = torch.zeros((x.shape[0], t, w32), dtype=torch.int32, device=x.device)
        for j in range(m):
            applied = x[:, feat[:, j]] > entry_key[:, j]          # (rows, T)
            cleared |= torch.where(applied[:, :, None], inv[:, j, :], 0)
        rows = (off + _exit_leaves(init & ~cleared)).clamp(0, leaf.shape[0] - 1)
        out[r0:r0 + step] = (leaf[rows].sum(1) & _U32_MASK).to(torch.int32)
    return out.view(torch.uint32)


# ---------------------------------------------------------------------------
# CTA shape and the kernel wrapper
# ---------------------------------------------------------------------------

def pick_blocks(b: int, t: int, n_features: int, sm_count: int = None):
    """(rows per CTA, trees per CTA) for K5: the walks' rows per CTA
    (``ops.ROWS_PER_CTA``, or the most whose staged tile fits) and tree
    chunks for about as many waves of resident CTAs as the staged walks aim
    at, down to one tree per CTA.  Each (row, tree) scores every entry slot
    of its tree, so a CTA of one tree is already much work; unlike the
    walks' rule there is no floor of a group of walks."""
    from repro_torch.kernels import ops

    sm_count = sm_count or ops._H100_SMS
    staged = tt.stages_x(n_features)
    rows = ops.ROWS_PER_CTA
    while staged and tt.tile_bytes(rows, n_features) > tt.SMEM_PER_CTA:
        rows -= 32
    row_blocks = max(1, -(-b // rows))
    resident = ops.resident_ctas(rows, n_features if staged else None)
    chunks = min(t, max(1, -(-ops._STAGED_WAVES * sm_count * resident // row_blocks)))
    return rows, -(-t // chunks)


def _check(x_keys, tables: dict):
    """Check what K5 takes; return the tensors to pass, uint32 as int32."""
    dev = x_keys.device
    if dev.type != "cuda":
        raise ValueError(f"K5 takes CUDA tensors, got {dev}")
    b, f = x_keys.shape
    t, m = tables["entry_feat"].shape
    w32 = tables["init_mask"].shape[-1]
    n_leaves, c = tables["leaf_fixed"].shape
    shapes = {"x_keys": (b, f), "entry_feat": (t, m), "entry_key": (t, m),
              "inv_mask": (t, m, w32), "init_mask": (t, w32), "leaf_off": (t,),
              "leaf_fixed": (n_leaves, c)}
    out = {}
    for name, a in (("x_keys", x_keys), *tables.items()):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, x_keys on {dev}")
        if a.dtype in (torch.uint32, torch.int32):
            a = a.view(torch.int32)
        if a.dtype != torch.int32 or tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name} must be 32-bit of shape {shapes[name]}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        out[name] = a
    if w32 < 2 or w32 % 2:
        raise ValueError(f"bitvectors are uint64 words, so W32 must be even, got {w32}")
    if out["inv_mask"].numel() and out["inv_mask"].data_ptr() % 8:
        raise ValueError("inv_mask must be 8-byte aligned")
    if f < 1 or n_leaves < 1:
        raise ValueError("K5 needs rows with at least one feature and a leaf table")
    if t > 65535:
        raise ValueError(f"{t} trees exceed K5's grid.y limit")
    if max(x.numel() for x in out.values()) >= 2 ** 31:
        raise ValueError("K5 indexes its tables with 32-bit counts")
    return out


def tree_bitvector(x_keys, entry_feat, entry_key, inv_mask, init_mask,
                   leaf_off, leaf_fixed, *, block_b=None, block_t=None) -> torch.Tensor:
    """K5: (B, C) uint32 partials of the QuickScorer tables of
    :func:`bitvector_device_arrays`.

    On the card: ``block_b`` rows and ``block_t`` trees per CTA
    (:func:`pick_blocks` where None), the bitvector scored in chunks of
    :data:`CHUNK_WORDS` words.  On the CPU: :func:`bitvector_plain`.
    """
    if x_keys.device.type == "cpu":
        return bitvector_plain(x_keys, entry_feat, entry_key, inv_mask, init_mask,
                               leaf_off, leaf_fixed)
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_library

    args = _check(x_keys, dict(entry_feat=entry_feat, entry_key=entry_key,
                               inv_mask=inv_mask, init_mask=init_mask,
                               leaf_off=leaf_off, leaf_fixed=leaf_fixed))
    b, f = x_keys.shape
    t, m = args["entry_feat"].shape
    w32 = args["init_mask"].shape[-1]
    n_leaves, c = args["leaf_fixed"].shape
    auto_b, auto_t = pick_blocks(b, t, f, ops._sm_count(x_keys.device))
    block_b, block_t = block_b or auto_b, block_t or auto_t
    if not (32 <= block_b <= tt.MAX_TILE_ROWS and block_b % 32 == 0) or block_t < 1:
        raise ValueError(f"bad CTA shape: {block_b} rows x {block_t} trees")
    stage_x = tt.stages_x(f)
    if stage_x and tt.tile_bytes(block_b, f) > tt.SMEM_PER_CTA:
        raise ValueError(
            f"a {block_b}-row tile of {f} features takes {tt.tile_bytes(block_b, f)} "
            f"bytes of shared memory, over the {tt.SMEM_PER_CTA} a CTA may take")
    shape = dict(block_b=block_b, block_t=block_t,
                 word_chunks=-(-w32 // CHUNK_WORDS), stage_x=stage_x,
                 smem_bytes=tt.tile_bytes(block_b, f) if stage_x else 0)
    lib = load_library()
    out = torch.zeros((b, c), dtype=torch.int32, device=x_keys.device)
    with torch.cuda.device(x_keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.intreeger_bitvector(
            *(a.data_ptr() for a in args.values()), out.data_ptr(),
            b, f, t, m, w32, n_leaves, c, block_b, block_t, int(stage_x), stream)
    if rc != 0:
        raise RuntimeError(f"bitvector kernel launch failed: cudaError {rc}")
    with tt._LAUNCHES_LOCK:
        tt.LAUNCHES["bitvector"] += 1
        tt.LAUNCH_SHAPES["bitvector"] = shape
    return out.view(torch.uint32)
