"""K5, the QuickScorer scorer, beside its plain version.

  * K5 ``tree_bitvector``: the CUDA kernel ``bitvector_tile<rows, staged,
    staged_records>`` in ``repro_torch/csrc/bitvector.cu``.  It replaces the
    JAX package's ``kernels/bitvector.py::_bitvector_partials``, which is
    jnp, not Pallas: XLA scores every entry slot of every tree over a
    (B, T, W32) cleared-bit tensor.

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
``popcount(0 - 1)`` is 32).  An entry's feature and a tree's leaf row are
indexed as jnp indexes them: a negative index wraps once (``i + n``), then
clamps into [0, n).  Only malformed tables hold such an index.

K5 reads the slot grid packed once on the host
(:func:`pack_bitvector_tables`): one 16-byte record per nonzero word of each
slot's clear set, grouped by tree and word, so that it ORs each false
entry's nonzero words and nothing else.  The wrapper takes the packed
tables, takes the plain version on the dense grid they keep only for
tensors on the CPU, and for CUDA tensors launches K5 or raises.  It counts
its launches in ``tree_traverse.LAUNCHES["bitvector"]`` and records its CTA
shape in ``tree_traverse.LAUNCH_SHAPES["bitvector"]``, under the walks'
lock.
"""
from __future__ import annotations

from typing import NamedTuple

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
#: the most threads of a K5 CTA (its launch bound), and the rows a thread
#: may score
MAX_THREADS = 1024
ROWS_PER_THREAD = (1, 2)
#: warps per SM that the splits aim for at small batches
_SPLIT_TARGET_WARPS_PER_SM = 32
#: shared memory a CTA spends on its two buffers of staged records at most
#: (2,048 records a tree); larger trees read their records from the table
STAGED_RECORD_BYTES = 64 << 10
#: registers a K5 thread takes at most (its launch bound of 1,024 threads)
_REGS_PER_THREAD = 64


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


def _jnp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Indices into a length-``n`` axis as jnp's gathers take them: a
    negative index wraps once, then every index clamps into [0, n)."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def bitvector_plain(x_keys, entry_feat, entry_key, inv_mask, init_mask,
                    leaf_off, leaf_fixed, *, chunk_rows=None) -> torch.Tensor:
    """K5's function in plain PyTorch, the twin of ``_bitvector_partials``:
    (B, F) int32 keys -> (B, C) uint32 partials.

    One step per entry slot ORs the slot's clear set into every (row, tree)
    whose compare is false, as the jnp form does; the (rows, T, W32)
    cleared-bit tensor is built for ``chunk_rows`` rows at a time (by
    default as many as fit in 64 MiB), so 65,536 rows of the full-width
    model fit on the card.  Each entry's feature and each leaf row is
    indexed as jnp indexes it (:func:`_jnp_index`).  The leaves add in int64
    masked to 32 bits, because torch's uint32 has no add.
    """
    b = x_keys.shape[0]
    t, m = entry_feat.shape
    w32 = init_mask.shape[-1]
    inv = inv_mask.view(torch.int32)
    init = init_mask.view(torch.int32)
    leaf = leaf_fixed.view(torch.int32).to(torch.int64) & _U32_MASK
    feat = _jnp_index(entry_feat.long(), x_keys.shape[1])
    off = leaf_off.long()
    step = chunk_rows or max(1, _PLAIN_CHUNK_BYTES // max(1, t * w32 * 4))
    out = torch.empty((b, leaf.shape[-1]), dtype=torch.int32, device=x_keys.device)
    for r0 in range(0, b, step):
        x = x_keys[r0:r0 + step]
        cleared = torch.zeros((x.shape[0], t, w32), dtype=torch.int32, device=x.device)
        for j in range(m):
            applied = x[:, feat[:, j]] > entry_key[:, j]          # (rows, T)
            cleared |= torch.where(applied[:, :, None], inv[:, j, :], 0)
        rows = _jnp_index(off + _exit_leaves(init & ~cleared), leaf.shape[0])
        out[r0:r0 + step] = (leaf[rows].sum(1) & _U32_MASK).to(torch.int32)
    return out.view(torch.uint32)


# ---------------------------------------------------------------------------
# the packed tables K5 reads
# ---------------------------------------------------------------------------

class BitvectorTables(NamedTuple):
    """The slot grid of :func:`bitvector_device_arrays` as K5 reads it.

    On the tables' device: ``records`` (R, 4) int32, one record {feature,
    key, word, bits} per nonzero word of each slot's clear set, grouped by
    tree, then by word (lowest first), then by slot; ``word_start``
    (T, W32 + 1) int32, the first record of each (tree, word), with
    ``word_start[t, W32]`` ending tree t; and the grid's own ``init_mask``,
    ``leaf_off`` and ``leaf_fixed``.  On the host: ``n_entry_slots`` the
    grid's M, ``tree_records`` the most records of one tree,
    ``feature_range`` the lowest and highest record feature, and ``slot``
    (R,) int32 numpy, the slot each record came from, which only
    :func:`unpack_bitvector_tables` reads.  ``dense``: the six dense tables
    where the tables live on the CPU (the plain version reads them), else
    None.
    """
    records: torch.Tensor
    word_start: torch.Tensor
    init_mask: torch.Tensor
    leaf_off: torch.Tensor
    leaf_fixed: torch.Tensor
    n_entry_slots: int
    tree_records: int
    feature_range: tuple
    slot: np.ndarray
    dense: tuple | None

    def nbytes(self) -> int:
        """Bytes K5 reads its tables from."""
        return sum(a.numel() * a.element_size() for a in (
            self.records, self.word_start, self.init_mask, self.leaf_off,
            self.leaf_fixed))


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.uint32:
            return a.view(torch.int32).numpy().view(np.uint32)
        return a.numpy()
    return np.asarray(a)


def pack_bitvector_tables(entry_feat, entry_key, inv_mask, init_mask, leaf_off,
                          leaf_fixed, device=None) -> BitvectorTables:
    """Pack the dense slot grid (the six tables of
    :func:`bitvector_device_arrays`, in the wrapper's order) into the
    records K5 reads, on ``device`` (``cuda`` unless ``device="cpu"``).

    Every nonzero word of a clear set becomes a record and no zero word
    does, so any mask packs exactly, ranges or not, and the padding slots'
    empty clear sets pack to nothing: they apply nothing in either form.
    Features pack as they are; :func:`tree_bitvector` indexes them with the
    rows' width.  On the CPU the tables also keep the dense grid, as given.
    """
    feat, key = _numpy(entry_feat).astype(np.int32), _numpy(entry_key).astype(np.int32)
    inv = _numpy(inv_mask).view(np.uint32)
    init = _numpy(init_mask).view(np.uint32)
    t, m = feat.shape
    w32 = init.shape[-1]
    if inv.shape != (t, m, w32):
        raise ValueError(f"inv_mask of shape {inv.shape} is not (T, M, W32) = "
                         f"{(t, m, w32)}")
    tree, slot, word = np.nonzero(inv)
    if len(tree) >= 2 ** 31:
        raise ValueError(f"{len(tree)} nonzero mask words exceed K5's 32-bit record index")
    order = np.lexsort((slot, word, tree))
    tree, slot, word = tree[order], slot[order], word[order]
    records = np.stack([feat[tree, slot], key[tree, slot],
                        word.astype(np.int32), inv[tree, slot, word].view(np.int32)], axis=1)
    counts = np.bincount(tree * w32 + word, minlength=t * w32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    word_start = starts[np.arange(t)[:, None] * w32 + np.arange(w32 + 1)]
    dev = resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dense = (entry_feat, entry_key, inv_mask, init_mask, leaf_off, leaf_fixed)
    return BitvectorTables(
        records=as_t(records), word_start=as_t(word_start),
        init_mask=as_t(init), leaf_off=as_t(_numpy(leaf_off).astype(np.int32)),
        leaf_fixed=as_t(_numpy(leaf_fixed).view(np.uint32)), n_entry_slots=m,
        tree_records=int((word_start[:, -1] - word_start[:, 0]).max()) if t else 0,
        feature_range=(int(records[:, 0].min()), int(records[:, 0].max()))
        if len(records) else (0, 0),
        slot=slot.astype(np.int32),
        dense=tuple(torch.as_tensor(a).cpu() for a in dense) if dev.type == "cpu" else None)


def unpack_bitvector_tables(packed: BitvectorTables) -> tuple:
    """The dense slot grid back from ``packed``'s records alone, as tensors
    on its device: ``inv_mask`` bit for bit, and each slot's feature and key
    where its clear set is not empty; a slot with an empty clear set (which
    applies nothing) comes back as padding, feature 0 and key
    ``_NEVER_KEY``."""
    w32 = packed.init_mask.shape[-1]
    t, m = packed.word_start.shape[0], packed.n_entry_slots
    dev = packed.records.device
    rec = packed.records.long()
    tree = torch.repeat_interleave(
        torch.arange(t, device=dev),
        (packed.word_start[:, -1] - packed.word_start[:, 0]).long())
    slot = torch.from_numpy(packed.slot).to(dev).long()
    entry_feat = torch.zeros((t, m), dtype=torch.int32, device=dev)
    entry_key = torch.full((t, m), int(_NEVER_KEY), dtype=torch.int32, device=dev)
    inv = torch.zeros((t, m, w32), dtype=torch.int32, device=dev)
    entry_feat[tree, slot] = rec[:, 0].to(torch.int32)
    entry_key[tree, slot] = rec[:, 1].to(torch.int32)
    inv[tree, slot, rec[:, 2]] = rec[:, 3].to(torch.int32)
    return (entry_feat, entry_key, inv.view(torch.uint32), packed.init_mask,
            packed.leaf_off, packed.leaf_fixed)


# ---------------------------------------------------------------------------
# CTA shape and the kernel wrapper
# ---------------------------------------------------------------------------

def smem_bytes(block_b: int, n_features: int, splits: int, rec_cap: int = 0) -> int:
    """Shared memory of a K5 CTA: the staged row tile (where
    ``tt.stages_x``), the splits' leaves where ``splits > 1``, and two
    buffers of ``rec_cap`` 16-byte records."""
    tile = tt.tile_bytes(block_b, n_features) if tt.stages_x(n_features) else 0
    return tile + (splits * block_b * 4 if splits > 1 else 0) + 2 * 16 * rec_cap


def record_cap(tree_records: int, block_b: int, n_features: int, splits: int) -> int:
    """Records each of a CTA's two record buffers holds: every tree's
    (``tree_records``, the most of one tree) where both buffers fit in
    :data:`STAGED_RECORD_BYTES` and the CTA's shared memory, else 0 (the
    records are read from the table)."""
    if not tree_records or 2 * 16 * tree_records > STAGED_RECORD_BYTES:
        return 0
    fits = smem_bytes(block_b, n_features, splits, tree_records) <= tt.SMEM_PER_CTA
    return tree_records if fits else 0


def check_launch_shape(t: int, n_features: int, block_b: int, block_t: int,
                       splits: int, rows_per_thread: int = 1, rec_cap: int = 0) -> None:
    """Raise ``ValueError`` on a CTA shape K5 does not take: rows per CTA a
    multiple of 32 rows per thread-row up to ``tt.MAX_TILE_ROWS``, at most
    :data:`MAX_THREADS` threads, the shared memory within a CTA's 227 KB,
    and at most 65,535 tree chunks (grid.y)."""
    if rows_per_thread not in ROWS_PER_THREAD:
        raise ValueError(f"rows per thread must be one of {ROWS_PER_THREAD}, "
                         f"got {rows_per_thread}")
    if not (32 * rows_per_thread <= block_b <= tt.MAX_TILE_ROWS
            and block_b % (32 * rows_per_thread) == 0) or block_t < 1 or splits < 1:
        raise ValueError(f"bad CTA shape: {block_b} rows x {block_t} trees x "
                         f"{splits} splits at {rows_per_thread} rows per thread")
    threads = block_b // rows_per_thread * splits
    if threads > MAX_THREADS:
        raise ValueError(f"{block_b} rows x {splits} splits take {threads} threads, "
                         f"over K5's {MAX_THREADS}")
    smem = smem_bytes(block_b, n_features, splits, rec_cap)
    if smem > tt.SMEM_PER_CTA:
        raise ValueError(
            f"a {block_b}-row CTA of {n_features} features, {splits} splits and "
            f"{rec_cap} staged records takes {smem} bytes of shared memory, over "
            f"the {tt.SMEM_PER_CTA} a CTA may take")
    tt.check_tree_chunks(t, block_t)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def pick_blocks(b: int, t: int, n_features: int, w32: int = 2, tree_records: int = 0,
                sm_count: int = None):
    """(rows per CTA, trees per CTA, splits, rows per thread) for K5.

    Rows per thread: 2 (one record load serves two compares), 1 for a batch
    of one warp of rows or fewer.  Rows per CTA: 128 where the batch fills
    two CTAs an SM at that, else 64 (32 for one warp of rows), fewer where
    the staged tile would not fit.  Splits: a tree's words over
    ``pow2_floor(W32 / 4)`` warps (each split stops at its own first
    surviving word, so finer splits scan fewer words), doubled while the
    batch's warps number under ``_SPLIT_TARGET_WARPS_PER_SM`` an SM, up to
    two words a split and :data:`MAX_THREADS` threads.  Trees: chunks for
    about as many waves of resident CTAs as the walks aim at, down to one
    tree per CTA; there are at most waves x SMs x resident CTAs chunks, so
    never more than grid.y's 65,535."""
    from repro_torch.kernels import ops

    sm_count = sm_count or ops._H100_SMS
    staged = tt.stages_x(n_features)
    rows_per_thread = 2 if b > 32 else 1
    rows = 128 if b >= 2 * 128 * sm_count else 64 if b > 32 else 32
    while staged and tt.tile_bytes(rows, n_features) > tt.SMEM_PER_CTA \
            and rows > 32 * rows_per_thread:
        rows -= 32 * rows_per_thread
    if staged and tt.tile_bytes(rows, n_features) > tt.SMEM_PER_CTA:
        rows, rows_per_thread = 32, 1  # stages_x: a 32-row tile fits
    row_blocks = max(1, -(-b // rows))
    warps = row_blocks * (rows // (32 * rows_per_thread)) * t
    most = max(1, min(w32 // 2, MAX_THREADS * rows_per_thread // rows))
    splits = min(_pow2_floor(w32 // 4), _pow2_floor(most))
    while 2 * splits <= most and warps * splits < _SPLIT_TARGET_WARPS_PER_SM * sm_count:
        splits *= 2
    threads = rows // rows_per_thread * splits
    rec_cap = record_cap(tree_records, rows, n_features, splits)
    per_cta = smem_bytes(rows, n_features, splits, rec_cap) + ops._SMEM_RESERVED_PER_CTA
    resident = max(1, min(ops._THREADS_PER_SM // threads, ops._CTAS_PER_SM,
                          ops._SMEM_PER_SM // per_cta,
                          ops._THREADS_PER_SM * 32 // (_REGS_PER_THREAD * threads)))
    chunks = min(t, max(1, -(-ops._STAGED_WAVES * sm_count * resident // row_blocks)))
    return rows, -(-t // chunks), splits, rows_per_thread


def _check(x_keys, tables: BitvectorTables):
    """Check what K5 takes; return the tensors to pass, uint32 as int32."""
    dev = x_keys.device
    if dev.type != "cuda":
        raise ValueError(f"K5 takes CUDA tensors, got {dev}")
    b, f = x_keys.shape
    n_rec = tables.records.shape[0]
    t, w32 = tables.init_mask.shape
    n_leaves, c = tables.leaf_fixed.shape
    shapes = {"x_keys": (b, f), "records": (n_rec, 4), "word_start": (t, w32 + 1),
              "init_mask": (t, w32), "leaf_off": (t,), "leaf_fixed": (n_leaves, c)}
    out = {}
    named = [(k, getattr(tables, k)) for k in shapes if k != "x_keys"]
    for name, a in (("x_keys", x_keys), *named):
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
    if n_rec and out["records"].data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")
    if f < 1 or n_leaves < 1:
        raise ValueError("K5 needs rows with at least one feature and a leaf table")
    if max(x.numel() for x in out.values()) >= 2 ** 31 or w32 > 2 ** 25:
        raise ValueError("K5 indexes its tables with 32-bit counts")
    return out


def _wrap_features(records: torch.Tensor, n_features: int) -> torch.Tensor:
    """``records`` with each feature indexed as jnp indexes ``x[:, f]`` on
    rows of ``n_features`` columns (:func:`_jnp_index`)."""
    out = records.clone()
    out[:, 0] = _jnp_index(records[:, 0], n_features)
    return out


def tree_bitvector(x_keys, tables: BitvectorTables, *, block_b=None, block_t=None,
                   splits=None, _rows_per_thread=None, _stage_records=None) -> torch.Tensor:
    """K5: (B, C) uint32 partials of the QuickScorer ``tables``
    (:func:`pack_bitvector_tables`).

    On the card: ``block_b`` rows, ``block_t`` trees and ``splits`` warps a
    tree per CTA, rows per thread and the staging of each tree's records in
    shared memory as :func:`pick_blocks` and :func:`record_cap` choose them
    where None; ``_rows_per_thread`` and ``_stage_records`` pin those two for
    tests.  Where a record's feature lies outside [0, F) (a malformed
    table), the records are copied with each feature wrapped and clamped as
    jnp indexes it, so that K5's own clamp is exact.  On the CPU:
    :func:`bitvector_plain` on the dense grid the tables keep.
    """
    if not isinstance(tables, BitvectorTables):
        raise TypeError("tree_bitvector takes the BitvectorTables of pack_bitvector_tables")
    if x_keys.device.type == "cpu":
        if tables.dense is None:
            raise ValueError(f"tables packed for {tables.records.device} cannot score "
                             "rows on the CPU")
        return bitvector_plain(x_keys, *tables.dense)
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_library

    args = _check(x_keys, tables)
    b, f = x_keys.shape
    t, w32 = args["init_mask"].shape
    n_leaves, c = args["leaf_fixed"].shape
    if tables.feature_range[0] < 0 or tables.feature_range[1] >= f:
        args["records"] = _wrap_features(args["records"], f)
    auto = pick_blocks(b, t, f, w32, tables.tree_records, ops._sm_count(x_keys.device))
    block_b, block_t = block_b or auto[0], block_t or auto[1]
    rows_per_thread = _rows_per_thread or (auto[3] if block_b % (32 * auto[3]) == 0 else 1)
    # a pinned row count takes the rule's splits as far as the threads allow
    splits = splits or max(1, min(auto[2], MAX_THREADS * rows_per_thread // block_b))
    rec_cap = record_cap(tables.tree_records, block_b, f, splits)
    if _stage_records is not None:
        rec_cap = tables.tree_records if _stage_records else 0
    check_launch_shape(t, f, block_b, block_t, splits, rows_per_thread, rec_cap)
    stage_x = tt.stages_x(f)
    shape = dict(block_b=block_b, block_t=block_t, splits=splits,
                 rows_per_thread=rows_per_thread, stage_x=stage_x, staged_records=rec_cap,
                 smem_bytes=smem_bytes(block_b, f, splits, rec_cap))
    lib = load_library()
    out = torch.zeros((b, c), dtype=torch.int32, device=x_keys.device)
    with torch.cuda.device(x_keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.intreeger_bitvector(
            *(a.data_ptr() for a in args.values()), out.data_ptr(),
            b, f, t, w32, args["records"].shape[0], n_leaves, c, block_b, block_t,
            splits, rows_per_thread, rec_cap, int(stage_x), stream)
    if rc != 0:
        raise RuntimeError(f"bitvector kernel launch failed: cudaError {rc}")
    with tt._LAUNCHES_LOCK:
        tt.LAUNCHES["bitvector"] += 1
        tt.LAUNCH_SHAPES["bitvector"] = shape
    return out.view(torch.uint32)
