"""Host wrapper around the tree-traversal kernels: block choice, impl
resolution, the ensemble-level entry points.

Block choice for the H100.  The kernels (K1, K2 and K3, one CUDA body)
stage each CTA's rows of ``x_keys`` in shared memory
(``kernels/tree_traverse.py::stages_x``: while a 32-row tile of F
features fits in 227 KB), so the tile bounds the rows an SM holds: 128
rows of the 87-feature model take 44,544 bytes, and five such CTAs (640
rows) share an SM's 228 KB.  A CTA keeps ``ROWS_PER_CTA = 128`` rows
where the tile fits, else the most rows, in multiples of 32, that fit.
Each thread walks several trees at once (``tree_traverse.py::
default_walks``), which keeps more loads in flight than the resident
rows alone would.  The tree axis is split into chunks for about four
waves of resident CTAs, with at least one group of walks (4 trees) per
CTA and chunks rounded up to whole groups: a 65,536-row batch (512 row
blocks) gets 6 chunks of 24 trees (3,072 CTAs), a batch of 1,000 or 20
rows chunks of 4.  Each chunk copies its rows once more, which is what
the floor of 4 trees pays for at small batches.  Launches that stage
nothing (rows too wide to stage) keep the first version's rule: about
two waves of 16 CTAs of 128 threads per SM, 9 chunks of 15 trees at
65,536 rows.  All three kernels stage alike, so the choice depends on the
shapes alone, not on the kernel.  ``PERF.md`` has the sweep behind these constants.  Partials of the chunks
meet through uint32 atomics, which are exact in any order.

The TPU's VMEM budget and tiny-batch clamp do not carry over: they were
facts of the TPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flint import float_to_key
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_traverse import (
    DEFAULT_WALKS,
    MAX_TILE_ROWS,
    SMEM_PER_CTA,
    default_walks,
    pack_node_quads,
    stages_x,
    tile_bytes,
    tree_traverse_gather,
    tree_traverse_leaf_major,
    tree_traverse_onehot,
)

ROWS_PER_CTA = 128
#: waves of resident CTAs that the tree chunks aim at, staged and unstaged
_STAGED_WAVES = 4
_UNSTAGED_WAVES = 2
_THREADS_PER_SM = 2048
_CTAS_PER_SM = 32
#: an SM's shared memory (228 KB), and what the card keeps of it per CTA
_SMEM_PER_SM = 233_472
_SMEM_RESERVED_PER_CTA = 1024
#: the H100 SXM's SM count, used when the tensors are not on a card
_H100_SMS = 132

IMPLS = ("gather", "leaf_major", "onehot")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")


def fits(block_b: int, n_features: int) -> bool:
    """Whether the kernels take ``block_b`` rows per CTA at F features."""
    return (32 <= block_b <= MAX_TILE_ROWS and block_b % 32 == 0
            and (not stages_x(n_features)
                 or tile_bytes(block_b, n_features) <= SMEM_PER_CTA))


def resident_ctas(block_b: int, n_features=None) -> int:
    """CTAs of ``block_b`` rows an SM holds at once, by threads and, where
    the rows are staged (``n_features`` given and :func:`stages_x`), by
    shared memory."""
    ctas = min(_THREADS_PER_SM // block_b, _CTAS_PER_SM)
    if n_features is not None and stages_x(n_features):
        per_cta = tile_bytes(block_b, n_features) + _SMEM_RESERVED_PER_CTA
        ctas = min(ctas, _SMEM_PER_SM // per_cta)
    return ctas


def pick_blocks(b: int, t: int, n_features: int, sm_count: int = _H100_SMS):
    """(rows per CTA, trees per CTA) for a (b rows, t trees, F features)
    launch, staged where :func:`stages_x`.

    Staged: ``ROWS_PER_CTA`` rows or the most whose tile fits; tree chunks
    for about ``_STAGED_WAVES`` waves of resident CTAs, at least
    ``DEFAULT_WALKS`` trees per CTA, rounded up to whole groups of walks.
    Unstaged: 128 rows and about ``_UNSTAGED_WAVES`` waves of 16 CTAs per
    SM, the first version's rule."""
    staged = stages_x(n_features)
    rows = ROWS_PER_CTA
    while staged and tile_bytes(rows, n_features) > SMEM_PER_CTA:
        rows -= 32  # stages_x guarantees that 32 rows fit
    row_blocks = max(1, -(-b // rows))
    waves = _STAGED_WAVES if staged else _UNSTAGED_WAVES
    target = waves * sm_count * resident_ctas(rows, n_features if staged else None)
    chunks = min(t, max(1, -(-target // row_blocks)))
    block_t = -(-t // chunks)
    if not staged:
        return rows, block_t
    block_t = max(block_t, min(t, DEFAULT_WALKS))
    walks = default_walks(block_t)
    return rows, min(t, -(-block_t // walks) * walks)


def pick_blocks_candidates(b: int, t: int, n_features: int,
                           sm_count: int = _H100_SMS) -> list:
    """The measured-autotune grid: :func:`pick_blocks`'s
    choice first (ties resolve to it), then its neighbours with rows per CTA
    halved and doubled and trees per CTA halved and doubled (1 to ``t``),
    each only if the kernel takes it (:func:`fits`).  Every entry gives the
    same partials."""
    auto_b, auto_t = pick_blocks(b, t, n_features, sm_count)
    cands = [(auto_b, auto_t)]
    for bb, bt in ((auto_b // 2, auto_t), (auto_b * 2, auto_t),
                   (auto_b, auto_t // 2), (auto_b, min(t, auto_t * 2))):
        if fits(bb, n_features) and bt >= 1 and (bb, bt) not in cands:
            cands.append((bb, bt))
    return cands


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return _H100_SMS


def tree_predict_integer(x_keys, feature, threshold_key, left, right,
                         leaf_fixed, *, depth: int, block_b=None, block_t=None,
                         impl: str = "gather", internal_counts=None,
                         quads=None, device=None) -> torch.Tensor:
    """Integer ensemble inference through K1 (``impl="leaf_major"``), K2
    (``impl="gather"``) or K3 (``impl="onehot"``), any B and T.  Inputs are
    moved to ``device`` (``cuda`` unless ``device="cpu"``).  The kernels read
    the node quads: ``quads`` where the caller packed them once
    (``pack_node_quads`` of these four tables, as ``CudaBackend`` does),
    else packed here per call.  The CTA shape is :func:`pick_blocks`'
    unless given.  Returns (B, C) uint32 partials, bit-identical to
    ``ref.tree_predict_integer_ref`` (for K3, on tables whose every index
    lies inside its table)."""
    check_impl(impl)
    if impl == "leaf_major" and internal_counts is None:
        raise ValueError(
            "impl='leaf_major' needs the layout's internal_counts; "
            "materialize the forest as leaf_major (see repro_torch.ir.layouts)"
        )
    dev = resolve_device(device)

    def on_dev(a):
        if isinstance(a, np.ndarray) and a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a, device=dev).contiguous()

    x_keys, feature, threshold_key, left, right, leaf_fixed = (
        on_dev(a) for a in (x_keys, feature, threshold_key, left, right, leaf_fixed))
    auto_b, auto_t = pick_blocks(x_keys.shape[0], feature.shape[0],
                                 x_keys.shape[1], _sm_count(dev))
    blocks = dict(block_b=block_b or auto_b, block_t=block_t or auto_t)
    if quads is None:
        quads = pack_node_quads(feature, threshold_key, left, right)
    quads = on_dev(quads)
    if tuple(quads.shape) != (*feature.shape, 4):
        raise ValueError(f"quads of shape {tuple(quads.shape)} do not pack "
                         f"(T, N) = {tuple(feature.shape)} node tables")
    if impl == "leaf_major":
        return tree_traverse_leaf_major(
            x_keys, quads, on_dev(internal_counts).to(torch.int32), leaf_fixed,
            **blocks)
    walk = tree_traverse_onehot if impl == "onehot" else tree_traverse_gather
    return walk(x_keys, quads, leaf_fixed, depth=depth, **blocks)


def resolve_impl(packed, impl: str) -> str:
    """``auto`` -> the bounded walk on scannable ``leaf_major`` tables, else
    the gather walk (any node order).  ``gather`` and ``onehot`` walk
    ``max_depth`` levels over either layout."""
    layout = getattr(packed, "layout", "padded")
    scannable = getattr(packed, "internal_counts", None) is not None
    if impl == "auto":
        return "leaf_major" if layout == "leaf_major" and scannable else "gather"
    check_impl(impl)
    return impl


def packed_predict_integer(packed, X, impl: str = "auto", *, device=None, **kw):
    """Node-table entry point: float features in, (uint32 partials, preds)
    out, both tensors on ``device``.

    ``packed`` is a ``padded`` or ``leaf_major`` artifact or a ``ForestIR``
    (materialized as the layout the resolved impl walks).  Pinning
    ``impl="leaf_major"`` on a padded artifact re-materializes it through
    the IR back-reference.
    """
    from repro_torch.ir import resolve_artifact

    if hasattr(packed, "materialize"):  # a ForestIR: take the kernel's layout
        packed = packed.materialize(
            "leaf_major" if impl in ("auto", "leaf_major") else "padded")
    layout = getattr(packed, "layout", "padded")
    if layout not in ("padded", "leaf_major"):
        raise ValueError(
            f"the tree kernels walk (T, N) node tables, not the {layout!r} layout")
    impl = resolve_impl(packed, impl)
    if impl == "leaf_major" and layout != "leaf_major":
        packed = resolve_artifact(packed, "leaf_major")
    dev = resolve_device(device)
    keys = float_to_key(torch.as_tensor(np.asarray(X, np.float32), device=dev))
    acc = tree_predict_integer(
        keys, packed.feature, packed.threshold_key, packed.left, packed.right,
        packed.leaf_fixed, depth=packed.max_depth, impl=impl,
        internal_counts=packed.internal_counts if impl == "leaf_major" else None,
        device=dev, **kw)
    wide = acc.view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # unsigned order
    return acc, wide.argmax(1).to(torch.int32)
