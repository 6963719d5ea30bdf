"""Host wrapper around the tree-traversal kernels: block choice, impl
resolution, the ensemble-level entry points.

Block choice for the H100.  A CTA is ``ROWS_PER_CTA = 128`` threads, one row
each, and walks a chunk of ``block_t`` trees.  Each walk is a chain of
dependent loads, so the card is kept busy by having many walks in flight,
not by large tiles: 128-thread CTAs let 16 CTAs share an SM (2,048 threads),
and the tree axis is split until the grid holds about two waves of them,
``2 * SMs * 16`` CTAs.  A 65,536-row batch has 512 row blocks; on 132 SMs
that splits 128 trees into chunks of 15 (9 chunks, 4,608 CTAs).  Small
batches get one tree per CTA.  Partials of the chunks meet through uint32
atomics, which are exact in any order.

The TPU's VMEM budget and tiny-batch clamp do not carry over: they were
facts of the TPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flint import float_to_key
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_traverse import (
    tree_traverse_gather,
    tree_traverse_leaf_major,
    tree_traverse_onehot,
)

ROWS_PER_CTA = 128
_THREADS_PER_SM = 2048
_WAVES = 2
#: the H100 SXM's SM count, used when the tensors are not on a card
_H100_SMS = 132

IMPLS = ("gather", "leaf_major", "onehot")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")


def pick_blocks(b: int, t: int, sm_count: int = _H100_SMS):
    """(rows per CTA, trees per CTA) for a (b rows, t trees) launch."""
    row_blocks = -(-b // ROWS_PER_CTA)
    target = _WAVES * sm_count * (_THREADS_PER_SM // ROWS_PER_CTA)
    chunks = min(t, max(1, -(-target // row_blocks)))
    return ROWS_PER_CTA, -(-t // chunks)


def pick_blocks_candidates(b: int, t: int, sm_count: int = _H100_SMS) -> list:
    """The measured-autotune grid: :func:`pick_blocks`'s choice first (ties
    resolve to it), then its neighbours with rows per CTA halved and doubled
    (multiples of 32 up to 1,024, what a CTA can hold) and trees per CTA
    halved and doubled (1 to ``t``).  Every entry gives the same partials."""
    auto_b, auto_t = pick_blocks(b, t, sm_count)
    cands = [(auto_b, auto_t)]
    for bb, bt in ((auto_b // 2, auto_t), (auto_b * 2, auto_t),
                   (auto_b, auto_t // 2), (auto_b, min(t, auto_t * 2))):
        if 32 <= bb <= 1024 and bb % 32 == 0 and bt >= 1 \
                and (bb, bt) not in cands:
            cands.append((bb, bt))
    return cands


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return _H100_SMS


def tree_predict_integer(x_keys, feature, threshold_key, left, right,
                         leaf_fixed, *, depth: int, block_b=None, block_t=None,
                         impl: str = "gather", internal_counts=None,
                         device=None) -> torch.Tensor:
    """Integer ensemble inference through K1 (``impl="leaf_major"``), K2
    (``impl="gather"``) or K3 (``impl="onehot"``), any B and T.  Inputs are
    moved to ``device`` (``cuda`` unless ``device="cpu"``).  Returns (B, C)
    uint32 partials, bit-identical to ``ref.tree_predict_integer_ref`` (for
    K3, on tables whose every index lies inside its table)."""
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
    auto_b, auto_t = pick_blocks(x_keys.shape[0], feature.shape[0], _sm_count(dev))
    block_b, block_t = block_b or auto_b, block_t or auto_t
    if impl == "leaf_major":
        return tree_traverse_leaf_major(
            x_keys, feature, threshold_key, left, right,
            on_dev(internal_counts).to(torch.int32), leaf_fixed,
            block_b=block_b, block_t=block_t)
    walk = tree_traverse_onehot if impl == "onehot" else tree_traverse_gather
    return walk(x_keys, feature, threshold_key, left, right, leaf_fixed,
                depth=depth, block_b=block_b, block_t=block_t)


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
