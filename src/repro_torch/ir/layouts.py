"""Layout materializers: ForestIR -> concrete memory layouts (numpy).

  * ``padded``     — dense ``(T, N)`` node tables, every tree padded to the
                     max node count with self-looping zero-mass leaves; the
                     layout the gather walk (kernel K2) reads.
  * ``ragged``     — CSR node arrays with per-tree offsets and *global*
                     child indices; no ``O(T * N_max)`` padding.
  * ``leaf_major`` — padded tables with each tree's nodes permuted internal-
                     first, leaves last, plus ``internal_counts``; the layout
                     the bounded walk (kernel K1) reads.

Materializers never quantize: they only rearrange the IR's arrays, which is
why every layout is score-bit-identical in the flint/integer modes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np

from repro_torch.core.fixedpoint import scale_for

_LAYOUTS: Dict[str, Callable] = {}


def register_layout(name: str):
    """Decorator: register ``fn(ir) -> artifact`` as a named layout."""

    def deco(fn):
        _LAYOUTS[name] = fn
        return fn

    return deco


def available_layouts() -> list:
    return sorted(_LAYOUTS)


def materialize(ir, name: str):
    try:
        fn = _LAYOUTS[name]
    except KeyError:
        raise KeyError(
            f"unknown layout {name!r}; available: {available_layouts()}"
        ) from None
    return fn(ir)


# ---------------------------------------------------------------------------
# padded: the historical PackedEnsemble node tables
# ---------------------------------------------------------------------------

def _padded_tables(ir, order=None):
    """Scatter the IR into (T, N) tables; ``order`` optionally permutes each
    tree's nodes (``order[t]`` maps new position -> IR-local index)."""
    from repro_torch.core.packing import PackedEnsemble

    T, C, N = ir.n_trees, ir.n_classes, ir.max_nodes
    feature = np.full((T, N), -1, np.int32)
    threshold = np.zeros((T, N), np.float32)
    threshold_key = np.zeros((T, N), np.int32)  # == float_to_key(0.0)
    left = np.tile(np.arange(N, dtype=np.int32), (T, 1))
    right = left.copy()
    probs = np.zeros((T, N, C), np.float64)
    fixed = np.zeros((T, N, C), np.uint32)
    counts = ir.node_counts
    for t in range(T):
        off, n = int(ir.node_offsets[t]), int(counts[t])
        sl = slice(off, off + n)
        if order is None:
            perm = slice(None)
            child = lambda a: a
        else:
            perm = order[t]  # new -> old
            inv = np.empty(n, np.int32)
            inv[perm] = np.arange(n, dtype=np.int32)  # old -> new
            child = lambda a, inv=inv: inv[a]
        feature[t, :n] = ir.feature[sl][perm]
        threshold[t, :n] = ir.threshold[sl][perm]
        threshold_key[t, :n] = ir.threshold_key[sl][perm]
        left[t, :n] = child(ir.left[sl][perm])
        right[t, :n] = child(ir.right[sl][perm])
        probs[t, :n] = ir.leaf_probs[sl][perm]
        fixed[t, :n] = ir.leaf_fixed[sl][perm]
    return PackedEnsemble(
        feature=feature,
        threshold=threshold,
        threshold_key=threshold_key,
        left=left,
        right=right,
        leaf_probs=probs.astype(np.float32),
        leaf_fixed=fixed,
        n_trees=T,
        n_classes=C,
        n_features=ir.n_features,
        max_depth=ir.max_depth,
        quant_scale=ir.quant_scale,
        node_counts=counts.copy(),
        ir=ir,
    )


@register_layout("padded")
def padded_layout(ir):
    """Dense (T, N) self-looping node tables."""
    return _padded_tables(ir)


@register_layout("leaf_major")
def leaf_major_layout(ir):
    """Padded tables with internal nodes first, leaves grouped last per tree.

    The permutation is stable within each group, and a tree's root stays at
    index 0 (the first internal node in BFS order is the root; a single-leaf
    stump has no internal nodes, so its one leaf stays put).  Traversal is
    index-gather-based, so reordering cannot perturb scores.

    Records ``internal_counts`` (T,) — the per-tree internal-prefix length —
    when, within the prefix, every child sits at a strictly larger index than
    its parent.  The bounded walk of kernel K1 relies on that: a row walking
    from node 0 reaches its leaf within ``internal_counts[t]`` steps and stops
    at the first index past the prefix.  Imported artifacts may order nodes
    arbitrarily; such forests materialize with ``internal_counts = None`` and
    the cuda backend's ``impl="auto"`` takes the gather walk instead.
    """
    order = []
    internal_counts = np.zeros(ir.n_trees, np.int32)
    scannable = True
    for t in range(ir.n_trees):
        sl = slice(int(ir.node_offsets[t]), int(ir.node_offsets[t + 1]))
        is_leaf = ir.feature[sl] < 0
        internal = np.flatnonzero(~is_leaf)
        internal_counts[t] = len(internal)
        perm = np.concatenate([internal, np.flatnonzero(is_leaf)]).astype(np.int32)
        if scannable and len(internal):
            inv = np.empty(len(perm), np.int32)
            inv[perm] = np.arange(len(perm), dtype=np.int32)
            kids = np.concatenate(
                [inv[ir.left[sl][internal]], inv[ir.right[sl][internal]]]
            )
            scannable = bool((kids > np.tile(inv[internal], 2)).all())
        order.append(perm)
    out = _padded_tables(ir, order)
    out.layout = "leaf_major"
    out.internal_counts = internal_counts if scannable else None
    return out


# ---------------------------------------------------------------------------
# ragged: CSR node arrays, global child indices
# ---------------------------------------------------------------------------

@dataclass
class RaggedEnsemble:
    """CSR materialization: all trees' nodes contiguous, no padding.

    ``left``/``right`` are *global* node indices (leaves self-loop globally),
    ``roots[t] == node_offsets[t]`` is tree ``t``'s entry point — exactly the
    arrays the table-walk C emitter (``codegen/table_emitter.py``) compiles
    as static data.  Exposes the same metadata surface as ``PackedEnsemble``
    so engines and emitters stay layout-polymorphic.
    """

    feature: np.ndarray  # (total,) int32, -1 for leaf
    threshold: np.ndarray  # (total,) float32
    threshold_key: np.ndarray  # (total,) int32
    left: np.ndarray  # (total,) int32, global
    right: np.ndarray  # (total,) int32, global
    leaf_probs: np.ndarray  # (total, C) float32
    leaf_fixed: np.ndarray  # (total, C) uint32
    roots: np.ndarray  # (T,) int32
    node_offsets: np.ndarray  # (T+1,) int64
    n_trees: int
    n_classes: int
    n_features: int
    max_depth: int
    layout: str = "ragged"
    # sub-forest artifacts: the parent ensemble's quantization scale
    quant_scale: int = field(default=None, repr=False)
    ir: object = field(default=None, repr=False, compare=False)

    @property
    def scale(self) -> int:
        return self.quant_scale if self.quant_scale is not None \
            else scale_for(self.n_trees)

    @property
    def total_nodes(self) -> int:
        return int(self.node_offsets[-1])

    def nbytes_integer(self) -> int:
        """Bytes of the integer-only ragged deployment artifact."""
        return (
            self.feature.nbytes
            + self.threshold_key.nbytes
            + self.left.nbytes
            + self.right.nbytes
            + self.leaf_fixed.nbytes
            + self.roots.nbytes
        )

    def nbytes_float(self) -> int:
        return (
            self.feature.nbytes
            + self.threshold.nbytes
            + self.left.nbytes
            + self.right.nbytes
            + self.leaf_probs.nbytes
            + self.roots.nbytes
        )


@register_layout("ragged")
def ragged_layout(ir):
    base = np.repeat(ir.node_offsets[:-1], ir.node_counts).astype(np.int32)
    return RaggedEnsemble(
        feature=ir.feature.copy(),
        threshold=ir.threshold.copy(),
        threshold_key=ir.threshold_key.copy(),
        left=ir.left + base,
        right=ir.right + base,
        leaf_probs=ir.leaf_probs.astype(np.float32),
        leaf_fixed=ir.leaf_fixed.copy(),
        roots=ir.node_offsets[:-1].astype(np.int32),
        node_offsets=ir.node_offsets.copy(),
        n_trees=ir.n_trees,
        n_classes=ir.n_classes,
        n_features=ir.n_features,
        max_depth=ir.max_depth,
        quant_scale=ir.quant_scale,
        ir=ir,
    )
