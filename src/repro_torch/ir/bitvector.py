"""QuickScorer-family ``bitvector`` layout: traversal-free scoring tables.

A copy of the JAX package's numpy materializer (``repro.ir.bitvector``), so
both packages build the same arrays from one ForestIR.

The QuickScorer line of work ("QuickScorer" Lucchese et al.; "Fast Inference
of Tree Ensembles on ARM Devices" Koschel/Buschjäger/Lucchese — PAPERS.md)
replaces the per-row root-to-leaf walk with *comparison streaming*: all
internal-node tests of the whole forest are regrouped per feature and sorted
by threshold, and every internal node carries a bitmask over its tree's
leaves marking which leaves stay reachable when the node's test is FALSE.

Scoring one row then never chases a pointer:

  1. start every tree's leaf bitvector at "all leaves live",
  2. for each feature ``f``, stream its ascending threshold list and, while
     ``x[f] > key`` (the test ``x <= key`` is false), AND the entry's mask
     into its tree's bitvector — the FIRST true comparison ends the feature
     (ascending order makes every later test true too),
  3. each tree's exit leaf is its first surviving bit.

Correctness is the QuickScorer theorem: leaves are numbered in left-to-right
(in-order) order, so any subtree's leaves form a contiguous bit range.  A
false node's mask clears its *left* subtree's range (those leaves become
unreachable when the walk goes right).  Every false ancestor of the true exit
leaf sends the walk right, so the exit leaf is never cleared; and any
surviving leaf strictly to the left of the exit leaf would need its lowest
common ancestor with the exit leaf to have tested true — but that ancestor
sent the real walk right, i.e. tested false, and its mask cleared that leaf.
Hence the exit leaf is exactly the lowest surviving bit.

Masks are uint64 words, ``words = ceil(max_leaves_per_tree / 64)`` — one word
covers trees up to 64 leaves; deeper trees get multi-word bitvectors, and the
whole pipeline (the plain torch scorer, kernel K5, the tests) handles
``words > 1``.

Like every materializer, this one never quantizes: threshold keys and
fixed-point leaves are pure rearrangements of the IR's arrays, which is what
keeps ``bitvector`` scores bit-identical to every other layout's in the
deterministic modes — including sub-forest artifacts (``ForestIR.subset``),
whose parent ``quant_scale`` is carried through so tree-parallel partials
merge exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.fixedpoint import scale_for
from repro_torch.ir.layouts import register_layout


def _leaf_order_and_ranges(feature, left, right):
    """In-order leaf numbering for one tree's local arrays.

    Returns ``(leaf_nodes, left_ranges)``:
      * ``leaf_nodes``  — local node index of leaf ``j`` (in left-to-right
        order), length ``n_leaves``;
      * ``left_ranges`` — for every *internal* local node ``n`` (in local
        node order), the ``[lo, hi)`` leaf-index range of its LEFT subtree —
        the bits its false-node mask clears.

    Iterative post-order (explicit stack) so pathologically deep trees don't
    hit the recursion limit, mirroring ``c_emitter._emit_node``.
    """
    n_leaves_seen = 0
    leaf_nodes = []
    # span[n] = (first_leaf, last_leaf_exclusive) of the subtree rooted at n
    span_lo = {}
    span_hi = {}
    left_ranges = {}
    # state 0: descend; state 1: children done, fill ranges
    stack = [(0, 0)]
    while stack:
        node, state = stack.pop()
        if feature[node] < 0:  # leaf: assign the next in-order index
            span_lo[node] = n_leaves_seen
            span_hi[node] = n_leaves_seen + 1
            leaf_nodes.append(node)
            n_leaves_seen += 1
            continue
        if state == 0:
            stack.append((node, 1))
            # left pushed LAST so it pops (and numbers its leaves) first
            stack.append((int(right[node]), 0))
            stack.append((int(left[node]), 0))
        else:
            l, r = int(left[node]), int(right[node])
            span_lo[node] = span_lo[l]
            span_hi[node] = span_hi[r]
            left_ranges[node] = (span_lo[l], span_hi[l])
    return leaf_nodes, left_ranges


def _range_mask(lo: int, hi: int, words: int) -> np.ndarray:
    """All-ones ``(words,)`` uint64 vector with leaf bits [lo, hi) cleared."""
    mask = np.full(words, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    for bit in range(lo, hi):
        mask[bit // 64] &= ~np.uint64(1 << (bit % 64))
    return mask


@dataclass
class BitvectorEnsemble:
    """The QuickScorer tables: per-feature sorted threshold streams + masks.

    Threshold entries (one per internal node, forest-wide) are grouped by
    feature and sorted ascending by FlInt key within each feature;
    ``feat_offsets[f] : feat_offsets[f+1]`` is feature ``f``'s slice.  Leaves
    are stored leaf-only (no internal-node rows) in in-order sequence per
    tree — ``leaf_offsets[t] + j`` is tree ``t``'s ``j``-th leaf, exactly the
    row the surviving bit ``j`` selects.  Exposes the same metadata surface
    as the other layout artifacts so engines/backends stay polymorphic.
    """

    # threshold stream, grouped by feature, ascending key inside a feature
    feat_offsets: np.ndarray   # (F+1,) int64
    thr_key: np.ndarray        # (E,) int32 FlInt keys (E = total internal)
    thr_threshold: np.ndarray  # (E,) float32 (reporting only; never compared)
    thr_tree: np.ndarray       # (E,) int32 owning tree
    thr_mask: np.ndarray       # (E, words) uint64 false-node masks
    # per-tree live-leaf init vectors and leaf tables
    init_mask: np.ndarray      # (T, words) uint64 — first n_leaves bits set
    n_leaves: np.ndarray       # (T,) int32
    leaf_offsets: np.ndarray   # (T+1,) int64 rows into the leaf tables
    leaf_probs: np.ndarray     # (total_leaves, C) float32, in-order per tree
    leaf_fixed: np.ndarray     # (total_leaves, C) uint32, in-order per tree
    words: int                 # uint64 words per bitvector
    n_trees: int
    n_classes: int
    n_features: int
    max_depth: int
    layout: str = "bitvector"
    quant_scale: int = field(default=None, repr=False)
    ir: object = field(default=None, repr=False, compare=False)

    @property
    def scale(self) -> int:
        return self.quant_scale if self.quant_scale is not None \
            else scale_for(self.n_trees)

    @property
    def total_entries(self) -> int:
        return int(self.thr_key.shape[0])

    @property
    def total_leaves(self) -> int:
        return int(self.leaf_offsets[-1])

    def nbytes_integer(self) -> int:
        """Bytes of the integer-only bitvector deployment artifact."""
        return (
            self.feat_offsets.nbytes
            + self.thr_key.nbytes
            + self.thr_tree.nbytes
            + self.thr_mask.nbytes
            + self.init_mask.nbytes
            + self.leaf_offsets.nbytes
            + self.leaf_fixed.nbytes
        )

    def nbytes_float(self) -> int:
        return (
            self.feat_offsets.nbytes
            + self.thr_threshold.nbytes
            + self.thr_tree.nbytes
            + self.thr_mask.nbytes
            + self.init_mask.nbytes
            + self.leaf_offsets.nbytes
            + self.leaf_probs.nbytes
        )


@register_layout("bitvector")
def bitvector_layout(ir) -> BitvectorEnsemble:
    """Materialize the IR as QuickScorer threshold streams + leaf bitmasks."""
    T, C, F = ir.n_trees, ir.n_classes, ir.n_features
    counts = ir.node_counts
    # -------- per-tree in-order leaf numbering + false-node mask ranges
    leaf_rows = []          # IR row of every leaf, concatenated in-order
    n_leaves = np.zeros(T, np.int32)
    per_node = []           # (feature, key, threshold, tree, lo, hi)
    for t in range(T):
        off, n = int(ir.node_offsets[t]), int(counts[t])
        sl = slice(off, off + n)
        feat, left, right = ir.feature[sl], ir.left[sl], ir.right[sl]
        leaves, left_ranges = _leaf_order_and_ranges(feat, left, right)
        n_leaves[t] = len(leaves)
        leaf_rows.extend(off + l for l in leaves)
        for node, (lo, hi) in left_ranges.items():
            per_node.append(
                (int(feat[node]), int(ir.threshold_key[off + node]),
                 float(ir.threshold[off + node]), t, lo, hi)
            )
    words = max(1, -(-int(n_leaves.max()) // 64))

    # -------- the per-feature ascending threshold stream
    # stable sort by (feature, key): equal keys may order arbitrarily — the
    # streamed predicate ``x > key`` is identical for equal keys, so entry
    # order among ties cannot change which masks apply
    per_node.sort(key=lambda e: (e[0], e[1]))
    E = len(per_node)
    thr_key = np.fromiter((e[1] for e in per_node), np.int32, E)
    thr_threshold = np.fromiter((e[2] for e in per_node), np.float32, E)
    thr_tree = np.fromiter((e[3] for e in per_node), np.int32, E)
    thr_mask = np.empty((E, words), np.uint64)
    for i, (_, _, _, _, lo, hi) in enumerate(per_node):
        thr_mask[i] = _range_mask(lo, hi, words)
    feat_offsets = np.zeros(F + 1, np.int64)
    feats = np.fromiter((e[0] for e in per_node), np.int64, E)
    np.cumsum(np.bincount(feats, minlength=F), out=feat_offsets[1:])

    # -------- init vectors (first n_leaves bits live) + in-order leaf tables
    init_mask = np.zeros((T, words), np.uint64)
    for t in range(T):
        full, rem = divmod(int(n_leaves[t]), 64)
        init_mask[t, :full] = np.uint64(0xFFFFFFFFFFFFFFFF)
        if rem:
            init_mask[t, full] = np.uint64((1 << rem) - 1)
    leaf_offsets = np.zeros(T + 1, np.int64)
    np.cumsum(n_leaves, out=leaf_offsets[1:])
    take = np.asarray(leaf_rows, np.int64)
    return BitvectorEnsemble(
        feat_offsets=feat_offsets,
        thr_key=thr_key,
        thr_threshold=thr_threshold,
        thr_tree=thr_tree,
        thr_mask=thr_mask,
        init_mask=init_mask,
        n_leaves=n_leaves,
        leaf_offsets=leaf_offsets,
        leaf_probs=ir.leaf_probs[take].astype(np.float32),
        leaf_fixed=ir.leaf_fixed[take].copy(),
        words=words,
        n_trees=T,
        n_classes=C,
        n_features=F,
        max_depth=ir.max_depth,
        quant_scale=ir.quant_scale,
        ir=ir,
    )
