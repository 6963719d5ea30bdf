"""Vectorized histogram-based CART trainer (training substrate, numpy).

The paper delegates training to sklearn/XGBoost/LightGBM; the repository
depends on none of them, so the training substrate is built from scratch: a
level-synchronous histogram CART (the same algorithmic family as
LightGBM/XGBoost-hist [29]).  It is the JAX package's trainer line for line,
so both packages grow the same trees from the same data and seed.

All per-level work is vectorized:
  * features are quantile-binned once per dataset (uint8 codes),
  * per-(node, feature, bin, class) counts come from one ``np.bincount`` over a
    fused integer index,
  * best splits are chosen from cumulative histograms with Gini impurity.

Leaves store the class distribution (counts / n), matching sklearn's
``predict_proba`` semantics that the paper's pipeline consumes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class TreeArrays:
    """A trained tree as flat arrays (BFS order; node 0 is the root).

    Internal nodes: ``feature >= 0`` and the decision is
    ``x[feature] <= threshold -> left`` (paper Listing 2 semantics).
    Leaves: ``feature == -1`` and ``left == right == self`` (self-loop), with
    ``leaf_probs`` the class distribution.
    """

    feature: np.ndarray  # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray  # (n_nodes,) float32
    left: np.ndarray  # (n_nodes,) int32
    right: np.ndarray  # (n_nodes,) int32
    leaf_probs: np.ndarray  # (n_nodes, n_classes) float64 (exact counts ratio)
    depth: int

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """Reference traversal (numpy, per-sample loopless level walk)."""
        node = np.zeros(X.shape[0], np.int32)
        for _ in range(self.depth + 1):
            feat = self.feature[node]
            is_leaf = feat < 0
            x = X[np.arange(X.shape[0]), np.clip(feat, 0, None)]
            go_left = x <= self.threshold[node]
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(is_leaf, node, nxt).astype(np.int32)
        return self.leaf_probs[node]


@dataclass
class _GrowState:
    feature: list = field(default_factory=list)
    threshold: list = field(default_factory=list)
    left: list = field(default_factory=list)
    right: list = field(default_factory=list)
    probs: list = field(default_factory=list)

    def add(self, feature=-1, threshold=0.0, probs=None) -> int:
        nid = len(self.feature)
        self.feature.append(feature)
        self.threshold.append(threshold)
        self.left.append(nid)
        self.right.append(nid)
        self.probs.append(probs)
        return nid


def _quantile_bins(X: np.ndarray, n_bins: int, rng: np.random.Generator):
    """Per-feature bin edges from quantiles; returns (codes uint8, edges list).

    ``edges[f]`` has shape (n_edges_f,) and code b means
    ``edges[f][b-1] < x <= edges[f][b]`` with code 0 the leftmost bucket.
    A split at bin b uses threshold ``edges[f][b]`` and sends codes <= b left.
    """
    n, f = X.shape
    sub = X if n <= 200_000 else X[rng.choice(n, 200_000, replace=False)]
    edges = []
    codes = np.empty((n, f), np.uint8)
    for j in range(f):
        qs = np.quantile(sub[:, j], np.linspace(0, 1, n_bins + 1)[1:-1])
        e = np.unique(qs.astype(np.float32))
        edges.append(e)
        codes[:, j] = np.searchsorted(e, X[:, j].astype(np.float32), side="left").astype(
            np.uint8
        )
    return codes, edges


def train_tree(
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    *,
    max_depth: int = 6,
    min_samples_leaf: int = 1,
    min_samples_split: int = 2,
    max_features: Optional[int] = None,
    n_bins: int = 64,
    extra_random: bool = False,
    rng: Optional[np.random.Generator] = None,
    _binned: Optional[tuple] = None,
) -> TreeArrays:
    """Grow one CART tree level-synchronously with histogram splits."""
    rng = rng or np.random.default_rng(0)
    n, F = X.shape
    if _binned is None:
        codes, edges = _quantile_bins(X, n_bins, rng)
    else:
        codes, edges = _binned
    B = max(len(e) + 1 for e in edges) if edges else 1
    B = max(B, 2)
    y = y.astype(np.int64)
    C = n_classes

    st = _GrowState()
    root = st.add()
    sample_node = np.zeros(n, np.int32)
    # nodes still growing at current level
    frontier = {root: np.int32(root)}
    depth_of = {root: 0}
    tree_depth = 0

    for level in range(max_depth + 1):
        if not frontier:
            break
        active = sorted(frontier)
        slot_of = {nid: i for i, nid in enumerate(active)}
        S = len(active)
        # map each sample's node -> active slot (or -1 when finished)
        slot_map = np.full(len(st.feature), -1, np.int64)
        for nid, i in slot_of.items():
            slot_map[nid] = i
        sslot = slot_map[sample_node]
        live = sslot >= 0
        idx_live = np.nonzero(live)[0]
        if idx_live.size == 0:
            break
        sl = sslot[idx_live]
        yb = y[idx_live]
        cb = codes[idx_live]  # (m, F)

        # fused histogram: counts[slot, f, bin, class]
        fuse = ((sl[:, None] * F + np.arange(F)[None, :]) * B + cb.astype(np.int64)) * C + yb[
            :, None
        ]
        counts = np.bincount(fuse.ravel(), minlength=S * F * B * C).reshape(S, F, B, C)

        node_counts = counts[:, 0].sum(axis=1)  # (S, C) — same for every f
        node_total = node_counts.sum(axis=1)  # (S,)

        # candidate: split after bin b (codes <= b go left); last bin invalid
        left_counts = np.cumsum(counts, axis=2)  # (S, F, B, C)
        left_tot = left_counts.sum(axis=3)  # (S, F, B)
        right_counts = node_counts[:, None, None, :] - left_counts
        right_tot = node_total[:, None, None] - left_tot

        def gini_sum(cnt, tot):
            # tot * gini = tot - sum_c cnt_c^2 / tot  (0 when tot == 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                g = tot - np.where(tot > 0, (cnt.astype(np.float64) ** 2).sum(-1) / tot, 0.0)
            return np.where(tot > 0, g, 0.0)

        impurity = gini_sum(left_counts, left_tot) + gini_sum(right_counts, right_tot)
        valid = (left_tot >= min_samples_leaf) & (right_tot >= min_samples_leaf)
        # bins past the last edge of a feature can never split
        for j in range(F):
            valid[:, j, len(edges[j]) :] = False
        if max_features is not None and max_features < F:
            # per-node random feature subset (RF-style)
            for i in range(S):
                keep = rng.choice(F, max_features, replace=False)
                mask = np.ones(F, bool)
                mask[keep] = False
                valid[i, mask, :] = False
        if extra_random:
            # ExtraTrees: one random candidate bin per (node, feature)
            keep_bin = rng.integers(0, B, size=(S, F))
            m = np.zeros_like(valid)
            m[np.arange(S)[:, None], np.arange(F)[None, :], keep_bin] = True
            valid &= m

        impurity = np.where(valid, impurity, np.inf)
        flat = impurity.reshape(S, F * B)
        best = flat.argmin(axis=1)
        best_f, best_b = best // B, best % B
        best_imp = flat[np.arange(S), best]
        parent_imp = gini_sum(node_counts, node_total)
        improves = best_imp < parent_imp - 1e-12

        # decide each active node: leaf or split
        child_assign = {}
        for i, nid in enumerate(active):
            probs = node_counts[i] / max(node_total[i], 1)
            pure = (node_counts[i] > 0).sum() <= 1
            if (
                level == max_depth
                or node_total[i] < min_samples_split
                or pure
                or not np.isfinite(best_imp[i])
                or not improves[i]
            ):
                st.feature[nid] = -1
                st.probs[nid] = probs
                continue
            f, b = int(best_f[i]), int(best_b[i])
            st.feature[nid] = f
            st.threshold[nid] = float(edges[f][b])
            lid = st.add()
            rid = st.add()
            st.left[nid], st.right[nid] = lid, rid
            depth_of[lid] = depth_of[rid] = level + 1
            tree_depth = max(tree_depth, level + 1)
            child_assign[nid] = (f, b, lid, rid)

        # route samples of split nodes to children
        new_frontier = {}
        if child_assign:
            for nid, (f, b, lid, rid) in child_assign.items():
                m = sample_node == nid
                go_left = codes[m, f] <= b
                ids = np.nonzero(m)[0]
                sample_node[ids[go_left]] = lid
                sample_node[ids[~go_left]] = rid
                new_frontier[lid] = lid
                new_frontier[rid] = rid
        frontier = new_frontier

    # finalize any frontier leftovers as leaves (shouldn't happen, guard)
    for nid in frontier:
        if st.probs[nid] is None:
            st.feature[nid] = -1
            st.probs[nid] = np.full(C, 1.0 / C)

    probs = np.stack(
        [p if p is not None else np.zeros(C) for p in st.probs]
    ).astype(np.float64)
    return TreeArrays(
        feature=np.asarray(st.feature, np.int32),
        threshold=np.asarray(st.threshold, np.float32),
        left=np.asarray(st.left, np.int32),
        right=np.asarray(st.right, np.int32),
        leaf_probs=probs,
        depth=tree_depth,
    )


# convenience alias used by forest.py
DecisionTree = TreeArrays
