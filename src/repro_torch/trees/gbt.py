"""Gradient-boosted trees (logistic loss), second substrate the paper's
pipeline supports (Sec. II-B: tl2cgen handles "RFs and GBTs").

Binary: standard Friedman GBM — stage t fits a regression tree to the
logistic gradient; leaves carry Newton-step values
``sum(residual) / sum(p(1-p))``.  Multiclass: one-vs-rest ensembles.

Integer-only applicability: GBT leaves are *margins* (unbounded log-odds),
not probabilities, so the paper's 2^32/n probability conversion does not
apply verbatim.  What transfers:
  * FlInt integer threshold compares — identical (branch nodes are the same),
  * fixed-point accumulation with a *margin bound* M: scale
    floor((2^31-1)/(n*M)) keeps n signed contributions overflow-free by the
    same argument (the signed analogue of Sec. III-A; M measured at pack
    time).  `pack_gbt` emits exactly that, and argmax over summed fixed-point
    margins equals the float path's prediction (tested).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.flint import float_to_key_np
from repro_torch.trees.cart import TreeArrays, _quantile_bins


def _fit_regression_tree(X, codes, edges, grad, hess, *, max_depth, min_samples_leaf,
                         rng) -> TreeArrays:
    """Histogram tree on (grad, hess) — Newton leaves (XGBoost-style)."""
    n, F = X.shape
    B = max(max(len(e) + 1 for e in edges), 2)
    from repro_torch.trees.cart import _GrowState

    st = _GrowState()
    root = st.add()
    sample_node = np.zeros(n, np.int32)
    frontier = {root}
    depth = 0
    for level in range(max_depth + 1):
        if not frontier:
            break
        active = sorted(frontier)
        slot_of = {nid: i for i, nid in enumerate(active)}
        slot_map = np.full(len(st.feature), -1, np.int64)
        for nid, i in slot_of.items():
            slot_map[nid] = i
        sslot = slot_map[sample_node]
        live = sslot >= 0
        idx = np.nonzero(live)[0]
        if idx.size == 0:
            break
        sl = sslot[idx]
        # fused histograms of gradient and hessian
        fuse = (sl[:, None] * F + np.arange(F)[None, :]) * B + codes[idx].astype(np.int64)
        gh = np.bincount(fuse.ravel(), weights=np.repeat(grad[idx], F), minlength=len(active) * F * B)
        hh = np.bincount(fuse.ravel(), weights=np.repeat(hess[idx], F), minlength=len(active) * F * B)
        ch = np.bincount(fuse.ravel(), minlength=len(active) * F * B)
        gh = gh.reshape(len(active), F, B)
        hh = hh.reshape(len(active), F, B)
        ch = ch.reshape(len(active), F, B)
        gl = np.cumsum(gh, axis=2)
        hl = np.cumsum(hh, axis=2)
        cl = np.cumsum(ch, axis=2)
        gt = gl[:, 0, -1][:, None, None]
        ht = hl[:, 0, -1][:, None, None]
        ct = cl[:, 0, -1][:, None, None]
        lam = 1.0
        gain = (gl**2 / (hl + lam)) + ((gt - gl) ** 2 / (ht - hl + lam)) - (gt**2 / (ht + lam))
        valid = (cl >= min_samples_leaf) & (ct - cl >= min_samples_leaf)
        for j in range(F):
            valid[:, j, len(edges[j]):] = False
        gain = np.where(valid, gain, -np.inf)
        flat = gain.reshape(len(active), F * B)
        best = flat.argmax(axis=1)
        best_gain = flat[np.arange(len(active)), best]
        best_f, best_b = best // B, best % B

        new_frontier = set()
        for i, nid in enumerate(active):
            m = sample_node == nid
            g_sum, h_sum = grad[m].sum(), hess[m].sum()
            if level == max_depth or not np.isfinite(best_gain[i]) or best_gain[i] <= 1e-12:
                st.feature[nid] = -1
                st.probs[nid] = np.array([g_sum / (h_sum + 1.0)])  # Newton leaf value
                continue
            f, bb = int(best_f[i]), int(best_b[i])
            st.feature[nid] = f
            st.threshold[nid] = float(edges[f][bb])
            lid, rid = st.add(), st.add()
            st.left[nid], st.right[nid] = lid, rid
            depth = max(depth, level + 1)
            ids = np.nonzero(m)[0]
            go_left = codes[ids, f] <= bb
            sample_node[ids[go_left]] = lid
            sample_node[ids[~go_left]] = rid
            new_frontier |= {lid, rid}
        frontier = new_frontier
    vals = np.stack([p if p is not None else np.zeros(1) for p in st.probs])
    return TreeArrays(
        feature=np.asarray(st.feature, np.int32),
        threshold=np.asarray(st.threshold, np.float32),
        left=np.asarray(st.left, np.int32),
        right=np.asarray(st.right, np.int32),
        leaf_probs=vals,  # (n_nodes, 1) leaf margins
        depth=depth,
    )


@dataclass
class GradientBoostedClassifier:
    n_estimators: int = 20
    max_depth: int = 4
    learning_rate: float = 0.3
    min_samples_leaf: int = 5
    n_bins: int = 64
    seed: int = 0

    trees_: List[List[TreeArrays]] = field(default_factory=list)  # [class][stage]
    base_: np.ndarray = None
    n_classes_: int = 0
    n_features_: int = 0

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        self.n_classes_ = int(y.max()) + 1
        self.n_features_ = X.shape[1]
        rng = np.random.default_rng(self.seed)
        codes, edges = _quantile_bins(X, self.n_bins, rng)
        self.base_ = np.zeros(self.n_classes_)
        self.trees_ = []
        for c in range(self.n_classes_):
            yc = (y == c).astype(np.float64)
            prior = np.clip(yc.mean(), 1e-6, 1 - 1e-6)
            margin = np.full(len(y), np.log(prior / (1 - prior)))
            self.base_[c] = margin[0]
            stages = []
            for _ in range(self.n_estimators):
                p = 1.0 / (1.0 + np.exp(-margin))
                grad = yc - p
                hess = p * (1 - p)
                tree = _fit_regression_tree(
                    X, codes, edges, grad, hess,
                    max_depth=self.max_depth, min_samples_leaf=self.min_samples_leaf,
                    rng=rng,
                )
                margin += self.learning_rate * tree.predict_proba(X)[:, 0]
                stages.append(tree)
            self.trees_.append(stages)
        return self

    def decision_function(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        out = np.tile(self.base_, (X.shape[0], 1))
        for c, stages in enumerate(self.trees_):
            for t in stages:
                out[:, c] += self.learning_rate * t.predict_proba(X)[:, 0]
        return out

    def predict(self, X) -> np.ndarray:
        return self.decision_function(X).argmax(axis=1)


@dataclass
class PackedGBT:
    """Integer-only GBT artifact: FlInt keys + fixed-point signed margins."""

    feature: np.ndarray  # (T, N) int32 over all (class, stage) trees
    threshold_key: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_fixed: np.ndarray  # (T, N) int32 fixed-point margin contributions
    tree_class: np.ndarray  # (T,) which class each tree contributes to
    base_fixed: np.ndarray  # (C,) int32
    scale: float
    n_classes: int
    max_depth: int


def pack_gbt(model: GradientBoostedClassifier) -> PackedGBT:
    trees = [t for stages in model.trees_ for t in stages]
    tree_class = np.concatenate(
        [np.full(len(stages), c, np.int32) for c, stages in enumerate(model.trees_)]
    )
    T = len(trees)
    N = max(t.n_nodes for t in trees)
    # margin bound M: max |contribution| over leaves (incl. base), paper-style
    # overflow-free scale for T signed additions
    m_bound = max(
        float(np.abs(model.base_).max()),
        max(float(np.abs(t.leaf_probs).max()) for t in trees) * model.learning_rate,
    ) + 1e-9
    scale = float((2**31 - 1) // ((T + 1) * np.ceil(m_bound)))
    feature = np.full((T, N), -1, np.int32)
    threshold = np.zeros((T, N), np.float32)
    left = np.tile(np.arange(N, dtype=np.int32), (T, 1))
    right = left.copy()
    leaf_fixed = np.zeros((T, N), np.int64)
    for i, t in enumerate(trees):
        n = t.n_nodes
        feature[i, :n] = t.feature
        threshold[i, :n] = t.threshold
        left[i, :n] = t.left
        right[i, :n] = t.right
        is_leaf = t.feature < 0
        vals = model.learning_rate * t.leaf_probs[:, 0]
        leaf_fixed[i, :n][is_leaf] = np.floor(vals[is_leaf] * scale)
    return PackedGBT(
        feature=feature,
        threshold_key=float_to_key_np(threshold),
        left=left,
        right=right,
        leaf_fixed=leaf_fixed.astype(np.int32),
        tree_class=tree_class,
        base_fixed=np.floor(model.base_ * scale).astype(np.int32),
        scale=scale,
        n_classes=model.n_classes_,
        max_depth=max(t.depth for t in trees),
    )


def predict_gbt_integer(packed: PackedGBT, X) -> np.ndarray:
    """Integer-only GBT inference (numpy reference): int32 compares + adds."""
    keys = float_to_key_np(np.asarray(X, np.float32))
    b = keys.shape[0]
    acc = np.tile(packed.base_fixed.astype(np.int64), (b, 1))
    for t in range(packed.feature.shape[0]):
        node = np.zeros(b, np.int32)
        for _ in range(packed.max_depth):
            f = packed.feature[t, node]
            thr = packed.threshold_key[t, node]
            xv = keys[np.arange(b), np.clip(f, 0, None)]
            nxt = np.where(xv <= thr, packed.left[t, node], packed.right[t, node])
            node = np.where(f < 0, node, nxt).astype(np.int32)
        acc[:, packed.tree_class[t]] += packed.leaf_fixed[t, node]
    assert np.abs(acc).max() < 2**31  # overflow-free by scale construction
    return acc.argmax(axis=1)
