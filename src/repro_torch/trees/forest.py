"""Random forest / extra-trees training on top of the histogram CART trainer.

Inference semantics mirror sklearn's soft voting: each tree emits a class
distribution, the ensemble averages them (paper Sec. II-A).  That average is
exactly what InTreeger converts to fixed point at codegen time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.trees.cart import TreeArrays, _quantile_bins, train_tree


@dataclass
class RandomForestClassifier:
    n_estimators: int = 10
    max_depth: int = 6
    min_samples_leaf: int = 1
    min_samples_split: int = 2
    max_features: Optional[str] = "sqrt"  # "sqrt" | None (all)
    bootstrap: bool = True
    extra_random: bool = False  # True -> ExtraTrees-style random splits
    n_bins: int = 64
    seed: int = 0

    trees_: List[TreeArrays] = field(default_factory=list)
    n_classes_: int = 0
    n_features_: int = 0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestClassifier":
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        classes = np.unique(y)
        self.n_classes_ = int(classes.max()) + 1
        self.n_features_ = X.shape[1]
        rng = np.random.default_rng(self.seed)
        binned = _quantile_bins(X, self.n_bins, rng)
        if self.max_features == "sqrt":
            mf = max(1, int(np.sqrt(X.shape[1])))
        else:
            mf = None
        self.trees_ = []
        n = X.shape[0]
        for _ in range(self.n_estimators):
            if self.bootstrap:
                idx = rng.integers(0, n, size=n)
            else:
                idx = np.arange(n)
            codes, edges = binned
            tree = train_tree(
                X[idx],
                y[idx],
                self.n_classes_,
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                min_samples_split=self.min_samples_split,
                max_features=mf,
                n_bins=self.n_bins,
                extra_random=self.extra_random,
                rng=rng,
                _binned=(codes[idx], edges),
            )
            self.trees_.append(tree)
        return self

    # float64 oracle — the "standard floating-point implementation" baseline
    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        acc = np.zeros((X.shape[0], self.n_classes_), np.float64)
        for t in self.trees_:
            acc += t.predict_proba(X)
        return acc / len(self.trees_)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.predict_proba(X).argmax(axis=1)

    @property
    def max_tree_depth(self) -> int:
        return max(t.depth for t in self.trees_)
