"""Synthetic tabular datasets shaped like the paper's two benchmarks.

The container is offline, so we generate datasets with the same shape/class
structure as the paper's (Sec. IV-A):
  * Statlog (Shuttle):  58,000 x 7, 7 classes, heavily imbalanced
    (~80% of rows in one class, two classes nearly absent),
  * ESA Anomaly (first 3 months): 262,081 x 87, binary, rare positives.

Both are Gaussian-mixture generators with class-dependent informative
features, deterministic under a seed.
"""
from __future__ import annotations

import numpy as np


def make_shuttle_like(n: int = 58000, n_features: int = 7, n_classes: int = 7, seed: int = 0):
    rng = np.random.default_rng(seed)
    # Shuttle-like imbalance: class 0 dominates.
    weights = np.array([0.786, 0.1, 0.06, 0.03, 0.015, 0.006, 0.003])
    weights = weights[:n_classes] / weights[:n_classes].sum()
    y = rng.choice(n_classes, size=n, p=weights)
    centers = rng.normal(0, 3.0, size=(n_classes, n_features))
    scales = rng.uniform(0.5, 1.5, size=(n_classes, n_features))
    X = centers[y] + rng.normal(size=(n, n_features)) * scales[y]
    # shuttle features are small-magnitude integers; keep a similar flavor
    X = np.round(X * 8).astype(np.float32) / 2.0
    return X.astype(np.float32), y.astype(np.int64)


def make_esa_like(n: int = 262081, n_features: int = 87, seed: int = 0, anomaly_rate: float = 0.04):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < anomaly_rate).astype(np.int64)
    X = rng.normal(size=(n, n_features)).astype(np.float32)
    # anomalies shift a random subset of channels (telemetry-like)
    n_info = max(4, n_features // 8)
    info = rng.choice(n_features, n_info, replace=False)
    shift = rng.uniform(1.5, 3.5, size=n_info).astype(np.float32)
    X[np.ix_(y == 1, info)] += shift
    return X, y


def train_test_split(X, y, test_frac: float = 0.25, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    k = int(n * (1 - test_frac))
    tr, te = perm[:k], perm[k:]
    return X[tr], y[tr], X[te], y[te]
