"""The seeded forest of one configuration, as plain numpy arrays.

A copy of ``chip_smoke.py::complete_tree``, kept here so that no change to the
program moves the yardstick: complete trees of ``depth`` levels in BFS order
(children 2i+1 and 2i+2, leaves self-looping), each split on a random feature
at a random quantile in [0.2, 0.8) of the sample rows that reach it, so both
branches are taken all the way down, and each leaf a Dirichlet(0.5) class
distribution.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the streams one seed feeds: the forest, the traffic's rows, its schedule
FOREST_STREAM, ROWS_STREAM, SCHEDULE_STREAM = 0, 1, 2


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any non-negative seed,
    however large, is taken whole."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.random.default_rng([int(seed), stream])


@dataclass
class Forest:
    """``feature`` (T, N) int32, -1 at leaves; ``threshold`` (T, N) float32;
    ``left``/``right`` (T, N) int32; ``leaf_probs`` (T, N, C) float64, zero at
    internal nodes; every tree complete, of ``depth`` levels."""

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_probs: np.ndarray
    depth: int
    n_features: int

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def n_classes(self) -> int:
        return self.leaf_probs.shape[-1]


def complete_tree(rng, sample, depth: int, n_features: int, n_classes: int) -> tuple:
    """One complete tree: (feature, threshold, left, right, leaf_probs)."""
    n_int = 2 ** depth - 1
    n = 2 ** (depth + 1) - 1
    feature = np.full(n, -1, np.int32)
    threshold = np.zeros(n, np.float32)
    left = np.arange(n, dtype=np.int32)
    right = left.copy()
    left[:n_int] = 2 * np.arange(n_int) + 1
    right[:n_int] = 2 * np.arange(n_int) + 2
    feature[:n_int] = rng.integers(0, n_features, n_int)
    rows = np.arange(len(sample))
    node = np.zeros(len(sample), np.int64)
    for level in range(depth):
        lo, hi = 2 ** level - 1, 2 ** (level + 1) - 1
        vals = sample[rows, feature[node]]
        order = np.lexsort((vals, node))
        counts = np.bincount(node - lo, minlength=hi - lo)
        starts = np.cumsum(counts) - counts
        pick = starts + np.floor(rng.uniform(0.2, 0.8, hi - lo) * counts).astype(np.int64)
        chosen = vals[order][np.minimum(pick, len(vals) - 1)]
        # a node no sample row reaches takes some row's value of its feature
        fallback = sample[rng.integers(0, len(sample), hi - lo), feature[lo:hi]]
        threshold[lo:hi] = np.where(counts > 0, chosen, fallback)
        node = np.where(vals <= threshold[node], left[node], right[node])
    probs = np.zeros((n, n_classes), np.float64)
    probs[n_int:] = rng.dirichlet(np.full(n_classes, 0.5), n - n_int)
    return feature, threshold, left, right, probs


def make_forest(cfg: dict, seed: int) -> Forest:
    """The configuration's forest from ``seed``: thresholds from
    ``threshold_sample_rows`` rows drawn N(0, 1), as the traffic's rows are."""
    rng = rng_for(seed, FOREST_STREAM)
    f, c = cfg["n_features"], cfg["n_classes"]
    sample = rng.standard_normal((cfg["threshold_sample_rows"], f), dtype=np.float32)
    trees = [complete_tree(rng, sample, cfg["depth"], f, c) for _ in range(cfg["n_trees"])]
    feature, threshold, left, right, probs = (np.stack(a) for a in zip(*trees))
    return Forest(feature=feature, threshold=threshold, left=left, right=right,
                  leaf_probs=probs, depth=cfg["depth"], n_features=f)
