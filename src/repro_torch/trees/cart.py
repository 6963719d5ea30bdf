"""A trained tree as flat arrays, the input of ``ForestIR.from_forest``.

This package holds the container only; training is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TreeArrays:
    """A tree as flat arrays (node 0 is the root).

    Internal nodes: ``feature >= 0`` and the decision is
    ``x[feature] <= threshold -> left`` (paper Listing 2 semantics).
    Leaves: ``feature == -1`` and ``left == right == self`` (self-loop), with
    ``leaf_probs`` the class distribution.
    """

    feature: np.ndarray  # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray  # (n_nodes,) float32
    left: np.ndarray  # (n_nodes,) int32
    right: np.ndarray  # (n_nodes,) int32
    leaf_probs: np.ndarray  # (n_nodes, n_classes) float64
    depth: int

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])
