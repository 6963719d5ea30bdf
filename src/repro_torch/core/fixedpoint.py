"""Fixed-point probability conversion (paper Sec. III-A).

Leaf probabilities ``p in [0, 1]`` become uint32 at scale
``floor((2**32 - 1) / n_trees)``, so the sum of ``n`` per-tree addends never
overflows uint32.  For ``n == 1`` the scale is ``2**32 - 1``: a single-tree
forest has partials at or above ``2**31``, which an int32 view misorders.
"""
from __future__ import annotations

import numpy as np
import torch

FIXED_BITS = 32
_FULL = (1 << FIXED_BITS) - 1  # 2**32 - 1


def scale_for(n_trees: int) -> int:
    """Overflow-free per-tree scale (paper: 2**32/n; ours: floor((2**32-1)/n))."""
    if n_trees < 1:
        raise ValueError("n_trees must be >= 1")
    return _FULL // int(n_trees)


def prob_to_fixed_np(p: np.ndarray, n_trees: int) -> np.ndarray:
    """floor(p * scale) as uint32, computed in float64 at packing time."""
    p64 = np.asarray(p, np.float64)
    if np.any(p64 < 0) or np.any(p64 > 1):
        raise ValueError("probabilities must lie in [0, 1]")
    return np.floor(p64 * scale_for(n_trees)).astype(np.uint32)


def fixed_to_prob_np(acc: np.ndarray, n_trees: int) -> np.ndarray:
    """Interpret an accumulated uint32 at the ensemble scale -> float64 prob."""
    return np.asarray(acc, np.uint64).astype(np.float64) / (
        scale_for(n_trees) * float(n_trees)
    )


def max_abs_error(n_trees: int) -> float:
    """Worst-case |reconstructed - exact average| over an n-tree ensemble."""
    s = scale_for(n_trees)
    return (n_trees + 1.0) / (s * n_trees)


def fixed_to_prob(acc: torch.Tensor, n_trees: int) -> torch.Tensor:
    """uint32 accumulators (held as uint32 or as their int32 bit pattern)
    -> float32 probabilities, split into 16-bit halves as the reference does
    so the conversion keeps its precision without float64."""
    acc = acc.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = (acc >> 16).to(torch.float32) * float(1 << 16)
    lo = (acc & 0xFFFF).to(torch.float32)
    denom = float(scale_for(n_trees)) * float(n_trees)
    return (hi + lo) / denom
