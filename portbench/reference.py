"""The plain reference that decides ``correct``.

It works out again, from the benchmark's own forest arrays and rows, what the
port's set-up derives and its timed path computes (InTreeger, arXiv:2505.15391
Sec. II-D and III-A):

- FlInt keys: each float32 as its int32 bits where they are non-negative, and
  ``INT32_MIN - bits`` where they are negative, so ``x <= t`` is ``key(x) <=
  key(t)``;
- fixed-point leaves: ``floor(p * scale)`` in float64 as uint32, with
  ``scale = floor((2**32 - 1) / n_trees)``;
- the walk: ``depth`` levels of ``key(x[feature]) <= key(threshold)``, left or
  right, leaves self-looping;
- the uint32 sum of every tree's leaf, and the finalize of the ``integer``
  mode: the sums are the scores, the prediction their first largest class.

Plain PyTorch operations that run on the card or the CPU; it imports nothing of
the program.  ``rows_dtype=torch.bfloat16`` rounds the rows to bfloat16 first:
that is the control, the reference in a lower precision than float32 rows.
"""
from __future__ import annotations

import numpy as np
import torch

INT32_MIN = -(2 ** 31)
FULL = 2 ** 32 - 1


def keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 keys of float32 values."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, INT32_MIN - bits, bits)


def fixed_leaves(leaf_probs: np.ndarray) -> np.ndarray:
    """(T, N, C) probabilities -> uint32 fixed point at the overflow-free scale."""
    scale = FULL // leaf_probs.shape[0]
    return np.floor(np.asarray(leaf_probs, np.float64) * scale).astype(np.uint32)


class Reference:
    """The forest's tables on ``device``, ready to score blocks of rows."""

    def __init__(self, forest, device, rows_dtype=torch.float32):
        as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
        t, n = forest.feature.shape
        self.device = torch.device(device)
        self.depth = forest.depth
        self.n_nodes = n
        self.rows_dtype = rows_dtype
        self.feature = as_t(np.maximum(forest.feature, 0), torch.int64)
        self.threshold = keys(as_t(forest.threshold, torch.float32))
        self.left = as_t(forest.left, torch.int64)
        self.right = as_t(forest.right, torch.int64)
        # int64 holds every uint32 addend and the sum of T of them exactly
        self.leaf = as_t(fixed_leaves(forest.leaf_probs).astype(np.int64), torch.int64)
        self.base = (torch.arange(t, device=self.device) * n)[:, None]

    def partials(self, x: np.ndarray) -> np.ndarray:
        """(B, F) float32 rows -> (B, C) uint32 sums."""
        xt = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=self.device)
        xk = keys(xt.to(self.rows_dtype).to(torch.float32)).t().contiguous()  # (F, B)
        b = xk.shape[1]
        t = self.feature.shape[0]
        node = torch.zeros((t, b), dtype=torch.int64, device=self.device)
        feature, threshold = self.feature.flatten(), self.threshold.flatten()
        left, right = self.left.flatten(), self.right.flatten()
        cols = torch.arange(b, device=self.device)[None, :]
        for _ in range(self.depth):
            flat = self.base + node
            go_left = xk[feature[flat], cols] <= threshold[flat]
            node = torch.where(go_left, left[flat], right[flat])
        leaf = self.leaf.flatten(0, 1)  # (T * N, C)
        flat = self.base + node
        acc = torch.zeros((b, leaf.shape[-1]), dtype=torch.int64, device=self.device)
        for lo in range(0, t, 64):  # 64 trees at a time bound the gathered block
            acc += leaf[flat[lo:lo + 64].flatten()].view(-1, b, leaf.shape[-1]).sum(dim=0)
        return (acc & FULL).cpu().numpy().astype(np.uint32)

    def scores(self, x: np.ndarray, block_rows: int = 65536) -> tuple:
        """(scores (B, C) uint32, preds (B,) int32), in blocks of rows."""
        parts = [self.partials(x[i:i + block_rows]) for i in range(0, len(x), block_rows)]
        acc = np.concatenate(parts) if parts else np.zeros((0, self.leaf.shape[-1]), np.uint32)
        return acc, np.argmax(acc, axis=1).astype(np.int32)
