"""Torch oracle for the tree-traversal kernels.

Standalone (imports neither the kernels nor their plain versions) so tests
can hold both against an independent walk: one tree at a time, ``depth``
levels each, int64 accumulation masked to uint32.
"""
from __future__ import annotations

import torch


def tree_predict_integer_ref(x_keys, feature, threshold_key, left, right,
                             leaf_fixed, depth: int) -> torch.Tensor:
    """Integer-only ensemble inference.

    Args:
      x_keys: (B, F) int32 FlInt keys of the feature rows.
      feature: (T, N) int32, -1 on leaves.
      threshold_key: (T, N) int32.
      left/right: (T, N) int32 child indices (self on leaves).
      leaf_fixed: (T, N, C) uint32 fixed-point leaf probabilities.
      depth: walk length (>= max tree depth).

    Returns: (B, C) uint32 accumulated class scores.
    """
    b = x_keys.shape[0]
    rows = torch.arange(b, device=x_keys.device)
    leaf = leaf_fixed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    acc = torch.zeros((b, leaf.shape[-1]), dtype=torch.int64, device=x_keys.device)
    for t in range(feature.shape[0]):
        feat_t, key_t = feature[t].long(), threshold_key[t]
        left_t, right_t = left[t].long(), right[t].long()
        node = torch.zeros(b, dtype=torch.int64, device=x_keys.device)
        for _ in range(depth):
            xv = x_keys[rows, feat_t[node].clamp(min=0)]
            node = torch.where(xv <= key_t[node], left_t[node], right_t[node])
        acc += leaf[t][node]
    return (acc & 0xFFFFFFFF).to(torch.int32).view(torch.uint32)
