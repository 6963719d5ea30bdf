"""The tree-ensemble serving step on one device.

The counterpart of the JAX package's ``core/serving.py`` on one card: its
local path (``_local_predict``), the same math as ``kernels.ref`` plus an
argmax.  The reference's ``shard_map`` over a device mesh (rows sharded over
every mesh axis, tables replicated) needs several cards and is not here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import tree_predict_integer_ref

_TABLES = ("feature", "threshold_key", "left", "right", "leaf_fixed")


def _on(a, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


def tree_serve_step(tables: dict, x_keys, depth: int, *, device=None):
    """tables: feature/threshold_key/left/right (T,N) + leaf_fixed (T,N,C),
    numpy arrays or tensors.  x_keys: (B, F) int32 FlInt keys.  Runs on
    ``device`` (``cuda`` unless the caller passes another).  Returns
    (scores (B,C) uint32, preds (B,) int32) on that device; the argmax takes
    the first of equal scores, over the uint32 values."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    acc = tree_predict_integer_ref(_on(x_keys, dev), *(_on(tables[k], dev) for k in _TABLES),
                                   depth)
    wide = acc.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return acc, torch.argmax(wide, dim=1).to(torch.int32)
