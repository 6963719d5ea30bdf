"""The tree-ensemble serving step (the paper's arch at pod scale).

The counterpart of the JAX package's ``core/serving.py``: the same math as
``kernels.ref`` plus an argmax (``_local_predict``).  Batched tree
inference is row-parallel, so under a mesh every rank walks its own block
of rows, split over every mesh axis, against the whole (replicated) tables:
all compute is local, and the step runs no collective.
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


def _local_predict(tables: dict, x_keys, depth: int):
    acc = tree_predict_integer_ref(x_keys, *(tables[k] for k in _TABLES), depth)
    wide = acc.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return acc, torch.argmax(wide, dim=1).to(torch.int32)


def tree_serve_step(tables: dict, x_keys, depth: int, *, device=None):
    """tables: feature/threshold_key/left/right (T,N) + leaf_fixed (T,N,C),
    numpy arrays or tensors.  x_keys: (B, F) int32 FlInt keys, or a
    ``DTensor`` of them already split by rows.  Runs on ``device`` (``cuda``
    unless the caller passes another).  Returns (scores (B,C) uint32, preds
    (B,) int32) on that device; the argmax takes the first of equal scores,
    over the uint32 values.

    Inside a ``use_mesh`` context the rows are split over every mesh axis
    and both results are ``DTensor``s of this rank's rows (no collective;
    ``sharding.ops.gather`` makes them whole); otherwise the step runs
    locally and returns plain tensors.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.device import resolve_device
    from repro_torch.sharding.ops import P, current_mesh, shard_map

    dev = resolve_device(device)
    tables = {k: _on(tables[k], dev) for k in _TABLES}
    if not isinstance(x_keys, DTensor):
        x_keys = _on(x_keys, dev)
    mesh = current_mesh()
    if mesh is None:
        return _local_predict(tables, x_keys, depth)
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    fn = shard_map(lambda t, x: _local_predict(t, x, depth), mesh=mesh,
                   in_specs=(P(), P(axes, None)), out_specs=(P(axes, None), P(axes)))
    return fn(tables, x_keys)
