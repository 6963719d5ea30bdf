"""BitvectorBackend: QuickScorer scoring, traversal-free, through K5.

The counterpart of the JAX package's ``bitvector`` backend, and the consumer
of the ``bitvector`` ForestIR layout (``repro_torch.ir.bitvector``): no walk
at all.  Every internal-node test of a tree is compared, the false nodes'
masks fold into a live-leaf bitvector, and each tree's exit leaf is its
lowest surviving bit (see ``kernels/bitvector.py``).

It packs the slot grid of ``bitvector_device_arrays`` once, at
construction, into the records K5 reads (``pack_bitvector_tables``: one
16-byte record per nonzero mask word), and copies them to its device.  Per
call it moves the rows over, keys them (FlInt) and runs
``kernels.bitvector.tree_bitvector``: K5 on the card, the plain version on
the dense grid the tables keep with ``device="cpu"``.  The partials are the exact
uint32 accumulators of every other backend, so ``flint`` and ``integer``
differ only in the shared numpy finalize, and every plan can shard it.
While a ``torch.profiler`` records, the steps are the ranges of the ``cuda``
backend: ``backend.rows_in``, ``backend.keys``, ``backend.launch`` and
``backend.rows_out``.

Rows must carry at least the forest's ``n_features`` columns, as for the
``cuda`` backend: K5 takes the row stride from the rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backends.base import BackendCapabilities, TreeBackend, register_backend
from repro_torch.core.ensemble import u32_numpy
from repro_torch.core.flint import float_to_key
from repro_torch.kernels.bitvector import (
    bitvector_device_arrays,
    pack_bitvector_tables,
    tree_bitvector,
)
from repro_torch.obs import profiled


@register_backend
class BitvectorBackend(TreeBackend):
    name = "bitvector"
    margins = True
    capabilities = BackendCapabilities(
        modes=("flint", "integer"),
        deterministic_modes=("flint", "integer"),
        preferred_block_rows=None,
        compiles_per_shape=True,
        supported_layouts=("bitvector",),
        preferred_layout="bitvector",
    )

    def __init__(self, packed, mode: str = "integer", *, device=None):
        super().__init__(packed, mode, device=device)
        arrays = bitvector_device_arrays(packed, "cpu")
        self.n_entry_slots = arrays.pop("n_entry_slots")
        self._tables = pack_bitvector_tables(*(arrays[k] for k in (
            "entry_feat", "entry_key", "inv_mask", "init_mask", "leaf_off",
            "leaf_fixed")), device=self.device)

    def predict_partials(self, X):
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] < self.packed.n_features:
            raise ValueError(
                f"rows of shape {X.shape} have fewer columns than the "
                f"{self.packed.n_features} features the forest reads")
        with profiled("backend.rows_in"):
            x = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(self.device)
        with profiled("backend.keys"):
            keys = float_to_key(x)
        with profiled("backend.launch"):
            acc = tree_bitvector(keys, self._tables)
        with profiled("backend.rows_out"):
            return u32_numpy(acc)
