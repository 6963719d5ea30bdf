"""BitvectorBackend: QuickScorer scoring, traversal-free, through K5.

The counterpart of the JAX package's ``bitvector`` backend, and the consumer
of the ``bitvector`` ForestIR layout (``repro_torch.ir.bitvector``): no walk
at all.  Every internal-node test of a tree is compared, the false nodes'
masks fold into a live-leaf bitvector, and each tree's exit leaf is its
lowest surviving bit (see ``kernels/bitvector.py``).

It packs the slot grid of ``bitvector_device_arrays`` once, at
construction, into the records K5 reads (``pack_bitvector_tables``: one
16-byte record per nonzero mask word), and copies them to its device.  Per
call ``backends.staging.partials`` moves the rows over (through pinned memory
on the calling thread's own stream on the card), keys them (FlInt) and runs
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

from repro_torch.backends import staging
from repro_torch.backends.base import BackendCapabilities, TreeBackend, register_backend
from repro_torch.kernels.bitvector import (
    bitvector_device_arrays,
    pack_bitvector_tables,
    tree_bitvector,
)


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
        staging.tables_ready(self.device)

    def predict_partials(self, X):
        return staging.partials(X, self.packed.n_features, self.device, self._launch)

    def _launch(self, keys):
        return tree_bitvector(keys, self._tables)
