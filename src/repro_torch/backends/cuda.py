"""CudaBackend: the hand-written CUDA tree walks behind the TreeBackend
protocol (the counterpart of the JAX package's ``pallas`` backend).

It copies the node tables to the card once, at construction, and packs the
node quads that the kernels read there once too (``pack_node_quads``), so
no request repacks them.  Per call ``backends.staging.partials`` moves the
rows over through pinned memory on the calling thread's own stream, keys
them (FlInt), launches K1, K2 or K3 through
``kernels.ops.tree_predict_integer`` and returns the uint32 partials to the
host, where the shared numpy finalize runs.  ``flint`` and ``integer``
accumulate the same partials and differ only in that finalize.  While a
``torch.profiler`` records, the four steps are the ranges
``backend.rows_in``, ``backend.keys``, ``backend.launch`` and
``backend.rows_out`` (``repro_torch.obs.profiled``).

``impl="auto"`` (the default) resolves per layout: the bounded walk (K1) on
scannable ``leaf_major`` tables, the gather walk (K2) on ``padded`` ones or
when the node order is not scannable.  Only an auto resolution switches to
K2 for batches under ``_SMALL_BATCH_GATHER_ROWS`` rows; a pinned impl is a
routing decision the caller owns (``impl="onehot"`` always launches K3).

Rows must carry at least the forest's ``n_features`` columns: the kernels
take the row stride from the rows, so fewer columns would read the next
row, and past the buffer at the last one.  The JAX package's Pallas path
clamps there instead; this backend raises ``ValueError`` on every device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.backends import staging
from repro_torch.backends.base import BackendCapabilities, TreeBackend, register_backend
from repro_torch.kernels.ops import resolve_impl, tree_predict_integer
from repro_torch.kernels.tree_traverse import pack_node_quads

_DEFAULT_BLOCK_B = 256  # the engine's row bucket; not the CTA size

# under auto, batches below this row count take the gather walk; both walks
# give identical partials, so the switch cannot change a bit
_SMALL_BATCH_GATHER_ROWS = 64


@register_backend
class CudaBackend(TreeBackend):
    name = "cuda"
    margins = True
    capabilities = BackendCapabilities(
        modes=("flint", "integer"),
        deterministic_modes=("flint", "integer"),
        preferred_block_rows=_DEFAULT_BLOCK_B,
        compiles_per_shape=True,
        supported_layouts=("leaf_major", "padded"),
        preferred_layout="leaf_major",
    )

    def __init__(self, packed, mode: str = "integer", *, device=None,
                 block_b: Optional[int] = None, block_t: Optional[int] = None,
                 impl: str = "auto"):
        super().__init__(packed, mode, device=device)
        scannable = getattr(packed, "internal_counts", None) is not None
        was_auto = impl == "auto"
        impl = resolve_impl(packed, impl)
        if impl == "leaf_major" and not (self.layout == "leaf_major" and scannable):
            raise ValueError(
                "impl='leaf_major' walks the leaf_major internal-node prefix; "
                f"this backend was materialized on the {self.layout!r} layout"
                + ("" if scannable else " without a scannable node order")
            )
        self.impl = impl
        self._auto_small_batch = impl == "leaf_major" and was_auto
        self._blocks = dict(block_b=block_b, block_t=block_t)
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self._tables = (as_t(packed.feature), as_t(packed.threshold_key),
                        as_t(packed.left), as_t(packed.right),
                        as_t(packed.leaf_fixed.view(np.int32)))
        self._internal_counts = (as_t(packed.internal_counts.astype(np.int32))
                                 if scannable else None)
        self._quads = pack_node_quads(*self._tables[:4])
        staging.tables_ready(self.device)

    def predict_partials(self, X):
        return staging.partials(X, self.packed.n_features, self.device, self._launch)

    def _launch(self, keys):
        impl = self.impl
        if self._auto_small_batch and len(keys) < _SMALL_BATCH_GATHER_ROWS:
            impl = "gather"
        return tree_predict_integer(
            keys, *self._tables, depth=self.packed.max_depth,
            impl=impl, device=self.device,
            internal_counts=self._internal_counts if impl == "leaf_major" else None,
            quads=self._quads, **self._blocks)
