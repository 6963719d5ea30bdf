"""ReferenceBackend: the torch node-table walk, the semantic oracle.

All three modes; deterministic modes run through the partials/finalize
split, float mode adds trees in tree order and finalizes in numpy.  The
``packed_leaf`` layout is served by walking the dense tables its exact leaf
codec decodes to (deterministic modes only: its payload is fixed point).
"""
from __future__ import annotations

from repro_torch.backends.base import BackendCapabilities, TreeBackend, register_backend
from repro_torch.core.ensemble import (
    MODES,
    ensemble_device_arrays,
    predict_mode,
    predict_partials_mode,
    u32_numpy,
)


@register_backend
class ReferenceBackend(TreeBackend):
    name = "reference"
    margins = True
    capabilities = BackendCapabilities(
        modes=MODES,
        deterministic_modes=("flint", "integer"),
        preferred_block_rows=None,
        compiles_per_shape=True,
        # the walk gathers by node index, so node order cannot change scores;
        # packed_leaf is walked as the padded tables its payload decodes to
        supported_layouts=("padded", "leaf_major", "packed_leaf"),
        preferred_layout="padded",
    )

    def __init__(self, packed, mode: str = "integer", *, device=None):
        super().__init__(packed, mode, device=device)
        self._walk = packed
        if getattr(packed, "layout", "padded") == "packed_leaf":
            if not self.deterministic:
                raise ValueError(
                    "layout 'packed_leaf' stores fixed-point leaves only; "
                    "serve it in a deterministic mode (flint/integer)"
                )
            self._walk = packed.decoded_tables()
        self._arrays = ensemble_device_arrays(self._walk, mode, self.device)

    def predict_partials(self, X):
        if not self.deterministic:
            return super().predict_partials(X)  # raises with the shared message
        return u32_numpy(predict_partials_mode(
            self._walk, X, self.mode, device=self.device, arrays=self._arrays))

    def predict_scores(self, X):
        if self.deterministic:
            return super().predict_scores(X)
        return predict_mode(self._walk, X, self.mode, device=self.device,
                            arrays=self._arrays)
