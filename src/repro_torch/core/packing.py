"""The padded node-table artifact (the IR's ``padded``/``leaf_major`` layouts).

``PackedEnsemble`` is one materialization of :class:`repro_torch.ir.ForestIR`:
dense ``(T, N)`` numpy tables, every tree padded to the max node count with
self-looping zero-mass leaves.  It carries the quantized arrays verbatim
(FlInt ``threshold_key``, uint32 ``leaf_fixed``); the backends copy them to
the device once, at construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.fixedpoint import scale_for


@dataclass
class PackedEnsemble:
    feature: np.ndarray  # (T, N) int32, -1 for leaf
    threshold: np.ndarray  # (T, N) float32
    threshold_key: np.ndarray  # (T, N) int32 (FlInt keys)
    left: np.ndarray  # (T, N) int32
    right: np.ndarray  # (T, N) int32
    leaf_probs: np.ndarray  # (T, N, C) float32 (zeros on internal/pad nodes)
    leaf_fixed: np.ndarray  # (T, N, C) uint32
    n_trees: int
    n_classes: int
    n_features: int
    max_depth: int  # walk length that guarantees leaf arrival
    layout: str = "padded"
    # sub-forest artifacts (ForestIR.subset): the parent ensemble's scale
    quant_scale: Optional[int] = field(default=None, repr=False)
    node_counts: Optional[np.ndarray] = field(default=None, repr=False)
    # leaf_major only: per-tree internal-node counts (T,), or None when the
    # node order is not scannable (a child sits before its parent)
    internal_counts: Optional[np.ndarray] = field(default=None, repr=False)
    ir: Optional[object] = field(default=None, repr=False, compare=False)

    @property
    def scale(self) -> int:
        return self.quant_scale if self.quant_scale is not None \
            else scale_for(self.n_trees)

    def to_ir(self):
        """The canonical IR behind these tables (recovered if not attached)."""
        if self.ir is None:
            from repro_torch.ir.forest_ir import ForestIR

            self.ir = ForestIR.from_packed(self)
        return self.ir

    def nbytes_integer(self) -> int:
        """Bytes of the integer-only deployment artifact in this layout."""
        return (
            self.feature.nbytes
            + self.threshold_key.nbytes
            + self.left.nbytes
            + self.right.nbytes
            + self.leaf_fixed.nbytes
        )

    def nbytes_float(self) -> int:
        """Bytes of the float deployment artifact in this layout."""
        return (
            self.feature.nbytes
            + self.threshold.nbytes
            + self.left.nbytes
            + self.right.nbytes
            + self.leaf_probs.nbytes
        )


def pack_forest(forest) -> PackedEnsemble:
    """Quantize ``forest`` into the IR and materialize the padded layout."""
    from repro_torch.ir.forest_ir import ForestIR

    return ForestIR.from_forest(forest).materialize("padded")
