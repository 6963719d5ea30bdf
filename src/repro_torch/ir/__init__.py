"""ForestIR: the forest quantized once, and the layouts it materializes into.

``ForestIR`` (``forest_ir.py``) holds the canonical quantized forest; the
registry in ``layouts.py`` turns it into ``padded``, ``leaf_major`` and
``ragged`` artifacts, ``bitvector.py`` into the QuickScorer
``bitvector`` tables and ``packed_leaf.py`` into the group-coded
``packed_leaf`` payload.  ``artifact.py`` writes and maps the ITRF binary
artifact (``ir.to_itrf(path)``, ``ForestIR.from_itrf(path, mmap=True)``).
"""
from repro_torch.ir.forest_ir import ForestIR, resolve_artifact
from repro_torch.ir.layouts import (
    RaggedEnsemble,
    available_layouts,
    materialize,
    register_layout,
)
from repro_torch.ir.bitvector import BitvectorEnsemble  # registers "bitvector"
from repro_torch.ir.packed_leaf import PackedLeafEnsemble  # registers "packed_leaf"

__all__ = [
    "BitvectorEnsemble",
    "ForestIR",
    "PackedLeafEnsemble",
    "RaggedEnsemble",
    "available_layouts",
    "materialize",
    "register_layout",
    "resolve_artifact",
]
