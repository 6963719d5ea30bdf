"""ForestIR: the forest quantized once, and the layouts it materializes into.

``ForestIR`` (``forest_ir.py``) holds the canonical quantized forest; the
registry in ``layouts.py`` turns it into ``padded``, ``leaf_major`` and
``ragged`` artifacts, and ``bitvector.py`` into the QuickScorer
``bitvector`` tables.
"""
from repro_torch.ir.forest_ir import ForestIR, resolve_artifact
from repro_torch.ir.layouts import (
    RaggedEnsemble,
    available_layouts,
    materialize,
    register_layout,
)
from repro_torch.ir.bitvector import BitvectorEnsemble  # registers "bitvector"

__all__ = [
    "BitvectorEnsemble",
    "ForestIR",
    "RaggedEnsemble",
    "available_layouts",
    "materialize",
    "register_layout",
    "resolve_artifact",
]
