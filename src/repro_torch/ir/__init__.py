"""ForestIR: the forest quantized once, and the layouts it materializes into.

``ForestIR`` (``forest_ir.py``) holds the canonical quantized forest; the
registry in ``layouts.py`` turns it into ``padded``, ``leaf_major`` and
``ragged`` artifacts.
"""
from repro_torch.ir.forest_ir import ForestIR, resolve_artifact
from repro_torch.ir.layouts import (
    RaggedEnsemble,
    available_layouts,
    materialize,
    register_layout,
)

__all__ = [
    "ForestIR",
    "RaggedEnsemble",
    "available_layouts",
    "materialize",
    "register_layout",
    "resolve_artifact",
]
