"""Numerics of the paper's integer-only inference, ported to PyTorch.

  flint.py      - order-preserving float32 <-> int32 key transform
  fixedpoint.py - 2^32/n fixed-point probability conversion
  packing.py    - the padded node-table artifact (``PackedEnsemble``)
  ensemble.py   - mode specs, the numpy finalize, the torch reference walk
  serving.py    - the one-device tree serving step (reference walk + argmax)
"""
from repro_torch.core.ensemble import (
    MODES,
    ModeSpec,
    finalize_partials,
    flint_recip,
    mode_spec,
)
from repro_torch.core.fixedpoint import fixed_to_prob, max_abs_error, prob_to_fixed_np, scale_for
from repro_torch.core.flint import float_to_key, float_to_key_np, key_to_float, key_to_float_np
from repro_torch.core.packing import PackedEnsemble, pack_forest

__all__ = [
    "MODES",
    "ModeSpec",
    "finalize_partials",
    "flint_recip",
    "mode_spec",
    "fixed_to_prob",
    "max_abs_error",
    "prob_to_fixed_np",
    "scale_for",
    "float_to_key",
    "float_to_key_np",
    "key_to_float",
    "key_to_float_np",
    "PackedEnsemble",
    "pack_forest",
]
