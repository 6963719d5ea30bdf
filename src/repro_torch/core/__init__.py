"""Numerics of the paper's integer-only inference, ported to PyTorch.

  flint.py      - order-preserving float32 <-> int32 key transform
  fixedpoint.py - 2^32/n fixed-point probability conversion
  packing.py    - the padded node-table artifact (``PackedEnsemble``)
  ensemble.py   - mode specs, the numpy finalize, the torch reference walk and
                  the per-mode predict helpers
  serving.py    - the one-device tree serving step (reference walk + argmax)
"""
from repro_torch.core.ensemble import (
    MODES,
    ModeSpec,
    ensemble_device_arrays,
    finalize_partials,
    flint_recip,
    integer_probs,
    make_partials_fn,
    make_predict_fn,
    mode_spec,
    predict_flint,
    predict_float,
    predict_integer,
    predict_mode,
    predict_partials_mode,
)
from repro_torch.core.fixedpoint import fixed_to_prob, max_abs_error, prob_to_fixed_np, scale_for
from repro_torch.core.flint import float_to_key, float_to_key_np, key_to_float, key_to_float_np
from repro_torch.core.packing import PackedEnsemble, pack_forest

__all__ = [
    "MODES",
    "ModeSpec",
    "ensemble_device_arrays",
    "finalize_partials",
    "flint_recip",
    "integer_probs",
    "make_partials_fn",
    "make_predict_fn",
    "mode_spec",
    "predict_mode",
    "predict_partials_mode",
    "predict_flint",
    "predict_float",
    "predict_integer",
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
