"""FlInt: order-preserving float32 <-> int32 key transform (paper Sec. II-D).

Every float threshold compare ``x <= t`` becomes an int32 compare of keys:

    b   = bitcast_int32(f)
    key = b               if b >= 0          (positive floats, +0)
          INT32_MIN - b   otherwise          (negative floats, -0)

For negative ``b`` the difference ``INT32_MIN - b`` lies in
``[INT32_MIN + 1, 0]``, so the int32 arithmetic cannot overflow.  The torch
functions bitcast with ``Tensor.view`` (a reinterpretation, so NaN payloads
survive) and run on any device; the numpy twins run at packing time.
"""
from __future__ import annotations

import numpy as np
import torch

_INT32_MIN = -2147483648
# numpy scalars, so the numpy twin's operators skip converting Python ints
_SIGN_SHIFT = np.int32(31)
_MAGNITUDE = np.int32(0x7FFFFFFF)


def float_to_key(f: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> order-preserving int32 keys, on ``f``'s device."""
    b = f.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b < 0, _INT32_MIN - b, b)


def key_to_float(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_to_key`; key(-0.0) inverts to +0.0."""
    k = k.to(torch.int32)
    return torch.where(k < 0, _INT32_MIN - k, k).contiguous().view(torch.float32)


def float_to_key_np(f: np.ndarray) -> np.ndarray:
    """float32 array -> order-preserving int32 keys, in int32 arithmetic.

    Branch-free: with ``s = b >> 31`` (-1 for negative ``b``, else 0) and
    ``m = b & 0x7FFFFFFF``, ``(m ^ s) - s`` is ``b`` for ``b >= 0`` and
    ``-m == INT32_MIN - b`` otherwise; no step can overflow.
    """
    b = np.asarray(f, np.float32).view(np.int32)
    sign = b >> _SIGN_SHIFT
    key = b & _MAGNITUDE
    key ^= sign
    key -= sign
    return key


def key_to_float_np(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k, np.int32)
    b = np.where(k < 0, (np.int64(_INT32_MIN) - k.astype(np.int64)).astype(np.int32), k)
    return b.view(np.float32)
