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


def float_to_key(f: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> order-preserving int32 keys, on ``f``'s device."""
    b = f.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b < 0, _INT32_MIN - b, b)


def key_to_float(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_to_key`; key(-0.0) inverts to +0.0."""
    k = k.to(torch.int32)
    return torch.where(k < 0, _INT32_MIN - k, k).contiguous().view(torch.float32)


def float_to_key_np(f: np.ndarray) -> np.ndarray:
    b = np.asarray(f, np.float32).view(np.int32)
    neg = (np.int64(_INT32_MIN) - b.astype(np.int64)).astype(np.int32)
    return np.where(b < 0, neg, b)


def key_to_float_np(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k, np.int32)
    b = np.where(k < 0, (np.int64(_INT32_MIN) - k.astype(np.int64)).astype(np.int32), k)
    return b.view(np.float32)
