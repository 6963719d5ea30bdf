"""Gradient compression for slow cross-host links: the PyTorch counterpart
of the JAX package's ``train/compression.py``.

int8 per-tensor quantization with error feedback (the residual is carried
between steps).  ``torch.round`` rounds half to even, as ``jnp.round`` does,
so the int8 codes, scales and residuals are the reference's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import tree_map


def quantize_int8(x):
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_tree_with_feedback(grads, residual):
    """Returns (quantized_tree, scales_tree, new_residual)."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)

    def one(g, r):
        corrected = g.float() + r
        q, s = quantize_int8(corrected)
        return q, s, corrected - dequantize_int8(q, s)

    out = tree_map(one, grads, residual)
    pick = lambda i: tree_map(lambda g, o: o[i], grads, out)
    return pick(0), pick(1), pick(2)
