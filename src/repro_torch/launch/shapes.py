"""Assigned input-shape sets and per-cell applicability: the JAX package's
``launch/shapes.py``, pure data.

LM shapes are (seq_len, global_batch).  ``decode_*``/``long_*`` run
``serve_step`` (one token against a seq_len KV cache), not ``train_step``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}

# the paper's own architecture serves batched tabular rows
TREE_SHAPES = {
    "serve_1m": dict(rows=1_048_576, mode="trees"),
    "serve_64k": dict(rows=65_536, mode="trees"),
}


def cell_applicable(cfg: ModelConfig, shape_name: str):
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if cfg.family == "trees":
        return (shape_name in TREE_SHAPES), "tree arch uses TREE_SHAPES"
    if shape_name not in SHAPES:
        return False, f"unknown shape {shape_name}"
    mode = SHAPES[shape_name]["mode"]
    if mode == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no autoregressive step"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped per assignment"
    return True, ""


def applicable_shapes(cfg: ModelConfig):
    src = TREE_SHAPES if cfg.family == "trees" else SHAPES
    return [s for s in src if cell_applicable(cfg, s)[0]]
