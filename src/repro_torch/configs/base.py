"""Model configuration schema + registry of the assigned architectures.

Each assigned architecture lives in ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (the exact published shape) and ``SMOKE`` (a reduced same-family
config for CPU smoke tests).  ``get_config(name)`` resolves either.  The
configurations are the JAX package's, field for field (a copy: its
``configs/base.py`` imports its model code).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | trees
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25  # E/k makes dispatch provably dropless
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # attention pattern
    sliding_window: int = 0  # 0 = full attention
    global_every: int = 0  # gemma3: 1 global layer per N (others local)
    # hybrid (zamba2): shared attention block applied every k mamba blocks,
    # alternating between `hybrid_shared_sets` parameter sets
    hybrid_attn_every: int = 0
    hybrid_shared_sets: int = 2
    encoder_only: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    frontend: str = "none"  # none | audio_stub | vision_stub
    frontend_dim: int = 0  # stub embedding dim fed to the projector
    vision_patches: int = 576  # vlm: patch tokens prepended to the sequence
    act: str = "silu"
    norm_eps: float = 1e-6
    # training
    microbatches: int = 1  # gradient accumulation (activation-memory control)
    # trees family (the paper's own architecture)
    n_trees: int = 0
    tree_depth: int = 0
    n_tab_features: int = 0
    n_classes: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid/local-global attention)."""
        return self.family in ("ssm", "hybrid") or self.global_every > 0

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only and self.family != "trees"

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, l, v = self.d_model, self.n_layers, self.vocab_size
        dh = self.resolved_head_dim
        n = v * d  # embed (tied head)
        if not self.tie_embeddings:
            n += v * d
        for i in range(l):
            kind = block_kind(self, i)
            if kind in ("attn_mlp", "attn_moe"):
                n += d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
                if kind == "attn_mlp":
                    n += 3 * d * self.d_ff
                else:
                    n += d * self.n_experts + self.n_experts * 3 * d * self.d_ff
            if kind == "ssm":
                from repro_torch.models.ssm import ssm_dims

                d_inner, h, conv_dim = ssm_dims(d, self.ssm_expand, self.ssm_state)
                n += d * (2 * d_inner + 2 * self.ssm_state + h)
                n += conv_dim * 4 + 3 * h + d_inner + d_inner * d
        if self.hybrid_attn_every:
            # shared attention+mlp sets
            per = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d + 3 * d * self.d_ff
            n += self.hybrid_shared_sets * per
        if self.frontend != "none":
            n += self.frontend_dim * d
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.d_ff
        return dense + self.n_layers * self.experts_per_token * 3 * d * self.d_ff


def block_kind(cfg: ModelConfig, layer: int) -> str:
    if cfg.family == "moe":
        return "attn_moe"
    if cfg.family in ("ssm", "hybrid"):
        return "ssm"
    return "attn_mlp"


ARCHS: Tuple[str, ...] = (
    "zamba2-2.7b",
    "olmoe-1b-7b",
    "qwen3-moe-30b-a3b",
    "mamba2-370m",
    "llava-next-34b",
    "starcoder2-3b",
    "granite-3-2b",
    "gemma3-27b",
    "granite-34b",
    "hubert-xlarge",
    "intreeger-rf",  # the paper's own architecture (tree ensemble serving)
)


def _module(name: str):
    return importlib.import_module("repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
