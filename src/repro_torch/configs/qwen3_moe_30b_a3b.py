"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8.  [hf:Qwen/Qwen3-30B-A3B]

48L d_model=2048 32H (GQA kv=4, head_dim=128) d_ff=768 (per expert)
vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
    microbatches=4,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    moe_capacity_factor=4.0,  # = E/k -> dropless for exactness tests
)
