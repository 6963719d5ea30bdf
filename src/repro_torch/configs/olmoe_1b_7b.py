"""olmoe-1b-7b [moe]: 64 experts, top-8.  [arXiv:2409.02060; hf]

16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    microbatches=2,
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    moe_capacity_factor=4.0,  # = E/k -> dropless for exactness tests
)
