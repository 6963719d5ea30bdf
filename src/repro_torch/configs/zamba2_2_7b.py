"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  A shared transformer block (attn+mlp, two
alternating parameter sets) is applied every 6 Mamba2 blocks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=64,  # as mamba2
    hybrid_attn_every=6,
    hybrid_shared_sets=2,
    microbatches=8,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=32,
    hybrid_attn_every=2,
    hybrid_shared_sets=2,
)
