"""starcoder2-3b [dense]: GQA + RoPE.  [arXiv:2402.19173; hf]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    act="gelu",
    microbatches=8,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="gelu",
)
