"""granite-34b [dense]: llama-arch code model, MQA.  [arXiv:2405.04324; hf]

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    microbatches=16,
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
