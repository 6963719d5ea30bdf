"""mamba2-370m [ssm]: SSD (state-space duality).  [arXiv:2405.21060]

48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_chunk=64,  # the (Q x Q) intra-chunk working set of the chunked SSD
    microbatches=2,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=128,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=32,
)
