"""llava-next-34b [vlm]: decoder backbone + stubbed vision frontend.

[hf:llava-hf/llava-v1.6-mistral-7b-hf]  60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000.  Per the assignment the modality frontend is a STUB:
the batch carries precomputed patch embeddings (anyres tiling not
implemented); a linear projector (the only trained frontend piece in LLaVA)
maps them to d_model and they are prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision_stub",
    frontend_dim=1024,
    vision_patches=576,
    microbatches=16,
)

SMOKE = ModelConfig(
    name="llava-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="vision_stub",
    frontend_dim=32,
    vision_patches=16,
)
