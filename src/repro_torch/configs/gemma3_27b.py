"""gemma3-27b [dense]: 5 local (sliding-window 1024) : 1 global, 128k ctx.

[hf:google/gemma-3-1b-pt pattern]  62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144.  Decode over the cache is linear per token; local
layers mask keys older than the window (``window_schedule``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,
    rope_theta=1_000_000.0,
    act="gelu",
    microbatches=16,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    sliding_window=16,
    global_every=2,
    act="gelu",
)
