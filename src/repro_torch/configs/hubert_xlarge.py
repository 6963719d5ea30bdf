"""hubert-xlarge [audio]: encoder-only (w2v2 arch).  [arXiv:2106.07447]

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.  Frontend stubbed per the
assignment: the batch carries precomputed frame embeddings
(frame_dim=512, the conv-feature-extractor output dim); a linear projector
maps them to d_model.  No decode shapes (encoder-only).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    tie_embeddings=False,
    frontend="audio_stub",
    frontend_dim=512,
    act="gelu",
    microbatches=4,
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    encoder_only=True,
    tie_embeddings=False,
    frontend="audio_stub",
    frontend_dim=32,
    act="gelu",
)
