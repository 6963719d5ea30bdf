"""The model configurations: ``CONFIG`` (published shape) and ``SMOKE``
(reduced, same family) per architecture in ``ARCHS``."""
from repro_torch.configs.base import ARCHS, ModelConfig, block_kind, get_config, smoke_config

__all__ = ["ARCHS", "ModelConfig", "block_kind", "get_config", "smoke_config"]
