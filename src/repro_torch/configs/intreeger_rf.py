"""intreeger-rf [trees]: the paper's own architecture as a serving config.

A production-scale random-forest ensemble served integer-only: 128 trees
(paper Sec. III-A argues n <= 256 keeps fixed point strictly more precise
than float32; [32] shows no gains past 128), depth 10, ESA-scale feature
width (87), 8 classes (7-class Shuttle padded to 8).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="intreeger-rf",
    family="trees",
    n_trees=128,
    tree_depth=10,
    n_tab_features=87,
    n_classes=8,
)

SMOKE = ModelConfig(
    name="intreeger-rf-smoke",
    family="trees",
    n_trees=8,
    tree_depth=4,
    n_tab_features=7,
    n_classes=4,
)
