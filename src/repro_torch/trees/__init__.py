"""Training and model exchange, numpy only: the histogram CART trainer
(``cart``), random forests on top of it (``forest``), gradient-boosted trees
with their integer-only packing (``gbt``) and the JSON exchange format
(``io``)."""
from repro_torch.trees.cart import DecisionTree, TreeArrays, train_tree
from repro_torch.trees.forest import RandomForestClassifier
from repro_torch.trees.gbt import (
    GradientBoostedClassifier,
    PackedGBT,
    pack_gbt,
    predict_gbt_integer,
)

__all__ = ["DecisionTree", "TreeArrays", "train_tree", "RandomForestClassifier",
           "GradientBoostedClassifier", "PackedGBT", "pack_gbt", "predict_gbt_integer"]
