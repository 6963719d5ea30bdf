"""Training and model exchange, numpy only: the histogram CART trainer
(``cart``), random forests on top of it (``forest``) and the JSON exchange
format (``io``)."""
from repro_torch.trees.cart import DecisionTree, TreeArrays, train_tree
from repro_torch.trees.forest import RandomForestClassifier

__all__ = ["DecisionTree", "TreeArrays", "train_tree", "RandomForestClassifier"]
