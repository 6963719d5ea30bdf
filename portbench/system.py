"""The one bridge to the system under test, ``repro_torch``: the benchmark's
forest in the form the program takes.  Imports of the program happen inside
functions."""
from __future__ import annotations

from types import SimpleNamespace

MODEL_ID = "portbench"


def program_forest(forest):
    """The benchmark's forest as the program's duck-typed trained forest
    (``trees_`` of ``TreeArrays``, ``n_classes_``, ``n_features_``)."""
    from repro_torch.trees import TreeArrays

    trees = [TreeArrays(feature=forest.feature[t].copy(), threshold=forest.threshold[t].copy(),
                        left=forest.left[t].copy(), right=forest.right[t].copy(),
                        leaf_probs=forest.leaf_probs[t].copy(), depth=forest.depth)
             for t in range(forest.n_trees)]
    return SimpleNamespace(trees_=trees, n_classes_=forest.n_classes,
                           n_features_=forest.n_features)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
