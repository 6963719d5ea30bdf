"""Treelite-style JSON model exchange.

The paper's pipeline converts sklearn/XGBoost/LightGBM models into a common
Treelite representation before codegen (Sec. III-B).  This module provides
the equivalent boundary for this framework: export/import a trained forest as
a JSON document with the same information content (per-node feature,
threshold, children, leaf distribution), so externally-trained models can be
packed and served through the integer-only path.

Versioning: documents carry ``schema_version`` (see :data:`SCHEMA_VERSION`).
The reader is *forward-compatible within a version*: unknown keys — at the
document, tree, or any future nesting level — are ignored, so additive
metadata (e.g. per-layout hints from the ForestIR layer) can ship without
breaking older readers.  Documents from a *newer* schema version are refused
loudly rather than half-parsed; documents predating the field (the v1 era)
load as version 1.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np

from repro_torch.trees.cart import TreeArrays
from repro_torch.trees.forest import RandomForestClassifier

# v1: implicit (no version field): model_type, n_classes, n_features, trees
# v2: + schema_version field; unknown/additive keys are explicitly tolerated
SCHEMA_VERSION = 2


def forest_to_json(forest: RandomForestClassifier) -> str:
    doc = {
        "schema_version": SCHEMA_VERSION,
        "model_type": "random_forest_classifier",
        "n_classes": forest.n_classes_,
        "n_features": forest.n_features_,
        "trees": [
            {
                "feature": t.feature.tolist(),
                "threshold": [float(x) for x in t.threshold],
                "left": t.left.tolist(),
                "right": t.right.tolist(),
                "leaf_probs": t.leaf_probs.tolist(),
                "depth": t.depth,
            }
            for t in forest.trees_
        ],
    }
    return json.dumps(doc)


def forest_from_json(payload: str) -> RandomForestClassifier:
    doc = json.loads(payload)
    version = int(doc.get("schema_version", 1))
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"model JSON uses schema_version {version}, but this reader "
            f"understands <= {SCHEMA_VERSION}; refusing to half-parse a "
            "newer artifact"
        )
    assert doc["model_type"] == "random_forest_classifier"
    forest = RandomForestClassifier(n_estimators=len(doc["trees"]))
    forest.n_classes_ = int(doc["n_classes"])
    forest.n_features_ = int(doc["n_features"])
    forest.trees_ = [
        TreeArrays(
            feature=np.asarray(t["feature"], np.int32),
            threshold=np.asarray(t["threshold"], np.float32),
            left=np.asarray(t["left"], np.int32),
            right=np.asarray(t["right"], np.int32),
            leaf_probs=np.asarray(t["leaf_probs"], np.float64),
            depth=int(t["depth"]),
        )
        for t in doc["trees"]
    ]
    return forest
