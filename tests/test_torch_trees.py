"""The port's numpy training and model exchange against the JAX package's:
``train_tree`` and ``RandomForestClassifier.fit`` grow the same trees from
the same seeded data (tolerance 0), the JSON documents are the same string,
and a document written by either package loads in the other to the same
arrays."""
import json

import numpy as np
import pytest

from repro.trees import cart as jcart
from repro.trees.forest import RandomForestClassifier as JForest
from repro.trees.io import forest_from_json as j_from_json
from repro.trees.io import forest_to_json as j_to_json
from repro_torch.trees import cart
from repro_torch.trees.forest import RandomForestClassifier
from repro_torch.trees.io import SCHEMA_VERSION, forest_from_json, forest_to_json

FIELDS = ("feature", "threshold", "left", "right", "leaf_probs")


def _data(seed, n=900, f=7, c=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.7).astype(int) + (X[:, 2] > 1.2)
    return X, np.minimum(y, c - 1)


def _assert_trees_equal(a, b):
    for name in FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        assert va.dtype == vb.dtype, name
        np.testing.assert_array_equal(va, vb, err_msg=name)
    assert a.depth == b.depth


@pytest.mark.parametrize("kw", [
    dict(max_depth=4),
    dict(max_depth=6, min_samples_leaf=5, n_bins=16),
    dict(max_depth=5, max_features=3),
    dict(max_depth=5, extra_random=True),
])
def test_train_tree_matches(kw):
    X, y = _data(1)
    a = cart.train_tree(X, y, 4, rng=np.random.default_rng(3), **kw)
    b = jcart.train_tree(X, y, 4, rng=np.random.default_rng(3), **kw)
    _assert_trees_equal(a, b)
    np.testing.assert_array_equal(a.predict_proba(X), b.predict_proba(X))


def test_quantile_bins_match():
    X, _ = _data(2, n=500)
    codes, edges = cart._quantile_bins(X, 32, np.random.default_rng(0))
    jcodes, jedges = jcart._quantile_bins(X, 32, np.random.default_rng(0))
    np.testing.assert_array_equal(codes, jcodes)
    for e, je in zip(edges, jedges, strict=True):
        np.testing.assert_array_equal(e, je)


@pytest.mark.parametrize("kw", [
    dict(n_estimators=5, max_depth=4, seed=0),
    dict(n_estimators=4, max_depth=6, seed=9, bootstrap=False, max_features=None),
    dict(n_estimators=3, max_depth=5, seed=2, extra_random=True),
])
def test_forest_fit_matches(kw):
    X, y = _data(4)
    rf = RandomForestClassifier(**kw).fit(X, y)
    jrf = JForest(**kw).fit(X, y)
    assert (rf.n_classes_, rf.n_features_) == (jrf.n_classes_, jrf.n_features_)
    assert len(rf.trees_) == len(jrf.trees_) == kw["n_estimators"]
    for a, b in zip(rf.trees_, jrf.trees_, strict=True):
        _assert_trees_equal(a, b)
    np.testing.assert_array_equal(rf.predict_proba(X), jrf.predict_proba(X))
    np.testing.assert_array_equal(rf.predict(X), jrf.predict(X))
    assert rf.max_tree_depth == jrf.max_tree_depth


def test_json_round_trips_both_ways():
    X, y = _data(5)
    rf = RandomForestClassifier(n_estimators=4, max_depth=5, seed=1).fit(X, y)
    jrf = JForest(n_estimators=4, max_depth=5, seed=1).fit(X, y)
    doc = forest_to_json(rf)
    assert doc == j_to_json(jrf)
    assert json.loads(doc)["schema_version"] == SCHEMA_VERSION
    for loaded, source in ((forest_from_json(j_to_json(jrf)), jrf),
                           (j_from_json(doc), rf),
                           (forest_from_json(doc), rf)):
        assert (loaded.n_classes_, loaded.n_features_) == (source.n_classes_, source.n_features_)
        for a, b in zip(loaded.trees_, source.trees_, strict=True):
            _assert_trees_equal(a, b)


def test_json_reader_versions():
    X, y = _data(6, n=300)
    doc = json.loads(forest_to_json(
        RandomForestClassifier(n_estimators=2, max_depth=3).fit(X, y)))
    legacy = {k: v for k, v in doc.items() if k != "schema_version"}
    legacy["future_hint"] = {"ignored": True}  # unknown keys are tolerated
    assert len(forest_from_json(json.dumps(legacy)).trees_) == 2
    newer = dict(doc, schema_version=SCHEMA_VERSION + 1)
    with pytest.raises(ValueError, match="schema_version"):
        forest_from_json(json.dumps(newer))
