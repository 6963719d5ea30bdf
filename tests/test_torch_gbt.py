"""The port's gradient-boosted trees against the JAX package's.

On the same data and seed, ``repro_torch.trees.GradientBoostedClassifier``
grows the same trees as ``repro.trees.gbt.GradientBoostedClassifier``
(every array equal), and ``pack_gbt`` and ``predict_gbt_integer`` give
equal arrays.  Then the three GBT cases of ``tests/test_gbt_and_io.py`` on
the port: it learns, its integer margins' argmax matches the float path,
and its fixed-point accumulation never overflows.
"""
from dataclasses import fields

import numpy as np
import pytest

from repro.data.tabular import make_shuttle_like, train_test_split
from repro.trees import gbt as jgbt
from repro_torch.trees import GradientBoostedClassifier, pack_gbt, predict_gbt_integer
from repro_torch.trees.gbt import PackedGBT


@pytest.fixture(scope="module")
def data():
    X, y = make_shuttle_like(n=6000, n_classes=4, seed=5)
    return train_test_split(X, y, seed=5)


@pytest.fixture(scope="module")
def pair(data):
    """(port model, JAX model) fitted on the same rows with one seed."""
    Xtr, ytr, _, _ = data
    kw = dict(n_estimators=12, max_depth=3, seed=1)
    return (GradientBoostedClassifier(**kw).fit(Xtr, ytr),
            jgbt.GradientBoostedClassifier(**kw).fit(Xtr, ytr))


def test_grows_the_jax_packages_trees(pair, data):
    port, jax = pair
    np.testing.assert_array_equal(port.base_, jax.base_)
    assert port.n_classes_ == jax.n_classes_ == 4
    assert [len(s) for s in port.trees_] == [len(s) for s in jax.trees_]
    for stages, jstages in zip(port.trees_, jax.trees_):
        for t, jt in zip(stages, jstages):
            for name in ("feature", "threshold", "left", "right", "leaf_probs"):
                a, b = getattr(t, name), getattr(jt, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            assert t.depth == jt.depth
    Xte = data[2][:500]
    np.testing.assert_array_equal(port.decision_function(Xte), jax.decision_function(Xte))


def test_pack_and_integer_predict_are_the_jax_packages(pair, data):
    port, jax = pair
    packed, jpacked = pack_gbt(port), jgbt.pack_gbt(jax)
    assert isinstance(packed, PackedGBT)
    for f in fields(jgbt.PackedGBT):
        a, b = getattr(packed, f.name), getattr(jpacked, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    Xte = data[2][:800]
    np.testing.assert_array_equal(predict_gbt_integer(packed, Xte),
                                  jgbt.predict_gbt_integer(jpacked, Xte))


def test_gbt_learns(data):
    Xtr, ytr, Xte, yte = data
    gbt = GradientBoostedClassifier(n_estimators=15, max_depth=4, seed=0).fit(Xtr, ytr)
    acc = (gbt.predict(Xte) == yte).mean()
    prior = max(np.bincount(yte)) / len(yte)
    assert acc > max(prior + 0.05, 0.85), acc


def test_gbt_integer_margins_match_float(pair, data):
    """Signed fixed-point margin accumulation gives the float path's argmax
    (margins can tie within quantization, so near-total agreement)."""
    port, _ = pair
    Xte = data[2][:800]
    agree = (port.predict(Xte) == predict_gbt_integer(pack_gbt(port), Xte)).mean()
    assert agree >= 0.999, agree


def test_gbt_fixed_point_never_overflows(data):
    Xtr, ytr, Xte, _ = data
    gbt = GradientBoostedClassifier(n_estimators=25, max_depth=4, seed=2).fit(Xtr, ytr)
    predict_gbt_integer(pack_gbt(gbt), Xte[:500])  # internal overflow assert
