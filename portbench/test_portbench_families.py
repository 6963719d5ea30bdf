"""CPU tests of the ``gbt`` family's yardstick: its reference against the
port's own packing of boosted trees (``repro_torch.trees.pack_gbt``, which
``tests/test_torch_gbt.py`` holds equal to the JAX package's), its bfloat16
control, its imports and its counted work."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import catalog, check

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(family="gbt", n_rounds=6, n_classes=3, depth=4, n_features=10, learning_rate=0.3,
             threshold_sample_rows=256)
# Covertype's 54 features and 7 classes under XGBoost as Hummingbird scores it:
# 500 rounds of depth 8, a tree a class a round
COVTYPE_XGB500 = dict(family="gbt", n_rounds=500, n_classes=7, depth=8, n_features=54,
                      learning_rate=0.3, threshold_sample_rows=4096)
GBT = catalog.family(SMALL)


def packed_margins(packed, x):
    """The margins of the port's packed booster: its base plus each tree's
    ``leaf_fixed`` at its class, walked and summed in numpy."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.flint import float_to_key_np

    keys = float_to_key_np(np.asarray(x, np.float32))
    rows = np.arange(len(x))
    acc = np.tile(packed.base_fixed.astype(np.int64), (len(x), 1))
    for t in range(packed.feature.shape[0]):
        node = np.zeros(len(x), np.int64)
        for _ in range(packed.max_depth):
            f = packed.feature[t, node]
            go_left = keys[rows, np.maximum(f, 0)] <= packed.threshold_key[t, node]
            node = np.where(f < 0, node, np.where(go_left, packed.left[t, node],
                                                   packed.right[t, node]))
        acc[:, packed.tree_class[t]] += packed.leaf_fixed[t, node]
    return acc


def rows_of(model, seed, n=1500):
    x = np.random.default_rng(seed).standard_normal((n, model.n_features), dtype=np.float32)
    x[:5] = model.threshold[0, 0]  # rows on a threshold take the left branch on both sides
    x[5:10] = -0.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 2 ** 31 + 5])
def test_gbt_reference_bit_for_bit_with_the_ports_packing(seed):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.trees import pack_gbt, predict_gbt_integer

    model = GBT.make_forest(SMALL, seed)
    assert model.n_trees == 18 and list(model.tree_class) == [0] * 6 + [1] * 6 + [2] * 6
    packed = pack_gbt(GBT.program_model(model))
    x = rows_of(model, seed)
    scores, preds = GBT.Reference(model, "cpu").scores(x, block_rows=512)
    assert scores.dtype == np.int32 and scores.shape == (len(x), 3)
    assert np.array_equal(scores, packed_margins(packed, x))
    assert np.array_equal(preds, predict_gbt_integer(packed, x))
    # the margins are signed, and the seed draws the same model again
    assert scores.min() < 0 < scores.max()
    again = GBT.make_forest(SMALL, seed)
    assert np.array_equal(again.leaf, model.leaf) and np.array_equal(again.base, model.base)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gbt_control_in_bfloat16_fails_the_comparison(seed):
    model = GBT.make_forest(SMALL, seed)
    x = rows_of(model, seed, 2000)
    ref_s, ref_p = GBT.Reference(model, "cpu").scores(x)
    ctl_s, ctl_p = GBT.Reference(model, "cpu", rows_dtype=torch.bfloat16).scores(x)
    sound = check.compare([(0, len(x), ref_s, ref_p)], ref_s, ref_p, 0)
    control = check.compare([(0, len(x), ctl_s, ctl_p)], ref_s, ref_p, 0)
    assert check.verdict(sound)[0] is True
    assert control["rows_wrong"] > 0 and check.verdict(control)[0] is False


@pytest.mark.parametrize("family", ["rf", "gbt"])
def test_a_family_imports_nothing_of_the_program_or_jax(family):
    cfg = SMALL if family == "gbt" else dict(n_trees=6, depth=4, n_features=10, n_classes=3,
                                             threshold_sample_rows=256)
    probe = ("import json, sys; sys.path.insert(0, sys.argv[1]); import numpy as np; "
             "from portbench import catalog, check, traffic; cfg = json.loads(sys.argv[2]); "
             "fam = catalog.family(cfg); model = fam.make_forest(cfg, 3); "
             "fam.Reference(model, 'cpu').scores(np.zeros((4, cfg['n_features']), np.float32)); "
             "fam.bound_s(cfg, 64); "
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT), json.dumps(cfg)],
                         capture_output=True, text=True, check=True, timeout=120).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_gbt_work_counts_pinned_for_65536_rows():
    cfg = COVTYPE_XGB500
    assert GBT.batch_bytes(cfg, 65536) == 33_854_784
    assert GBT.batch_ops(cfg, 65536) == 5_734_400_000
    s, by = GBT.bound_s(cfg, 65536)
    assert by == "operations" and s == pytest.approx(85.59e-6, rel=1e-3)
    assert GBT.batch_bytes(cfg, 65536) / 3.35e12 == pytest.approx(10.11e-6, rel=1e-3)
