"""Card-only tests of the CUDA kernels K1 and K2: each against its plain
version on the same CUDA tensors, bit for bit, with the launch counters
showing the kernel ran.  Marked ``cuda``; each test asks the ``card``
fixture, which skips when no card is present.  Run on a machine with a
card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.flint import float_to_key
from repro_torch.ir import ForestIR
from repro_torch.kernels import tree_traverse as tt
from repro_torch.kernels.ops import pick_blocks
from repro_torch.serve import TreeEngine
from repro_torch.trees import TreeArrays


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _random_tree(rng, depth, n_features, n_classes):
    """A random tree grown by splitting leaves in BFS order, so children
    follow parents; leaves self-loop."""
    feature, threshold, left, right = [-1], [0.0], [0], [0]
    frontier, levels = [0], 0
    while frontier and levels < depth:
        nxt = []
        for node in frontier:
            if rng.random() < 0.8:
                feature[node] = int(rng.integers(n_features))
                threshold[node] = float(rng.normal())
                for side in (left, right):
                    side[node] = len(feature)
                    nxt.append(len(feature))
                    feature.append(-1)
                    threshold.append(0.0)
                    left.append(len(left))
                    right.append(len(right))
        levels += bool(nxt)
        frontier = nxt
    n = len(feature)
    probs = np.zeros((n, n_classes))
    leaves = np.asarray(feature) < 0
    probs[leaves] = rng.dirichlet(np.ones(n_classes), leaves.sum())
    return TreeArrays(feature=np.asarray(feature, np.int32),
                      threshold=np.asarray(threshold, np.float32),
                      left=np.asarray(left, np.int32), right=np.asarray(right, np.int32),
                      leaf_probs=probs, depth=levels)


def _forest(seed, n_trees, depth, n_features, n_classes):
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    trees = [_random_tree(rng, depth, n_features, n_classes) for _ in range(n_trees)]
    return ForestIR.from_forest(SimpleNamespace(
        trees_=trees, n_classes_=n_classes, n_features_=n_features))


def _on(dev, packed):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(packed.feature), t(packed.threshold_key), t(packed.left),
            t(packed.right), t(packed.leaf_fixed.view(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 1000])
@pytest.mark.parametrize("n_trees,depth,n_features,n_classes",
                         [(1, 3, 4, 2), (7, 6, 11, 3), (33, 8, 87, 8), (20, 5, 9, 19)])
def test_kernels_match_plain_versions(card, rows, n_trees, depth, n_features, n_classes):
    ir = _forest(rows + n_trees, n_trees, depth, n_features, n_classes)
    x = np.random.default_rng(rows).normal(size=(rows, n_features)).astype(np.float32)
    keys = float_to_key(torch.from_numpy(x).to(card))
    lm = ir.materialize("leaf_major")
    f, k, l, r, leaf = _on(card, lm)
    nint = torch.from_numpy(lm.internal_counts.astype(np.int32)).to(card)
    pad = _on(card, ir.materialize("padded"))
    for block_b, block_t in (pick_blocks(rows, n_trees, 132), (32, 1), (256, n_trees)):
        tt.reset_launches()
        k1 = tt.tree_traverse_leaf_major(keys, f, k, l, r, nint, leaf,
                                         block_b=block_b, block_t=block_t)
        k2 = tt.tree_traverse_gather(keys, *pad, depth=ir.max_depth,
                                     block_b=block_b, block_t=block_t)
        torch.cuda.synchronize()
        assert tt.LAUNCHES == {"leaf_major": 1, "gather": 1}
        p1 = tt.leaf_major_plain(keys, f, k, l, r, nint, leaf, block_b=block_b, block_t=block_t)
        p2 = tt.gather_plain(keys, *pad, depth=ir.max_depth, block_b=block_b, block_t=block_t)
        assert k1.dtype == k2.dtype == torch.uint32
        np.testing.assert_array_equal(k1.view(torch.int32).cpu().numpy(),
                                      p1.view(torch.int32).cpu().numpy())
        np.testing.assert_array_equal(k2.view(torch.int32).cpu().numpy(),
                                      p2.view(torch.int32).cpu().numpy())


@pytest.mark.cuda
def test_engine_on_card_matches_reference_on_cpu(card):
    ir = _forest(0, 16, 7, 12, 5)
    x = np.random.default_rng(1).normal(size=(300, 12)).astype(np.float32)
    for spec in ("integer:cuda@leaf_major", "flint:cuda@leaf_major", "integer:cuda@padded"):
        tt.reset_launches()
        eng = TreeEngine(ir, spec=spec)
        ref = TreeEngine(ir, spec=spec.split("@")[0].replace("cuda", "reference"),
                         device="cpu")
        for b in (1, 20, 37, 300):
            s, p = eng.predict_scores(x[:b])
            s_ref, p_ref = ref.predict_scores(x[:b])
            np.testing.assert_array_equal(s, s_ref)
            np.testing.assert_array_equal(p, p_ref)
        assert tt.LAUNCHES["gather"] > 0
        assert (tt.LAUNCHES["leaf_major"] > 0) == spec.endswith("leaf_major")
