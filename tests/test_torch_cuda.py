"""Card-only tests of the CUDA kernels K1, K2, K3 and K5: each against its
plain version on the same CUDA tensors, bit for bit, with the launch
counters showing the kernel ran, at shapes that reach each edge of their
design (odd and even feature counts, rows too wide to stage, class counts
that take the scalar leaf path and several class chunks, tree chunks that
the walks per thread do not divide, rows past the last full CTA; for K5
bitvectors of 2, 8, 32 and 36 words, an all-stump forest and random clear
sets that are no leaf range, on its packed tables, at pinned rows, trees,
splits and rows per thread, records staged or not); K3
also on malformed tables at every walk count and staging, where K1 and K2
must stay inside their buffers; K1, K2, K3 and K5 on 65,536 trees, more
than grid.y holds CTAs; two gateways on two routes serving at once from
executor threads; the sharded plans (``tree_parallel`` over ``cuda`` shards
and over ``cuda|bitvector``, ``row_parallel``) equal to the single plan, two
threads serving one plan route at once; ``tree_parallel`` under
``device_parallel="auto"`` on threads where two cards are counted; K1, K2
and K5 serving an mmap-registered ITRF artifact; and ``remote_tree_parallel``
on two workers started on the card, whose span records count K1 and K5
launched inside them; and host-C shards (``cuda|native_c_table``,
``bitvector|native_c_bitvector``) beside K1 and K5, with C backends on the
CPU whatever device they are given; the LM smoke models' prefill and decode
on the card against the CPU, and ``launch.serve --trees`` on the card;
the LM smoke models' training step on the card against the CPU, and
``integer_psum`` on two gloo ranks holding CUDA tensors against two CPU
ranks; a one-card NCCL mesh against no mesh, bit for bit, and the mesh
branches on four gloo ranks holding CUDA tensors against four CPU ranks.
Marked
``cuda``; each
test asks the ``card`` fixture, which skips when no card is present.  Run
on a machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.  It
takes K5's random clear sets from ``chip_smoke.random_span_tables``, the
generator the smoke run uses, and its process-group ranks from
``torch_dist_ranks``.
"""
import asyncio
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.flint import float_to_key
from repro_torch.ir import ForestIR
from repro_torch.kernels import bitvector as kbv
from repro_torch.kernels import tree_traverse as tt
from repro_torch.kernels.ops import pick_blocks
from repro_torch.serve import Gateway, ModelRegistry, TreeEngine
from repro_torch.trees import TreeArrays

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import random_span_tables  # noqa: E402  (numpy only at import)


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


def malformed_case(n_classes=3):
    """(rows, node tables, depth) where reads leave their tables: the padded
    tables of a small random forest of ``n_classes`` classes with, at the
    first internal node of three trees, a left child >= N, a feature index
    >= F and a right child < 0.  K3 reads 0 for each; K2's gather would
    read out of bounds."""
    ir = _forest(3, 5, 4, 6, n_classes)
    p = ir.materialize("padded")
    feature, key, left, right = (a.copy() for a in (p.feature, p.threshold_key,
                                                    p.left, p.right))
    n, f = feature.shape[1], ir.n_features
    trees = [t for t in range(ir.n_trees) if (feature[t] >= 0).any()][:3]
    assert len(trees) == 3
    first = [int(np.flatnonzero(feature[t] >= 0)[0]) for t in trees]
    left[trees[0], first[0]] = n + 3
    feature[trees[1], first[1]] = f + 2
    right[trees[2], first[2]] = -2
    x = np.random.default_rng(4).normal(size=(300, f)).astype(np.float32)
    return x, (feature, key, left, right, p.leaf_fixed), ir.max_depth + 2


def root_exit_case(n_classes, depth=1):
    """(rows, node tables, depth) where walks end outside the table:
    :func:`malformed_case`'s tables with every root's left child >= N.
    Walked one level, each row that goes left at a root ends there (and
    each that goes right at the root whose right child is < 0); K3 adds a
    zero leaf row for each, on the scalar leaf path at C = 3 and on the
    16-byte one at C = 8.  Walked deeper, such a row bounces between the
    root and outside, since a node outside reads as zeros and leads to node
    0; the clamped index N - 1 is a real leaf of the largest tree, so a walk
    that read the clamped node instead would add its row."""
    x, (feature, key, left, right, leaf), _ = malformed_case(n_classes)
    left[:, 0] = left.shape[1] + 1
    return x, (feature, key, left, right, leaf), depth


def malformed_cases():
    """Every malformed case the K3 tests walk, by name."""
    return {"malformed, C=3": malformed_case(), "malformed, C=8": malformed_case(8),
            "root exit, C=3": root_exit_case(3), "root exit, C=8": root_exit_case(8),
            "root bounce, C=8": root_exit_case(8, depth=4)}


def _on_card(tables, dev):
    return [torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32
                                                  else a)).to(dev) for a in tables]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 1000])
@pytest.mark.parametrize("n_trees,depth,n_features,n_classes",
                         [(1, 3, 4, 2), (7, 6, 11, 3), (33, 8, 87, 8), (20, 5, 9, 19),
                          (13, 6, 10, 4), (6, 7, 64, 16), (9, 5, 2000, 3)])
def test_kernels_match_plain_versions(card, rows, n_trees, depth, n_features, n_classes):
    """F = 10 and 64 are even (the tile pads them to odd strides), 4, 11, 9
    and 87 are not multiples of 4, F = 2,000 is too wide to stage; C = 3 and
    19 take the scalar leaf path, 4 and 16 the 16-byte one, 16 and 19 more
    than one class chunk; 7, 9, 13 and 33 trees leave chunks that 2 or 4
    walks do not divide; 37 and 1,000 rows end inside a CTA."""
    ir = _forest(rows + n_trees, n_trees, depth, n_features, n_classes)
    x = np.random.default_rng(rows).normal(size=(rows, n_features)).astype(np.float32)
    keys = float_to_key(torch.from_numpy(x).to(card))
    lm = ir.materialize("leaf_major")
    f, k, l, r, leaf = _on(card, lm)
    nint = torch.from_numpy(lm.internal_counts.astype(np.int32)).to(card)
    pad = _on(card, ir.materialize("padded"))
    lm_quads, pad_quads = tt.pack_node_quads(f, k, l, r), tt.pack_node_quads(*pad[:4])
    auto_b, auto_t = pick_blocks(rows, n_trees, n_features, 132)
    staged = tt.stages_x(n_features)
    assert staged == (n_features != 2000)
    for block_b, block_t, walks in ((auto_b, auto_t, None), (32, 1, 1), (256, n_trees, 4),
                                    (64, 3, 2), (96, 5, 4), (512, n_trees, 2)):
        blocks = dict(block_b=block_b, block_t=block_t)
        tt.reset_launches()
        k1 = tt.tree_traverse_leaf_major(keys, lm_quads, nint, leaf, _walks=walks, **blocks)
        k2 = tt.tree_traverse_gather(keys, pad_quads, pad[4], depth=ir.max_depth,
                                     _walks=walks, **blocks)
        k3 = tt.tree_traverse_onehot(keys, pad_quads, pad[4], depth=ir.max_depth,
                                     _walks=walks, **blocks)
        torch.cuda.synchronize()
        assert tt.LAUNCHES == {"leaf_major": 1, "gather": 1, "onehot": 1, "bitvector": 0}
        tile = dict(walks=tt.default_walks(block_t) if walks is None else walks,
                    stage_x=staged,
                    smem_bytes=tt.tile_bytes(block_b, n_features) if staged else 0)
        assert tt.LAUNCH_SHAPES == {**{name: {**blocks, **tile}
                                       for name in ("leaf_major", "gather", "onehot")},
                                    "bitvector": None}
        p1 = tt.leaf_major_plain(keys, f, k, l, r, nint, leaf, **blocks)
        p2 = tt.gather_plain(keys, *pad, depth=ir.max_depth, **blocks)
        p3 = tt.onehot_plain(keys, *pad, depth=ir.max_depth, **blocks)
        assert k1.dtype == k2.dtype == k3.dtype == torch.uint32
        for kernel, plain in ((k1, p1), (k2, p2), (k3, p3), (k3, p2)):
            np.testing.assert_array_equal(kernel.view(torch.int32).cpu().numpy(),
                                          plain.view(torch.int32).cpu().numpy())


@pytest.mark.cuda
def test_walks_stay_inside_their_buffers_on_malformed_tables(card):
    """The kernels clamp every index into its buffer: on a table with a
    child >= N, a child < 0, a feature >= F and prefix lengths past N, K1
    and K2 run to the end without a fault, staged and not, at 1, 2 and 4
    walks (their function there is undefined, so only the run is checked);
    K3 equals its plain version on the same table at each."""
    x, tables, depth = malformed_case()
    keys = float_to_key(torch.from_numpy(x).to(card))
    on = _on_card(tables, card)
    nint = torch.full((on[0].shape[0],), on[0].shape[1] + 5, dtype=torch.int32, device=card)
    nint[0] = -3
    quads = tt.pack_node_quads(*on[:4])
    ref = tt.onehot_plain(keys, *on, depth=depth, block_b=64, block_t=2)
    for stage_x in (True, False):
        for walks in (1, 2, 4):
            tile = dict(block_b=64, block_t=2, _walks=walks, _stage_x=stage_x)
            k1 = tt.tree_traverse_leaf_major(keys, quads, nint, on[4], **tile)
            k2 = tt.tree_traverse_gather(keys, quads, on[4], depth=depth, **tile)
            k3 = tt.tree_traverse_onehot(keys, quads, on[4], depth=depth, **tile)
            torch.cuda.synchronize()
            assert k1.shape == k2.shape == (len(x), on[4].shape[-1])
            np.testing.assert_array_equal(k3.view(torch.int32).cpu().numpy(),
                                          ref.view(torch.int32).cpu().numpy())


@pytest.mark.cuda
def test_tile_that_does_not_fit_raises_before_launch(card):
    """A CTA whose row tile needs more than 227 KB raises and launches
    nothing; the wrapper does not shrink it."""
    ir = _forest(2, 4, 3, 1000, 3)
    x = np.random.default_rng(0).normal(size=(70, 1000)).astype(np.float32)
    keys = float_to_key(torch.from_numpy(x).to(card))
    pad = _on(card, ir.materialize("padded"))
    quads = tt.pack_node_quads(*pad[:4])
    tt.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        tt.tree_traverse_gather(keys, quads, pad[4], depth=ir.max_depth, block_b=64,
                                block_t=1)
    assert tt.LAUNCHES["gather"] == 0 and tt.LAUNCH_SHAPES["gather"] is None
    out = tt.tree_traverse_gather(keys, quads, pad[4], depth=ir.max_depth, block_b=32,
                                  block_t=1)
    np.testing.assert_array_equal(
        out.view(torch.int32).cpu().numpy(),
        tt.gather_plain(keys, *pad, depth=ir.max_depth, block_b=32, block_t=1)
        .view(torch.int32).cpu().numpy())


@pytest.mark.cuda
def test_onehot_kernel_on_a_malformed_table(card):
    """K3 equals its plain version where reads leave the tables and where
    walks end outside them, on both leaf paths, at each CTA shape, walk
    count and staging."""
    for name, (x, tables, depth) in malformed_cases().items():
        keys = float_to_key(torch.from_numpy(x).to(card))
        on = _on_card(tables, card)
        quads = tt.pack_node_quads(*on[:4])
        for block_b, block_t in ((128, 1), (64, 2), (256, len(tables[0]))):
            ref = tt.onehot_plain(keys, *on, depth=depth, block_b=block_b, block_t=block_t)
            for walks in (1, 2, 4):
                for stage_x in (True, False):
                    tt.reset_launches()
                    out = tt.tree_traverse_onehot(keys, quads, on[4], depth=depth,
                                                  block_b=block_b, block_t=block_t,
                                                  _walks=walks, _stage_x=stage_x)
                    torch.cuda.synchronize()
                    assert tt.LAUNCHES["onehot"] == 1
                    assert tt.LAUNCH_SHAPES["onehot"]["stage_x"] == stage_x
                    np.testing.assert_array_equal(
                        out.view(torch.int32).cpu().numpy(),
                        ref.view(torch.int32).cpu().numpy(),
                        err_msg=f"{name}, {block_b} x {block_t}, {walks} walks, "
                                f"staged {stage_x}")


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


@pytest.mark.cuda
def test_two_gateways_serve_from_threads_at_once(card):
    """Two gateways on two routes (K1/K2 and K3) share one registry and
    serve at once: their batches run in executor threads and launch kernels
    concurrently.  A hot swap lands halfway.  Every response equals the CPU
    reference of the version that served it (v2 for every request submitted
    after the swap), and no launch count is lost."""
    ir1, ir2 = _forest(10, 24, 7, 9, 4), _forest(11, 24, 7, 9, 4)
    refs = {1: TreeEngine(ir1, spec="integer:reference", device="cpu"),
            2: TreeEngine(ir2, spec="integer:reference", device="cpu")}
    reg = ModelRegistry()
    reg.register_packed("m", ir1.materialize("padded"))
    gws = [Gateway(reg, route, max_batch_rows=512, max_delay_ms=1.0,
                   max_queue_rows=1 << 20)
           for route in ("integer:cuda", "integer:cuda@padded?impl=onehot")]
    rng = np.random.default_rng(5)
    reqs = [rng.normal(size=(int(rng.choice([1, 20, 100, 300])), 9)).astype(np.float32)
            for _ in range(48)]

    async def run():
        # a lone 5-row request: a batch under 64 rows, which takes K2 on
        # the first route (a burst coalesces into larger batches)
        lone = [await gw.submit("m", reqs[0][:1].repeat(5, axis=0)) for gw in gws]

        async def one(i, gw):
            if i == len(reqs) // 2 and gw is gws[0]:
                reg.register_packed("m", ir2.materialize("padded"))
            version = reg.version("m")
            return version, await gw.submit("m", reqs[i])

        outs = await asyncio.wait_for(asyncio.gather(
            *[one(i, gw) for i in range(len(reqs)) for gw in gws]), timeout=300)
        for gw in gws:
            await gw.close()
        return lone, outs

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    tt.reset_launches()
    try:
        lone, outs = asyncio.run(run())
    finally:
        sys.setswitchinterval(old)
    for scores, preds in lone:
        ref = refs[1].predict_scores(reqs[0][:1].repeat(5, axis=0))
        np.testing.assert_array_equal(scores, ref[0])
        np.testing.assert_array_equal(preds, ref[1])
    for k, (version, (scores, preds)) in enumerate(outs):
        x = reqs[k // len(gws)]
        want = [refs[v].predict_scores(x) for v in ((2,) if version == 2 else (1, 2))]
        assert any(np.array_equal(scores, s) and np.array_equal(preds, p)
                   for s, p in want), (k, version)
    batches = sum(st["batches"] for gw in gws for st in gw.stats()["per_model"].values())
    assert tt.LAUNCHES["onehot"] > 0 and tt.LAUNCHES["leaf_major"] > 0
    assert tt.LAUNCHES["gather"] > 0
    assert sum(tt.LAUNCHES.values()) == batches


# ---------------------------------------------------------------------------
# K5 and the sharded plans
# ---------------------------------------------------------------------------

def _chain_tree(depth, n_classes):
    """A right-leaning chain on feature 0 (``depth + 1`` leaves), thresholds
    ``k - depth / 2``: rows spread over that range exit at every leaf."""
    n = 2 * depth + 1
    feature = np.full(n, -1, np.int32)
    threshold = np.zeros(n, np.float32)
    left = np.arange(n, dtype=np.int32)
    right = left.copy()
    probs = np.zeros((n, n_classes))
    for k in range(depth):
        feature[2 * k] = 0
        threshold[2 * k] = k - depth / 2.0
        left[2 * k], right[2 * k] = 2 * k + 1, 2 * k + 2
        probs[2 * k + 1, k % n_classes] = 1.0
    probs[n - 1, (depth + 1) % n_classes] = 1.0
    return TreeArrays(feature=feature, threshold=threshold, left=left, right=right,
                      leaf_probs=probs, depth=depth)


def _stump(n_classes, seed):
    probs = np.random.default_rng(seed).dirichlet(np.ones(n_classes))[None]
    return TreeArrays(feature=np.array([-1], np.int32), threshold=np.zeros(1, np.float32),
                      left=np.zeros(1, np.int32), right=np.zeros(1, np.int32),
                      leaf_probs=probs, depth=0)


#: name -> (chain depths, random trees, classes, features); the longest
#: chain sets the bitvector's width: W32 = 2 * ceil((depth + 1) / 64)
BITVECTOR_CASES = {
    "W32=2, C=3": ((), 7, 3, 9),
    "W32=8, C=8": ((200,), 4, 8, 9),
    "W32=32, C=1": ((1000,), 3, 1, 9),
    "W32=36, C=3": ((1100, 9), 0, 3, 9),
    "all stumps, C=8": (None, 0, 8, 9),
    "W32=8, C=3, unstaged": ((200,), 2, 3, 2000),
}


def _bitvector_case(name, rows):
    from types import SimpleNamespace

    chains, n_random, n_classes, n_features = BITVECTOR_CASES[name]
    rng = np.random.default_rng(len(name))
    if chains is None:
        trees = [_stump(n_classes, s) for s in range(3)]
    else:
        trees = [_chain_tree(d, n_classes) for d in chains]
        trees += [_random_tree(rng, 6, n_features, n_classes) for _ in range(n_random)]
    ir = ForestIR.from_forest(SimpleNamespace(trees_=trees, n_classes_=n_classes,
                                              n_features_=n_features))
    spread = max(chains or (0,)) / 2.0 + 4.0
    x = rng.uniform(-spread, spread, (rows, n_features)).astype(np.float32)
    return ir, x


def _dense_tables(arrays):
    return [arrays[k] for k in ("entry_feat", "entry_key", "inv_mask", "init_mask",
                                "leaf_off", "leaf_fixed")]


def _assert_bitvector_shapes(keys, dense, ref, n_features, n_trees, label):
    """K5 on the packed tables, at its own CTA shape and at pinned ones
    (rows, trees and splits per CTA, rows per thread), each equal to ``ref``
    with one launch counted and its shape recorded."""
    packed = kbv.pack_bitvector_tables(*dense, device=keys.device)
    w32 = dense[3].shape[-1]
    auto = kbv.pick_blocks(keys.shape[0], n_trees, n_features, w32, packed.tree_records, 132)
    for blocks in ({}, dict(block_b=32, block_t=1), dict(block_b=64, block_t=3),
                   dict(block_b=512, block_t=n_trees),
                   dict(block_b=32, block_t=2, splits=16),
                   dict(block_b=64, block_t=1, splits=3, _stage_records=False),
                   dict(block_b=128, block_t=2, splits=4, _rows_per_thread=1),
                   dict(block_b=64, block_t=5, splits=1, _rows_per_thread=2,
                        _stage_records=False),
                   dict(block_b=128, block_t=1, splits=2, _rows_per_thread=2),
                   dict(block_b=96, block_t=2, splits=5, _rows_per_thread=1,
                        _stage_records=True)):
        tt.reset_launches()
        out = kbv.tree_bitvector(keys, packed, **blocks)
        torch.cuda.synchronize()
        assert tt.LAUNCHES == {"leaf_major": 0, "gather": 0, "onehot": 0, "bitvector": 1}
        shape = tt.LAUNCH_SHAPES["bitvector"]
        want = dict(zip(("block_b", "block_t", "splits", "rows_per_thread"), auto))
        want.update({k.lstrip("_"): v for k, v in blocks.items() if k != "_stage_records"})
        if "block_b" in blocks and "_rows_per_thread" not in blocks:
            want["rows_per_thread"] = auto[3] if blocks["block_b"] % (32 * auto[3]) == 0 \
                else 1
        if "splits" not in blocks:
            want["splits"] = max(1, min(auto[2], kbv.MAX_THREADS * want["rows_per_thread"]
                                        // want["block_b"]))
        assert {k: shape[k] for k in want} == want, label
        staged = kbv.record_cap(packed.tree_records, shape["block_b"], n_features,
                                shape["splits"])
        if "_stage_records" in blocks:
            staged = packed.tree_records if blocks["_stage_records"] else 0
        assert shape["staged_records"] == staged
        assert shape["stage_x"] == tt.stages_x(n_features)
        assert shape["smem_bytes"] == kbv.smem_bytes(shape["block_b"], n_features,
                                                     shape["splits"], staged)
        assert out.dtype == torch.uint32 and out.shape == ref.shape
        np.testing.assert_array_equal(out.view(torch.int32).cpu().numpy(),
                                      ref.view(torch.int32).cpu().numpy(),
                                      err_msg=f"{label}, {blocks}")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 20, 1000])
@pytest.mark.parametrize("name", sorted(BITVECTOR_CASES))
def test_bitvector_kernel_matches_plain_version(card, name, rows):
    """K5 equals its plain version (max |kernel - plain| = 0) at each width,
    class count and row count, on its packed tables, at its own CTA shape
    and pinned ones, and counts one launch per call."""
    ir, x = _bitvector_case(name, rows)
    bv = ir.materialize("bitvector")
    arrays = kbv.bitvector_device_arrays(bv, card)
    arrays.pop("n_entry_slots")
    dense = _dense_tables(arrays)
    w32 = 2 * bv.words
    assert w32 == {"W32=2": 2, "W32=8": 8, "W32=32": 32, "W32=36": 36,
                   "all stumps": 2}[name.split(",")[0]]
    keys = float_to_key(torch.from_numpy(x).to(card))
    ref = kbv.bitvector_plain(keys, *dense)
    _assert_bitvector_shapes(keys, dense, ref, ir.n_features, ir.n_trees, f"{name}, {rows} rows")


@pytest.mark.cuda
@pytest.mark.parametrize("w32", [2, 8, 32, 36])
def test_bitvector_kernel_on_random_span_masks(card, w32):
    """K5 equals its plain version on clear sets that are no leaf range:
    multi-word spans with zero words inside, empty sets, padding slots,
    features outside [0, F) and below -F (the wrapper wraps them as jnp
    does), a tree with no surviving bit and one with only its top bit, and
    leaf rows below 0 and past the leaf table."""
    dense, keys = random_span_tables(w32, 5, 9, w32, 6, 40, 3)
    dense = [a.to(card) for a in dense]
    keys = keys.to(card)
    ref = kbv.bitvector_plain(keys, *dense)
    _assert_bitvector_shapes(keys, dense, ref, 6, 5, f"random spans, W32={w32}")


@pytest.fixture(scope="module")
def many_trees():
    """A forest of 65,536 depth-1 trees (one split each) over 3 features, 2
    classes, and 40 rows: more trees than grid.y holds CTAs."""
    from types import SimpleNamespace

    rng = np.random.default_rng(65_536)
    probs = rng.dirichlet(np.ones(2), (65_536, 2))
    trees = [TreeArrays(feature=np.array([f, -1, -1], np.int32),
                        threshold=np.array([thr, 0.0, 0.0], np.float32),
                        left=np.array([1, 1, 2], np.int32), right=np.array([2, 1, 2], np.int32),
                        leaf_probs=np.concatenate([np.zeros((1, 2)), p]), depth=1)
             for f, thr, p in zip(rng.integers(0, 3, 65_536), rng.normal(size=65_536), probs)]
    ir = ForestIR.from_forest(SimpleNamespace(trees_=trees, n_classes_=2, n_features_=3))
    return ir, rng.normal(size=(40, 3)).astype(np.float32)


@pytest.mark.cuda
def test_kernels_score_more_trees_than_grid_y_holds(card, many_trees):
    """K1, K2, K3 and K5 score 65,536 trees, bit-identical to their plain
    versions: the wrappers check the tree chunks, not the tree count."""
    ir, x = many_trees
    keys = float_to_key(torch.from_numpy(x).to(card))
    lm = ir.materialize("leaf_major")
    f, k, l, r, leaf = _on(card, lm)
    nint = torch.from_numpy(lm.internal_counts.astype(np.int32)).to(card)
    pad = _on(card, ir.materialize("padded"))
    blocks = dict(zip(("block_b", "block_t"), pick_blocks(40, ir.n_trees, 3, 132)))
    assert -(-ir.n_trees // blocks["block_t"]) <= tt.MAX_TREE_CHUNKS
    tt.reset_launches()
    k1 = tt.tree_traverse_leaf_major(keys, tt.pack_node_quads(f, k, l, r), nint, leaf,
                                     **blocks)
    pad_quads = tt.pack_node_quads(*pad[:4])
    k2 = tt.tree_traverse_gather(keys, pad_quads, pad[4], depth=1, **blocks)
    k3 = tt.tree_traverse_onehot(keys, pad_quads, pad[4], depth=1, **blocks)
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), card)
    arrays.pop("n_entry_slots")
    dense = _dense_tables(arrays)
    k5 = kbv.tree_bitvector(keys, kbv.pack_bitvector_tables(*dense, device=card))
    torch.cuda.synchronize()
    assert tt.LAUNCHES == {"leaf_major": 1, "gather": 1, "onehot": 1, "bitvector": 1}
    plain = {"K1": (k1, tt.leaf_major_plain(keys, f, k, l, r, nint, leaf, block_b=64, block_t=1)),
             "K2": (k2, tt.gather_plain(keys, *pad, depth=1, block_b=64, block_t=1)),
             "K3": (k3, tt.onehot_plain(keys, *pad, depth=1, block_b=64, block_t=1)),
             "K5": (k5, kbv.bitvector_plain(keys, *dense))}
    for name, (got, want) in plain.items():
        diff = (got.view(torch.int32).long() & 0xFFFFFFFF) - (want.view(torch.int32).long()
                                                               & 0xFFFFFFFF)
        assert int(diff.abs().max()) == 0, name
    np.testing.assert_array_equal(
        k1.view(torch.int32).cpu().numpy(),
        TreeEngine(ir, spec="integer:reference", device="cpu").predict_partials(x)
        .view(np.int32))


@pytest.mark.cuda
def test_fused_strategy_on_one_card_twice(card, monkeypatch):
    """The fused strategy with its device list patched to the card twice:
    "auto" builds it for a two-shard reference plan (uneven shards, so
    inert trees pad one), both shards' tables live on the card, and its
    partials and scores are bit-identical to the single plan's on the
    card and to the reference walk on the CPU."""
    from repro_torch.plan import tree_parallel as tp_mod

    monkeypatch.setattr(tp_mod, "fused_devices", lambda device: [torch.device("cuda", 0)] * 2)
    ir = _forest(23, 12, 6, 9, 4)
    x = np.random.default_rng(8).normal(size=(300, 9)).astype(np.float32)
    eng = TreeEngine(ir, spec="integer:reference+tree_parallel:2")
    assert eng.plan.name == "tree_parallel" and eng.plan.fused and eng.plan.backends == ()
    assert all(t.device.type == "cuda" for tables in eng.plan._fused for t in tables.values())
    single = TreeEngine(ir, spec="integer:reference")
    cpu = TreeEngine(ir, spec="integer:reference", device="cpu")
    for rows in (x, x[:1]):
        got = eng.predict_partials(rows)
        np.testing.assert_array_equal(got, single.predict_partials(rows))
        np.testing.assert_array_equal(got, cpu.predict_partials(rows))
        for a, b in zip(eng.predict_scores(rows), single.predict_scores(rows)):
            np.testing.assert_array_equal(a, b)
    assert set(eng.plan.drain_timings()) == {"fused:reference[x2]"}
    eng.close()


@pytest.mark.cuda
def test_bitvector_engine_on_card_matches_reference_on_cpu(card):
    ir, x = _bitvector_case("W32=8, C=8", 300)
    for spec in ("integer:bitvector", "flint:bitvector"):
        tt.reset_launches()
        eng = TreeEngine(ir, spec=spec)
        cpu = TreeEngine(ir, spec=spec.split(":")[0] + ":reference", device="cpu")
        for b in (1, 20, 37, 300):
            s, p = eng.predict_scores(x[:b])
            s_ref, p_ref = cpu.predict_scores(x[:b])
            np.testing.assert_array_equal(s, s_ref)
            np.testing.assert_array_equal(p, p_ref)
        assert tt.LAUNCHES["bitvector"] == 4


@pytest.mark.cuda
def test_sharded_plans_on_card_match_the_single_plan(card):
    """``tree_parallel`` over threaded ``cuda`` shards and over
    ``cuda|bitvector``, and ``row_parallel``, equal the single plan on the
    card; each shard launches its own kernels."""
    ir = _forest(21, 24, 7, 9, 4)
    x = np.random.default_rng(6).normal(size=(700, 9)).astype(np.float32)
    single = TreeEngine(ir, spec="integer:cuda")
    for spec, kernels in (("integer:cuda+tree_parallel:2", {"leaf_major"}),
                          ("integer:cuda|bitvector+tree_parallel:2",
                           {"leaf_major", "bitvector"}),
                          ("integer:cuda+row_parallel:2", {"leaf_major"}),
                          ("flint:cuda|bitvector", {"leaf_major", "bitvector"})):
        eng = TreeEngine(ir, spec=spec)
        ref = single if spec.startswith("integer") else TreeEngine(ir, spec="flint:cuda")
        tt.reset_launches()
        for b in (300, 700):
            s, p = eng.predict_scores(x[:b])
            s_ref, p_ref = ref.predict_scores(x[:b])
            np.testing.assert_array_equal(s, s_ref, err_msg=spec)
            np.testing.assert_array_equal(p, p_ref, err_msg=spec)
        assert {k for k, v in tt.LAUNCHES.items() if v} == kernels, spec
        assert all(b.device.type == "cuda" for b in eng.plan.backends)
        eng.close()


@pytest.mark.cuda
def test_two_threads_serve_a_plan_route_at_once(card):
    """Two threads call one ``cuda|bitvector`` tree-parallel engine at once
    (so four shard threads launch K1 and K5 together); every answer equals
    the CPU reference."""
    from concurrent.futures import ThreadPoolExecutor

    ir = _forest(22, 16, 7, 9, 4)
    eng = TreeEngine(ir, spec="integer:cuda|bitvector+tree_parallel:2")
    ref = TreeEngine(ir, spec="integer:reference", device="cpu")
    rng = np.random.default_rng(7)
    reqs = [rng.normal(size=(int(rng.choice([1, 20, 300])), 9)).astype(np.float32)
            for _ in range(40)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(2) as pool:
            outs = list(pool.map(eng.predict_scores, reqs))
    finally:
        sys.setswitchinterval(old)
    for x, (s, p) in zip(reqs, outs):
        s_ref, p_ref = ref.predict_scores(x)
        np.testing.assert_array_equal(s, s_ref)
        np.testing.assert_array_equal(p, p_ref)
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("option", [{}, {"include_float": False, "pack_leaves": True}],
                         ids=["plain", "stripped+packed"])
def test_artifact_routes_on_the_card(card, tmp_path, option):
    """An ITRF artifact registered by mmap serves K1 (``@leaf_major``), K2
    (batches under 64 rows), K5 (``integer:bitvector``) and the reference
    walk of ``packed_leaf`` on the card, each equal to the CPU reference;
    the file is left as it was."""
    ir = _forest(23, 20, 7, 9, 4)
    path = tmp_path / "m.itrf"
    ir.to_itrf(str(path), **option)
    before = path.read_bytes()
    mv = ModelRegistry().register_artifact("m", str(path))
    assert not mv.packed.feature.flags.writeable
    x = np.random.default_rng(8).normal(size=(700, 9)).astype(np.float32)
    ref = TreeEngine(ir, spec="integer:reference", device="cpu")
    for spec, kernels in (("integer:cuda@leaf_major", {"leaf_major", "gather"}),
                          ("integer:bitvector", {"bitvector"}),
                          ("integer:reference@packed_leaf", set())):
        eng = mv.engine(spec)
        tt.reset_launches()
        for b in (20, 700):
            s, p = eng.predict_scores(x[:b])
            s_ref, p_ref = ref.predict_scores(x[:b])
            np.testing.assert_array_equal(s, s_ref, err_msg=spec)
            np.testing.assert_array_equal(p, p_ref, err_msg=spec)
        assert {k for k, v in tt.LAUNCHES.items() if v} == kernels, spec
    assert path.read_bytes() == before


@pytest.mark.cuda
def test_remote_workers_on_the_card(card, tmp_path):
    """``remote_tree_parallel`` over two loopback workers started with
    ``--device cuda``: K1 and K5 launch inside the workers (their span
    records count them), the gateway process launches nothing, and the
    merged partials equal the CPU reference, through the array HELLO and the
    ITRF image."""
    import json

    from repro_torch.serve.worker import spawn_local_workers

    ir = _forest(24, 16, 7, 9, 4)
    path = tmp_path / "m.itrf"
    ir.to_itrf(str(path), include_float=False, pack_leaves=True)
    x = np.random.default_rng(9).normal(size=(700, 9)).astype(np.float32)
    ref = TreeEngine(ir, spec="integer:reference", device="cpu")
    spans = tmp_path / "spans"
    procs, addrs = spawn_local_workers(2, span_dir=str(spans))
    try:
        for model, hello in ((ir, "arrays"), (ForestIR.from_itrf(str(path)), "itrf")):
            eng = TreeEngine(model, spec="integer:cuda|bitvector+remote_tree_parallel:2",
                             plan_kwargs={"workers": addrs, "connect_timeout_s": 120.0,
                                          "deadline_ms": 120000.0})
            assert eng.plan.hello_format == hello
            assert [w["device"] for w in eng.plan.workers()] == ["cuda", "cuda"]
            tt.reset_launches()
            for b in (20, 700):
                s, p = eng.predict_scores(x[:b])
                s_ref, p_ref = ref.predict_scores(x[:b])
                np.testing.assert_array_equal(s, s_ref, err_msg=hello)
                np.testing.assert_array_equal(p, p_ref, err_msg=hello)
            assert not any(tt.LAUNCHES.values())
            eng.close()
    finally:
        for p in procs:
            p.kill()
            p.wait()
            p.stdout.close()
    launches = {}
    for f in spans.glob("worker_*.jsonl"):
        for line in f.read_text().splitlines():
            for k, v in json.loads(line)["launches"].items():
                launches[k] = launches.get(k, 0) + v
    assert launches["leaf_major"] > 0 and launches["gather"] > 0
    assert launches["bitvector"] > 0


@pytest.mark.cuda
@pytest.mark.requires_gcc
def test_host_c_shards_beside_the_card_kernels(card):
    """``cuda|native_c_table`` and ``bitvector|native_c_bitvector`` split the
    forest between a kernel on the card and emitted C on the host: K1 and K5
    launch, the C shard runs on the CPU, and the merged partials equal the
    CPU reference walk bit for bit."""
    ir = _forest(25, 16, 7, 9, 4)
    x = np.random.default_rng(10).normal(size=(700, 9)).astype(np.float32)
    for spec, kernels in (("integer:cuda|native_c_table+tree_parallel:2", {"leaf_major"}),
                          ("integer:bitvector|native_c_bitvector+tree_parallel:2",
                           {"bitvector"}),
                          ("flint:native_c_table|cuda+tree_parallel:2", {"leaf_major"})):
        eng = TreeEngine(ir, spec=spec)
        ref = TreeEngine(ir, spec=spec.split(":")[0] + ":reference", device="cpu")
        tt.reset_launches()
        for b in (300, 700):
            s, p = eng.predict_scores(x[:b])
            s_ref, p_ref = ref.predict_scores(x[:b])
            np.testing.assert_array_equal(s, s_ref, err_msg=spec)
            np.testing.assert_array_equal(p, p_ref, err_msg=spec)
        assert {k for k, v in tt.LAUNCHES.items() if v} == kernels, spec
        devices = {b.name: b.device.type for b in eng.plan.backends}
        assert devices == {n: ("cpu" if n.startswith("native_c") else "cuda")
                           for n in devices}, spec
        eng.close()


@pytest.mark.cuda
@pytest.mark.requires_gcc
def test_c_backend_with_no_device_runs_on_the_cpu(card, tmp_path):
    """A C backend built with ``device=None`` (which means ``cuda`` to every
    other backend) reports ``cpu``; so does a C route served by an engine on
    the card, and its autotune winner is written under ``torch-cpu:<isa>``,
    not under the card's name."""
    from repro_torch.backends import create_backend
    from repro_torch.ir.artifact import host_isa_key, inspect_itrf

    ir = _forest(26, 6, 5, 9, 4)
    assert create_backend("native_c_table", ir.materialize("ragged")).device.type == "cpu"
    path = str(tmp_path / "m.itrf")
    ir.to_itrf(path)
    reg = ModelRegistry()
    mv = reg.register_artifact("m", path)
    eng = mv.engine("integer:native_c_bitvector?autotune=true")
    assert eng.backend.device.type == "cpu"
    eng.warm(64)
    assert [k[4] for k in mv._tuned] == ["cpu"]
    reg.export_tuned("m", path)
    assert inspect_itrf(path)["tuned_hosts"] == [f"torch-cpu:{host_isa_key()}"]
    assert ModelRegistry().register_artifact("m", path)._tuned == mv._tuned
    x = np.random.default_rng(11).normal(size=(50, 9)).astype(np.float32)
    ref = TreeEngine(ir, spec="integer:reference", device="cpu")
    np.testing.assert_array_equal(eng.predict_scores(x)[0], ref.predict_scores(x)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-27b", "olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-2.7b", "llava-next-34b"])
def test_lm_smoke_prefill_and_decode_on_the_card_match_the_cpu(card, arch):
    """One seeded ``SMOKE`` model served by ``LMEngine`` on the card and on
    the CPU: prefill's and the decode step's logits within the reference's
    bf16 tolerance (0.08), argmax equal where the CPU's top-2 margin exceeds
    twice that."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import LMEngine

    tol = 0.08
    cfg = smoke_config(arch)
    params = tfm.init_params(cfg, 1, device="cpu")
    rng = np.random.default_rng(1)
    s = 32
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch = {"tokens": batch["tokens"][:, :s - cfg.vision_patches],
                 "patches": rng.normal(size=(2, cfg.vision_patches, cfg.frontend_dim)
                                       ).astype(np.float32)}
    prompt = dict(batch, tokens=batch["tokens"][:, :-1])
    out = {}
    for dev in (torch.device("cpu"), card):
        eng = LMEngine(cfg, params, max_seq=s, device=dev)
        logits, cache = eng.prefill(prompt)
        assert logits.device.type == dev.type
        dec, _ = eng.decode(cache, torch.from_numpy(batch["tokens"][:, -1:]).to(dev))
        out[dev.type] = (logits.cpu().numpy(), dec.cpu().numpy())
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() < tol
        srt = np.sort(want, axis=-1)
        sure = srt[:, -1] - srt[:, -2] > 2 * tol
        assert (got.argmax(-1) == want.argmax(-1))[sure].all()


@pytest.mark.cuda
def test_serve_driver_trees_on_the_card(card, capsys):
    """``python -m repro_torch.launch.serve --trees`` with its default
    device: the ``integer-cuda`` row is K1 on the card."""
    from repro_torch.launch.serve import main

    tt.reset_launches()
    main(["--trees", "--rows", "4000", "--n-trees", "8", "--depth", "5", "--reps", "1"])
    torch.cuda.synchronize()
    out = capsys.readouterr().out
    assert "integer-cuda" in out
    rows = [line for line in out.splitlines() if "agree_with_float=" in line]
    assert rows and all("agree_with_float=1.000000" in line for line in rows)
    assert tt.LAUNCHES["leaf_major"] + tt.LAUNCHES["gather"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b"])
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """One seeded ``SMOKE`` model's training step (2 microbatches) on the
    card and on the CPU from the same weights: the loss within 2e-3, each
    gradient leaf within a relative L2 difference of 3e-2 (the CPU tests'
    tolerances against the JAX package), the optimizer's step counted on
    the card, and no hand-written kernel launched."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import accumulate_grads, make_train_step
    from repro_torch.train.tree import flatten_with_paths, path_key, tree_map

    cfg = dataclasses.replace(smoke_config(arch), microbatches=2)
    params = tfm.init_params(cfg, 1, device="cpu")
    batch = pipeline_for(cfg, 4, 40, seed=1).batch_at(0)
    runs = {}
    tt.reset_launches()
    for dev in (torch.device("cpu"), card):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        loss, _ = accumulate_grads(cfg, p, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()}, 2)
        runs[dev.type] = (loss.item(), {path_key(k): q.grad.cpu().double()
                                        for k, q in flatten_with_paths(p)})
        _, ostate, m = make_train_step(cfg, opt.AdamWConfig())(p, opt.init_opt_state(p), batch)
        assert ostate["step"].device.type == dev.type and int(ostate["step"]) == 1
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    torch.cuda.synchronize()
    assert abs(runs["cuda"][0] - runs["cpu"][0]) < 2e-3
    for key, want in runs["cpu"][1].items():
        got = runs["cuda"][1][key]
        assert float((got - want).norm() / want.norm()) <= 3e-2, key
    assert not any(tt.LAUNCHES.values())


@pytest.mark.cuda
def test_integer_psum_on_card_ranks_equals_cpu_ranks(card, tmp_path):
    """``integer_psum`` on two gloo ranks holding CUDA tensors gives the
    bits two CPU ranks give, within the reference's error bound."""
    from repro_torch.train.intreeger_allreduce import quantization_error_bound
    from torch_dist_ranks import psum_rank, run_ranks

    data = np.random.default_rng(4).normal(scale=5.0, size=(2, 1 << 16)).astype(np.float32)
    np.save(tmp_path / "data.npy", data)
    sums = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        out.mkdir()
        run_ranks(psum_rank, 2, str(tmp_path / "data.npy"), str(out), dev, [[0, 1], [1, 0]])
        sums[dev] = np.stack([np.load(out / f"psum_{r}.npy") for r in range(2)])
    assert sums["cuda"].view(np.uint32).tobytes() == sums["cpu"].view(np.uint32).tobytes()
    assert all(np.array_equal(s.view(np.uint32), sums["cpu"][0, 0].view(np.uint32))
               for s in sums["cpu"].reshape(-1, data.shape[1]))
    err = np.abs(sums["cuda"][0, 0] - data.astype(np.float64).sum(axis=0)).max()
    assert err <= quantization_error_bound(2, float(np.abs(data).max()))


@pytest.mark.cuda
def test_one_card_nccl_mesh_gives_the_bits_of_no_mesh(card):
    """A (1, 1) mesh over an NCCL group of this process alone on the card:
    the tree serving step (through the mesh's ``DTensor``s) and each
    ``_attn_core`` case give the bits they give without a mesh, with no
    collective."""
    import torch.distributed as dist

    from repro_torch.core.serving import tree_serve_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import _attn_core
    from repro_torch.sharding.ops import gather, use_mesh
    from torch_dist_ranks import ATTN_CASES, comm_count

    rng = np.random.default_rng(5)
    keys = float_to_key(torch.from_numpy(rng.normal(size=(4096, 12)).astype(np.float32)))
    packed = _forest(6, 16, 8, 12, 4).materialize("padded")
    tables = {k: getattr(packed, k) for k in ("feature", "threshold_key", "left", "right",
                                              "leaf_fixed")}
    attn = {name: [torch.from_numpy(rng.normal(size=s)).to(card, torch.bfloat16)
                   for s in (qs, ks, ks)] for name, (qs, ks, _) in ATTN_CASES.items()}

    def run(mesh):
        out = {}
        (acc, preds), comms = comm_count(
            lambda: tree_serve_step(tables, keys, packed.max_depth, device=card))
        out["acc"], out["preds"] = gather(acc).view(torch.int32), gather(preds)
        out["tree_comms"] = comms
        for name, (_, _, kw) in ATTN_CASES.items():
            out[name] = _attn_core(*attn[name], mesh=mesh, **kw)
        torch.cuda.synchronize()
        return out

    want = run(None)
    with make_host_mesh(device=card) as mesh, use_mesh(mesh):
        assert dist.get_backend() != "gloo" and mesh.device_type == "cuda"
        got = run(mesh)
    assert not dist.is_initialized()
    assert got["tree_comms"] == want["tree_comms"] == 0
    for key in ("acc", "preds", *ATTN_CASES):
        assert got[key].device.type == "cuda"
        assert torch.equal(got[key], want[key]), key


@pytest.mark.cuda
def test_mesh_branches_on_card_ranks_match_cpu_ranks(card, tmp_path):
    """Four gloo ranks as a (data 2, model 2) mesh, holding CUDA tensors
    (their collectives staged through the host), against four CPU ranks on
    the same inputs: the tree step bit for bit with no collective, each
    attention core within the reference's 0.02, the MoE block within 0.05
    (also on each rank's rows, as serving runs it),
    each smoke model's tensor-parallel train step's loss within 2e-3 (the
    card-against-CPU tolerance of the training tests), each rank holding
    only its parameters' blocks and gathering none whose rule splits it
    over ``model`` over ``model``."""
    from torch_dist_ranks import (ATTN_CASES, MOE_CAPACITY, TRAIN_ARCHS, mesh_rank, run_ranks,
                                  write_mesh_inputs)

    write_mesh_inputs(tmp_path / "in")
    runs = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        out.mkdir()
        run_ranks(mesh_rank, 4, str(tmp_path / "in"), str(out), (2, 2), ("data", "model"), dev)
        runs[dev] = [dict(np.load(out / f"mesh_{r}.npz")) for r in range(4)]
    for c, g in zip(runs["cpu"], runs["cuda"]):
        assert g["tree_comms"] == 0 and g["staged"] > 0 and c["staged"] == 0
        assert np.array_equal(g["tree_acc"], c["tree_acc"])
        assert np.array_equal(g["tree_preds"], c["tree_preds"])
        for name in ATTN_CASES:
            assert np.abs(g[f"attn_{name}"] - c[f"attn_{name}"]).max() < 0.02, name
        for cf in MOE_CAPACITY:
            assert np.abs(g[f"moe_y_{cf}"] - c[f"moe_y_{cf}"]).max() < 0.05, cf
            for tag in ("prefill", "decode"):  # on each rank's rows
                assert np.abs(g[f"moe_rows_{tag}_{cf}"] - c[f"moe_rows_{tag}_{cf}"]).max() < 0.05
        for arch in TRAIN_ARCHS:
            key = f"train[{arch}]_"
            assert abs(float(g[key + "loss"]) - float(c[key + "loss"])) < 2e-3, arch
            # fault D: the card's ranks hold only their blocks, as the CPU's do
            assert int(g[key + "block_bytes_held"]) == int(g[key + "block_bytes_want"])
            assert g[key + "block_grads_match"] and not g[key + "block_grads_left"]
            assert g[key + "split_shapes_ok"]
            assert set(g[key + "whole_over_model"].tolist()) == \
                set(c[key + "whole_over_model"].tolist())
