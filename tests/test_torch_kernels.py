"""The port's kernel module on the CPU: the plain versions of K1 (bounded
walk over leaf_major tables), K2 (per-level gather walk) and K3 (the
masked one-hot walk) against the JAX package's Pallas kernels (interpret
mode) and both oracles — bit-identical uint32 partials, including row and
tree padding, degenerate forests, and for K3 malformed tables.
The CUDA kernels themselves are held against these plain versions on the
card by ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_cases import DEGENERATE_FORESTS, forest_from_trees
from repro.core.flint import float_to_key as jax_float_to_key
from repro.core.packing import pack_forest
from repro.ir import ForestIR as JForestIR
from repro.kernels.ops import tree_predict_integer as jax_tree_predict_integer
from repro.kernels.ref import tree_predict_integer_ref as jax_ref
from repro.trees.cart import TreeArrays
from repro.trees.forest import RandomForestClassifier
from repro_torch.core.flint import float_to_key
from repro_torch.ir import ForestIR
from repro_torch.ir.forest_ir import ARRAY_DTYPES
from repro_torch.kernels import tree_traverse as tt
from repro_torch.kernels.ops import (
    fits,
    packed_predict_integer,
    pick_blocks,
    pick_blocks_candidates,
    resident_ctas,
    tree_predict_integer,
)
from repro_torch.kernels.ref import tree_predict_integer_ref
from test_torch_cuda import malformed_case, malformed_cases


def _forest(n_trees, depth, n_features, n_classes, seed=0, n=1500):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n_features)).astype(np.float32)
    y = rng.integers(0, n_classes, n)
    y = np.where(X[:, 0] > 0.5, (y + 1) % n_classes, y)
    rf = RandomForestClassifier(n_estimators=n_trees, max_depth=depth, seed=seed).fit(X, y)
    return rf, X


def _tables(packed):
    return (packed.feature, packed.threshold_key, packed.left, packed.right,
            packed.leaf_fixed)


def _jax(x, packed, impl, **kw):
    keys = jax_float_to_key(jnp.asarray(x))
    extra = {"internal_counts": packed.internal_counts} if impl == "leaf_major" else {}
    out = jax_tree_predict_integer(
        keys, *(jnp.asarray(a) for a in _tables(packed)),
        depth=packed.max_depth, impl=impl, **extra, **kw)
    return np.asarray(out)


def _port(x, packed, impl, **kw):
    keys = float_to_key(torch.from_numpy(x))
    extra = {"internal_counts": packed.internal_counts} if impl == "leaf_major" else {}
    out = tree_predict_integer(keys, *_tables(packed), depth=packed.max_depth,
                               impl=impl, device="cpu", **extra, **kw)
    assert out.dtype == torch.uint32
    return out.numpy()


def _oracles(x, packed):
    """(JAX oracle, port oracle) partials over the same tables."""
    ref_j = np.asarray(jax_ref(jax_float_to_key(jnp.asarray(x)),
                               *(jnp.asarray(a) for a in _tables(packed)),
                               packed.max_depth))
    ref_t = tree_predict_integer_ref(
        float_to_key(torch.from_numpy(x)),
        *(torch.from_numpy(a) for a in _tables(packed)), packed.max_depth).numpy()
    np.testing.assert_array_equal(ref_t, ref_j)
    return ref_j


@pytest.mark.parametrize("impl", ["gather", "leaf_major", "onehot"])
@pytest.mark.parametrize(
    "n_trees,depth,n_features,n_classes",
    [(3, 3, 4, 2), (7, 5, 7, 7), (12, 6, 11, 3), (5, 4, 87, 2)],
)
def test_plain_matches_pallas_sweep(impl, n_trees, depth, n_features, n_classes):
    """217 rows (not a block multiple) and block_t=5 (tree padding with
    inert trees) through both the port's plain version and the Pallas
    kernel; both equal both oracles."""
    rf, X = _forest(n_trees, depth, n_features, n_classes)
    ir = JForestIR.from_forest(rf)
    packed = ir.materialize("leaf_major" if impl == "leaf_major" else "padded")
    x = X[:217]
    ref = _oracles(x, packed)
    blocks = dict(block_b=64, block_t=min(5, n_trees))
    jax_out = _jax(x, packed, impl, **blocks)
    port_out = _port(x, packed, impl, **blocks)
    np.testing.assert_array_equal(jax_out, ref)
    np.testing.assert_array_equal(port_out, ref)
    assert port_out.dtype == np.uint32


@pytest.mark.parametrize("blocks", [dict(block_b=32, block_t=1), dict(block_b=128, block_t=3),
                                    dict(block_b=None, block_t=None)])
@pytest.mark.parametrize("rows", [1, 63, 200])
def test_plain_block_shapes(blocks, rows):
    """Any (rows per block, trees per block, rows) combination, including the
    H100 block choice, gives the same partials from both plain versions."""
    rf, X = _forest(7, 4, 5, 3, seed=2)
    ir = ForestIR.from_forest(rf)
    lm, padded = ir.materialize("leaf_major"), ir.materialize("padded")
    x = X[:rows]
    ref = _oracles(x, padded)
    np.testing.assert_array_equal(_port(x, lm, "leaf_major", **blocks), ref)
    np.testing.assert_array_equal(_port(x, padded, "gather", **blocks), ref)
    np.testing.assert_array_equal(_port(x, lm, "gather", **blocks), ref)


@pytest.mark.parametrize("name", sorted(DEGENERATE_FORESTS))
def test_plain_degenerate_forests(name):
    """Stumps (no internal prefix: K1 does no walk), T == 1 and a
    depth-skewed mix, against the Pallas kernels."""
    ir = JForestIR.from_forest(DEGENERATE_FORESTS[name]())
    x = np.random.default_rng(5).normal(0.0, 6.0, (33, ir.n_features)).astype(np.float32)
    lm, padded = ir.materialize("leaf_major"), ir.materialize("padded")
    ref = _oracles(x, padded)
    for impl, packed in (("leaf_major", lm), ("gather", padded), ("onehot", padded),
                         ("onehot", lm)):
        np.testing.assert_array_equal(_jax(x, packed, impl, block_b=16, block_t=2), ref)
        np.testing.assert_array_equal(_port(x, packed, impl, block_b=16, block_t=2), ref)


def test_single_tree_partials_above_2_31():
    """One tree with leaf probability 1.0 quantizes at scale 2^32 - 1, so
    every partial is >= 2^31: the uint32 must come through unsigned."""
    tree = TreeArrays(
        feature=np.array([0, -1, -1], np.int32),
        threshold=np.array([0.0, 0.0, 0.0], np.float32),
        left=np.array([1, 1, 2], np.int32),
        right=np.array([2, 1, 2], np.int32),
        leaf_probs=np.array([[0, 0], [1.0, 0.0], [0.25, 0.75]], np.float64),
        depth=1,
    )
    ir = JForestIR.from_forest(forest_from_trees([tree], 2, 1))
    x = np.array([[-1.0], [1.0], [0.0]], np.float32)
    ref = _oracles(x, ir.materialize("padded"))
    assert ref.max() >= 2 ** 31 and ref[0, 0] == 2 ** 32 - 1
    for impl, layout in (("leaf_major", "leaf_major"), ("gather", "padded")):
        packed = ir.materialize(layout)
        np.testing.assert_array_equal(_port(x, packed, impl), ref)
        np.testing.assert_array_equal(_jax(x, packed, impl, block_b=8), ref)


def test_packed_entry_point_auto_impl(small_packed, shuttle_small):
    """``impl="auto"`` resolves per layout, a pinned scan re-materializes a
    padded artifact, and all agree with the reference ensemble."""
    from repro.core.ensemble import predict_integer

    _, _, Xte, _ = shuttle_small
    acc_ref, pred_ref = predict_integer(small_packed, Xte[:150])
    ref_ir = small_packed.to_ir()
    ir = ForestIR.from_numpy({k: getattr(ref_ir, k) for k in ARRAY_DTYPES},
                             n_trees=ref_ir.n_trees, n_classes=ref_ir.n_classes,
                             n_features=ref_ir.n_features)
    for model, kw in ((ir, {}), (ir.materialize("leaf_major"), {}),
                      (ir.materialize("padded"), {}),
                      (ir.materialize("padded"), {"impl": "leaf_major"})):
        acc, pred = packed_predict_integer(model, Xte[:150], device="cpu", **kw)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))
        np.testing.assert_array_equal(pred.numpy(), np.asarray(pred_ref))


def test_onehot_and_missing_internal_counts_raise():
    """``impl="onehot"`` (K3) now runs and equals the JAX kernel; a scan
    without ``internal_counts`` still raises."""
    rf, X = _forest(3, 3, 4, 2)
    packed = ForestIR.from_forest(rf).materialize("padded")
    np.testing.assert_array_equal(_port(X[:4], packed, "onehot"),
                                  _jax(X[:4], packed, "onehot", block_b=8))
    with pytest.raises(ValueError, match="unknown impl"):
        _port(X[:4], packed, "scan")
    with pytest.raises(ValueError, match="internal_counts"):
        tree_predict_integer(float_to_key(torch.from_numpy(X[:4])), *_tables(packed),
                             depth=packed.max_depth, impl="leaf_major", device="cpu")


def _malformed_partials(impl, blocks):
    x, tables, depth = malformed_case()
    keys = jax_float_to_key(jnp.asarray(x))
    jax_out = np.asarray(jax_tree_predict_integer(
        keys, *(jnp.asarray(a) for a in tables), depth=depth, impl=impl, **blocks))
    if impl != "onehot":
        return jax_out, None
    port = tree_predict_integer(float_to_key(torch.from_numpy(x)), *tables, depth=depth,
                                impl=impl, device="cpu", **blocks)
    return jax_out, port.numpy()


@pytest.mark.parametrize("blocks", [dict(block_b=64, block_t=1), dict(block_b=128, block_t=2)])
def test_onehot_reads_zero_outside_the_tables(blocks):
    """K3's own function: on a table with a child >= N, a child < 0 and a
    feature >= F, every read outside its table reads 0, as the TPU's
    compare-iota gathers do.  The port's K3 equals the JAX kernel there."""
    jax_onehot, port_onehot = _malformed_partials("onehot", blocks)
    np.testing.assert_array_equal(port_onehot, jax_onehot)
    assert port_onehot.dtype == np.uint32


def test_gather_and_onehot_differ_on_a_malformed_table():
    """On well-formed tables K2 and K3 give the same bits; on the malformed
    table they do not, so the two walks are two functions."""
    blocks = dict(block_b=64, block_t=2)
    jax_gather, _ = _malformed_partials("gather", blocks)
    jax_onehot, port_onehot = _malformed_partials("onehot", blocks)
    differ = (jax_gather != jax_onehot).any(axis=1)
    assert differ.mean() > 0.5
    np.testing.assert_array_equal(port_onehot, jax_onehot)
    x, tables, depth = malformed_case()
    with pytest.raises(RuntimeError):  # the gather walk indexes past the table
        tree_predict_integer(float_to_key(torch.from_numpy(x)), *tables, depth=depth,
                             impl="gather", device="cpu", **blocks)


@pytest.mark.parametrize("case", sorted(malformed_cases()))
@pytest.mark.parametrize("blocks", [dict(block_b=64, block_t=1), dict(block_b=128, block_t=2)])
def test_onehot_wrapper_takes_quads_of_malformed_tables(case, blocks):
    """K3's wrapper on the CPU, handed the node quads of a malformed table
    (reads that leave the tables; walks that end outside them at C = 3 and
    C = 8), equals the JAX kernel with ``impl="onehot"`` bit for bit."""
    x, tables, depth = malformed_cases()[case]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    quads = tt.pack_node_quads(*(t(a) for a in tables[:4]))
    before = dict(tt.LAUNCHES)
    out = tt.tree_traverse_onehot(float_to_key(t(x)), quads, t(tables[4]), depth=depth,
                                  **blocks)
    assert tt.LAUNCHES == before and out.dtype == torch.uint32
    jax_out = np.asarray(jax_tree_predict_integer(
        jax_float_to_key(jnp.asarray(x)), *(jnp.asarray(a) for a in tables), depth=depth,
        impl="onehot", **blocks))
    np.testing.assert_array_equal(out.numpy(), jax_out)


def test_wrappers_take_plain_versions_on_cpu_only():
    """CPU tensors go to the plain versions and launch nothing."""
    rf, X = _forest(3, 3, 4, 2)
    ir = ForestIR.from_forest(rf)
    lm = ir.materialize("leaf_major")
    before = dict(tt.LAUNCHES)
    keys = float_to_key(torch.from_numpy(X[:50]))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = tt.tree_traverse_leaf_major(
        keys, tt.pack_node_quads(*(t(a) for a in _tables(lm)[:4])),
        t(lm.internal_counts), t(lm.leaf_fixed), block_b=128, block_t=2)
    assert tt.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(), _oracles(X[:50], lm))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tt._cuda_args(keys, {"feature": t(lm.feature)})


def test_h100_block_choice():
    # the serve_64k batch of the 87-feature model: 512 row blocks of 128
    # rows; 132 SMs hold 5 CTAs each of 44,544-byte tiles, so four waves
    # are 2,640 CTAs: 6 chunks of 22 trees, rounded up to whole groups of
    # 4 walks, 24
    assert resident_ctas(128, 87) == 5
    assert pick_blocks(65_536, 128, 87, 132) == (128, 24)
    assert pick_blocks(10 ** 7, 128, 87, 132) == (128, 128)
    # small batches: one group of walks per CTA, the least a CTA takes
    assert pick_blocks(1000, 128, 87, 132) == (128, 4)
    assert pick_blocks(20, 128, 87, 132) == (128, 4)
    assert pick_blocks(1, 128, 87, 132) == (128, 4)
    assert pick_blocks(1000, 1, 87, 132) == (128, 1)
    assert pick_blocks(1000, 3, 87, 132) == (128, 3)
    # launches that stage nothing (rows too wide to stage) keep the first
    # version's rule: about two waves of 16 CTAs per SM
    assert pick_blocks(65_536, 128, 4000, 132) == (128, 15)
    assert pick_blocks(1, 128, 4000, 132) == (128, 1)


@pytest.mark.parametrize("impl,shape", [("leaf_major", (128, 24)), ("gather", (128, 24)),
                                        ("onehot", (128, 24))])
def test_entry_point_launches_each_kernel_at_its_own_shape(monkeypatch, impl, shape):
    """``tree_predict_integer`` hands each kernel ``pick_blocks``' shape:
    all three stage their row tile at 87 features, so at the serve_64k
    batch each takes the staged rule (128 x 24), K3 too."""
    from repro_torch.kernels import ops

    seen = {}

    def wrapper(name):
        def launch(*args, block_b, block_t, **kw):
            seen[name] = (block_b, block_t)
            return torch.zeros((args[0].shape[0], 1), dtype=torch.uint32)
        return launch

    for name in ("leaf_major", "gather", "onehot"):
        monkeypatch.setattr(ops, f"tree_traverse_{name}", wrapper(name))
    monkeypatch.setattr(ops, "_sm_count", lambda dev: 132)
    keys = torch.zeros((65_536, 87), dtype=torch.int32)
    tables = [torch.zeros((128, 3), dtype=torch.int32) for _ in range(4)]
    ops.tree_predict_integer(keys, *tables, torch.zeros((128, 3, 1), dtype=torch.int32),
                             depth=1, impl=impl, device="cpu",
                             internal_counts=torch.zeros(128, dtype=torch.int32))
    assert seen == {impl: shape} and shape == pick_blocks(65_536, 128, 87, 132)


def test_entry_point_rejects_quads_of_other_tables():
    """Quads handed to ``tree_predict_integer`` must pack its (T, N) tables."""
    rf, X = _forest(3, 3, 4, 2)
    p = ForestIR.from_forest(rf).materialize("padded")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tables = [t(a) for a in _tables(p)[:4]]
    keys = float_to_key(torch.from_numpy(X[:8]))
    with pytest.raises(ValueError, match="do not pack"):
        tree_predict_integer(keys, *tables, t(p.leaf_fixed), depth=p.max_depth,
                             device="cpu", quads=tt.pack_node_quads(*tables)[:1])
    out = tree_predict_integer(keys, *tables, t(p.leaf_fixed), depth=p.max_depth,
                               device="cpu", quads=tt.pack_node_quads(*tables))
    np.testing.assert_array_equal(out.numpy(), _oracles(X[:8], p))


@pytest.mark.parametrize("n_features", [1, 87, 1815, 1816, 4000])
@pytest.mark.parametrize("b,t", [(1, 128), (20, 128), (1000, 128), (65_536, 128), (256, 6)])
def test_cta_shapes_fit_shared_memory(n_features, b, t):
    """Every shape the heuristic and the autotune grid offer fits a CTA's
    227 KB; 32-row tiles fit up to 1,815 features (1,816 pads to 1,817
    words, one past the limit), and wider rows take the global-x variant."""
    staged = tt.stages_x(n_features)
    assert staged == (n_features <= 1815)
    cands = pick_blocks_candidates(b, t, n_features, 132)
    assert cands[0] == pick_blocks(b, t, n_features, 132)
    for bb, bt in cands:
        assert fits(bb, n_features) and 32 <= bb <= tt.MAX_TILE_ROWS and 1 <= bt <= t
        if staged:
            assert tt.tile_bytes(bb, n_features) <= tt.SMEM_PER_CTA == 232_448
        tt.check_tile_shape(bb, n_features, tt.default_walks(bt), staged)
    if n_features == 1815:
        assert cands[0][0] == 32  # only a 32-row tile fits


def test_tile_shapes_that_do_not_fit_raise():
    """The wrapper's check raises on a tile over 227 KB, a CTA over 512 rows
    or an unknown walk count; it never shrinks the shape."""
    assert tt.tile_stride(87) == 87 and tt.tile_stride(64) == 65
    assert tt.tile_bytes(128, 87) == 44_544
    tt.check_tile_shape(512, 87, 4, True)
    tt.check_tile_shape(512, 4000, 2, False)
    with pytest.raises(ValueError, match="shared memory"):
        tt.check_tile_shape(64, 1000, 4, True)
    with pytest.raises(ValueError, match="rows per CTA"):
        tt.check_tile_shape(1024, 87, 4, True)
    for walks in (3, 8):
        with pytest.raises(ValueError, match="walks"):
            tt.check_tile_shape(128, 87, walks, True)
    assert [tt.default_walks(n) for n in (1, 2, 3, 5, 128)] == [1, 2, 2, 4, 4]


def _quad_cases():
    rf, _ = _forest(6, 5, 9, 3, seed=7)
    yield "trained", ForestIR.from_forest(rf)
    for name in sorted(DEGENERATE_FORESTS):
        ref_ir = JForestIR.from_forest(DEGENERATE_FORESTS[name]())
        yield name, ForestIR.from_numpy(
            {k: getattr(ref_ir, k) for k in ARRAY_DTYPES}, n_trees=ref_ir.n_trees,
            n_classes=ref_ir.n_classes, n_features=ref_ir.n_features)


@pytest.mark.parametrize("layout", ["padded", "leaf_major"])
def test_pack_node_quads_equals_the_stacked_tables(layout):
    """quads[t, n] == (feature, threshold_key, left, right)[t, n], int32 and
    contiguous, on a trained forest and on every degenerate forest."""
    for name, ir in _quad_cases():
        p = ir.materialize(layout)
        tables = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                  (p.feature, p.threshold_key, p.left, p.right)]
        quads = tt.pack_node_quads(*tables)
        assert quads.shape == (*p.feature.shape, 4), name
        assert quads.dtype == torch.int32 and quads.is_contiguous()
        np.testing.assert_array_equal(
            quads.numpy(), np.stack([p.feature, p.threshold_key, p.left, p.right], -1))


def test_cuda_backend_packs_quads_once(monkeypatch):
    """The engine path packs the node quads once per backend and hands the
    same tensor to every request, the one-hot route (K3) too."""
    from repro_torch.backends import cuda as cuda_backend
    from repro_torch.serve import TreeEngine

    packs, seen = [], []
    real_pack, real_predict = cuda_backend.pack_node_quads, cuda_backend.tree_predict_integer

    def pack(*tables):
        packs.append(tables[0].shape)
        return real_pack(*tables)

    def predict(*args, **kw):
        seen.append(kw["quads"])
        return real_predict(*args, **kw)

    monkeypatch.setattr(cuda_backend, "pack_node_quads", pack)
    monkeypatch.setattr(cuda_backend, "tree_predict_integer", predict)
    rf, X = _forest(5, 4, 6, 3, seed=3)
    ir = ForestIR.from_forest(rf)
    eng = TreeEngine(ir, spec="integer:cuda@leaf_major", device="cpu")
    for b in (1, 20, 100, 300):  # K2 under 64 rows, K1 above
        eng.predict_scores(X[:b])
    assert len(packs) == 1 and len(seen) == 4
    assert all(q is eng.backend._quads for q in seen)
    np.testing.assert_array_equal(
        eng.backend._quads.numpy(),
        np.stack([getattr(ir.materialize("leaf_major"), k) for k in
                  ("feature", "threshold_key", "left", "right")], -1))
    onehot = TreeEngine(ir, spec="integer:cuda@padded?impl=onehot", device="cpu")
    for b in (10, 100):
        onehot.predict_scores(X[:b])
    assert len(packs) == 2 and len(seen) == 6
    assert all(q is onehot.backend._quads for q in seen[4:])
    np.testing.assert_array_equal(
        onehot.backend._quads.numpy(),
        np.stack([getattr(ir.materialize("padded"), k) for k in
                  ("feature", "threshold_key", "left", "right")], -1))
