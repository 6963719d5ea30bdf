"""The port's QuickScorer route against the JAX package's, bit for bit.

Every ``BitvectorEnsemble`` array, the tree-major slot grid of
``bitvector_device_arrays``, the partials of ``bitvector_plain`` (K5's plain
version, the one the CPU runs) and the scores of the ``flint:bitvector`` and
``integer:bitvector`` engines equal the JAX package's, with tolerance 0, on
trained forests, on ``forest_cases.DEGENERATE_FORESTS``, on a two-word
layout (a 71-leaf chain, as ``tests/test_bitvector.py``), on a layout wider
than 32 words (a 1,101-leaf chain: W32 = 36) and on ``ForestIR.subset``
slices.  The chains' rows spread over the chain's whole threshold range, so
exit leaves land in every word, the high ones included.  Inputs come from
seeds through numpy; the forest crosses packages through
``ForestIR.from_numpy``.

The records K5 reads (``pack_bitvector_tables``) unpack to the slot grid
bit for bit on every case, on chains of 8 and 32 words, on all-stump
forests, on subset slices and on random clear sets that are no leaf range
(``chip_smoke.random_span_tables``); on those random tables, whose
features and leaf rows stray below 0 and past their tables, the plain
version equals ``_bitvector_partials``, and so do the records with the
features wrapped as the wrapper hands them to K5.  K5's CTA rule and both
wrappers' shape checks keep the tree chunks within grid.y's 65,535 CTAs
for any forest.  ``chip_smoke.bitvector_exit_work``, which K5's bound
reads, equals a count made record by record.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from forest_cases import DEGENERATE_FORESTS, chain_tree, forest_from_trees, stump
from repro.ir import ForestIR as JForestIR
from repro.kernels import bitvector as jbv
from repro.serve.engine import TreeEngine as JTreeEngine
from repro_torch.backends import create_backend
from repro_torch.core.flint import float_to_key
from repro_torch.ir import ForestIR
from repro_torch.ir.forest_ir import ARRAY_DTYPES
from repro_torch.kernels import bitvector as kbv
from repro_torch.kernels import tree_traverse as tt
from repro_torch.serve import TreeEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import bitvector_exit_work, random_span_tables  # noqa: E402

_TABLES = ("entry_feat", "entry_key", "inv_mask", "init_mask", "leaf_off", "leaf_fixed")


def _trained(seed, n_trees=8, depth=6, n_classes=5, n_features=7):
    from repro.trees.forest import RandomForestClassifier

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((1200, n_features)).astype(np.float32)
    y = rng.integers(0, n_classes, 1200)
    return RandomForestClassifier(n_estimators=n_trees, max_depth=depth,
                                  seed=seed).fit(X, y)


#: case -> (a function that makes the forest, half-width of the rows' uniform spread)
CASES = {
    "trained0": (lambda: _trained(0), 3.0),
    "trained1_c2_deep": (lambda: _trained(1, n_trees=5, depth=9, n_classes=2,
                                          n_features=5), 3.0),
    **{name: (mk, 14.0) for name, mk in DEGENERATE_FORESTS.items()},
    "multiword": (lambda: forest_from_trees(
        [chain_tree(70, 3), chain_tree(5, 3), stump([0.2, 0.3, 0.5])], 3, 4), 40.0),
    "wide": (lambda: forest_from_trees([chain_tree(1100, 4), chain_tree(9, 4)], 4, 3),
             600.0),
}


def _port(jir):
    return ForestIR.from_numpy({k: getattr(jir, k) for k in ARRAY_DTYPES},
                               n_trees=jir.n_trees, n_classes=jir.n_classes,
                               n_features=jir.n_features, quant_scale=jir.quant_scale)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(case name, reference IR, port IR, rows of 1, 7, 64 and 131)."""
    build, spread = CASES[request.param]
    jir = JForestIR.from_forest(build())
    rng = np.random.default_rng(len(request.param))
    rows = {b: rng.uniform(-spread, spread, (b, jir.n_features)).astype(np.float32)
            for b in (1, 7, 64, 131)}
    return request.param, jir, _port(jir), rows


def _u32(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).cpu().numpy().view(np.uint32)
    return t.cpu().numpy()


def _assert_same_layout(port, ref, label):
    for name, value in vars(ref).items():
        if isinstance(value, np.ndarray):
            got = getattr(port, name)
            assert got.dtype == value.dtype, f"{label}.{name} dtype"
            np.testing.assert_array_equal(got, value, err_msg=f"{label}.{name}")
    for name in ("words", "n_trees", "n_classes", "n_features", "max_depth",
                 "layout", "quant_scale", "scale", "total_entries", "total_leaves"):
        assert getattr(port, name) == getattr(ref, name), f"{label}.{name}"
    assert port.nbytes_integer() == ref.nbytes_integer()
    assert port.nbytes_float() == ref.nbytes_float()


def test_layout_arrays_match_reference(case):
    name, jir, ir, _ = case
    _assert_same_layout(ir.materialize("bitvector"), jir.materialize("bitvector"), name)
    # the port's own quantization gives the same tables
    if name.startswith("trained") or name in DEGENERATE_FORESTS:
        forest = CASES[name][0]()
        _assert_same_layout(ForestIR.from_forest(forest).materialize("bitvector"),
                            jir.materialize("bitvector"), f"{name} from_forest")


def test_wide_layouts_are_wider_than_one_register_chunk():
    """The cases cover a two-word layout and one wider than 32 uint32 words
    (the register chunk of K5's first design, and the width of a depth-10
    tree), whose high words are really reached."""
    wide = ForestIR.from_forest(CASES["wide"][0]()).materialize("bitvector")
    assert 2 * wide.words > 32 and wide.words == 18
    assert ForestIR.from_forest(CASES["multiword"][0]()).materialize("bitvector").words == 2


def test_device_arrays_match_reference(case):
    name, jir, ir, _ = case
    ref = jbv.bitvector_device_arrays(jir.materialize("bitvector"))
    got = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    assert got.pop("n_entry_slots") == ref.pop("n_entry_slots")
    assert set(got) == set(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        port = _u32(got[key])
        assert port.dtype == value.dtype, f"{name}.{key} dtype"
        np.testing.assert_array_equal(port, value, err_msg=f"{name}.{key}")


@pytest.mark.parametrize("chunk_rows", [None, 1, 5, 64], ids=lambda c: f"chunk{c}")
def test_plain_matches_bitvector_partials(case, chunk_rows):
    """K5's plain version equals ``_bitvector_partials`` at 1, 7, 64 and 131
    rows, with row chunks that divide the batch and that do not."""
    name, jir, ir, rows = case
    ref_arrays = jbv.bitvector_device_arrays(jir.materialize("bitvector"))
    n_slots = ref_arrays.pop("n_entry_slots")
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    for b, x in rows.items():
        keys = float_to_key(torch.from_numpy(x))
        ref = np.asarray(jbv._bitvector_partials(ref_arrays, keys.numpy(), n_slots))
        got = kbv.bitvector_plain(keys, *(arrays[k] for k in _TABLES),
                                  chunk_rows=chunk_rows)
        assert got.dtype == torch.uint32 and got.shape == ref.shape
        np.testing.assert_array_equal(_u32(got), ref, err_msg=f"{name} b={b}")


def test_wrapper_on_the_cpu_runs_the_plain_version(case):
    """On CPU tensors the wrapper takes the plain version on the dense grid
    its tables keep and counts no launch; it takes the packed tables
    only."""
    _, _, ir, rows = case
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    keys = float_to_key(torch.from_numpy(rows[64]))
    packed = kbv.pack_bitvector_tables(*(arrays[k] for k in _TABLES), device="cpu")
    assert all(a is arrays[k] for a, k in zip(packed.dense, _TABLES))
    before = dict(tt.LAUNCHES)
    out = kbv.tree_bitvector(keys, packed)
    assert tt.LAUNCHES == before
    with pytest.raises(TypeError, match="BitvectorTables"):
        kbv.tree_bitvector(keys, [arrays[k] for k in _TABLES])
    np.testing.assert_array_equal(
        _u32(out), _u32(kbv.bitvector_plain(keys, *(arrays[k] for k in _TABLES))))


@pytest.mark.parametrize("mode", ["integer", "flint"])
def test_engine_routes_match(case, mode):
    """``mode:bitvector`` engine scores, predictions and partials equal the
    JAX ``TreeEngine``'s on the same route."""
    name, jir, ir, rows = case
    ref = JTreeEngine(jir, spec=f"{mode}:bitvector")
    port = TreeEngine(ir, spec=f"{mode}:bitvector", device="cpu")
    assert port.layout == ref.layout == "bitvector" and port.backend_name == "bitvector"
    for b, x in rows.items():
        s_ref, p_ref = (np.asarray(a) for a in ref.predict_scores(x))
        s, p = port.predict_scores(x)
        assert s.dtype == s_ref.dtype and p.dtype == p_ref.dtype
        np.testing.assert_array_equal(s, s_ref, err_msg=f"{name} {mode} b={b}")
        np.testing.assert_array_equal(p, p_ref, err_msg=f"{name} {mode} b={b}")
        np.testing.assert_array_equal(port.predict_partials(x),
                                      np.asarray(ref.predict_partials(x)))


@pytest.mark.parametrize("bounds", [(0, 1), (2, 5), (3, 8)])
def test_subset_slices_carry_the_parent_scale(bounds):
    """A sub-forest's bitvector tables equal the JAX package's and carry the
    parent's quantization scale, so its partials merge exactly."""
    jir = JForestIR.from_forest(_trained(0))
    ref, port = jir.subset(*bounds), _port(jir).subset(*bounds)
    bv = port.materialize("bitvector")
    _assert_same_layout(bv, ref.materialize("bitvector"), f"subset{bounds}")
    assert bv.scale == bv.quant_scale == jir.scale
    x = np.random.default_rng(3).normal(0.0, 3.0, (29, jir.n_features)).astype(np.float32)
    got = create_backend("bitvector", bv, device="cpu").predict_partials(x)
    ref_arrays = jbv.bitvector_device_arrays(ref.materialize("bitvector"))
    n_slots = ref_arrays.pop("n_entry_slots")
    keys = float_to_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbv._bitvector_partials(ref_arrays, keys, n_slots)))


def test_nbytes_by_layout_reports_bitvector():
    jir = JForestIR.from_forest(_trained(2))
    ir = _port(jir)
    for mode in ("integer", "float"):
        assert ir.nbytes_by_layout(mode)["bitvector"] == \
            jir.nbytes_by_layout(mode)["bitvector"]


def test_backend_capabilities_and_row_checks():
    ir = ForestIR.from_forest(_trained(1))
    backend = create_backend("bitvector", ir.materialize("bitvector"), device="cpu")
    caps = backend.capabilities
    assert caps.modes == caps.deterministic_modes == ("flint", "integer")
    assert caps.supported_layouts == ("bitvector",) and caps.preferred_layout == "bitvector"
    with pytest.raises(ValueError, match="fewer columns"):
        backend.predict_partials(np.zeros((4, ir.n_features - 1), np.float32))
    wide = np.random.default_rng(0).normal(size=(9, ir.n_features + 2)).astype(np.float32)
    np.testing.assert_array_equal(backend.predict_partials(wide),
                                  backend.predict_partials(wide[:, :ir.n_features]))
    with pytest.raises(ValueError, match="mode"):
        create_backend("bitvector", ir.materialize("bitvector"), mode="float", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        create_backend("bitvector", ir.materialize("padded"), device="cpu")


def test_pick_blocks_spreads_small_batches_over_trees():
    """K5's CTA rule on the full-width model (W32 = 32, 1,072 records a
    tree): at 65,536 rows 128 rows of 2 a thread, 8 splits of 4 words, tree
    chunks for about four waves of the 2 CTAs an SM holds; at 1,000 rows 64
    rows and one tree chunk of 2 per 8 CTAs; at 20 rows one warp of rows
    and 16 splits of 2 words, a tree per CTA; each tree's records staged."""
    assert kbv.pick_blocks(65_536, 128, 87, 32, 1072) == (128, 43, 8, 2)
    assert kbv.pick_blocks(1000, 128, 87, 32, 1072) == (64, 2, 8, 2)
    assert kbv.pick_blocks(20, 128, 87, 32, 1072) == (32, 1, 16, 1)
    assert kbv.pick_blocks(20, 128, 87, 2, 30) == (32, 1, 1, 1)  # at least two words a split
    assert kbv.record_cap(1072, 128, 87, 8) == 1072
    assert kbv.smem_bytes(128, 87, 8, 1072) == 44_544 + 4096 + 34_304
    assert kbv.record_cap(2049, 32, 87, 1) == 0  # over STAGED_RECORD_BYTES
    assert kbv.record_cap(1000, 32, 1800, 1) == 0  # no room beside the tile
    rows, trees, splits, per_thread = kbv.pick_blocks(300, 3, 2000, 36, 1100)  # unstaged rows
    assert (rows, trees, splits, per_thread) == (64, 1, 16, 2)
    for b, t, w32 in ((65_536, 128, 32), (1000, 128, 32), (20, 128, 32), (7, 5, 36)):
        rows, trees, splits, per_thread = kbv.pick_blocks(b, t, 87, w32, 1072)
        kbv.check_launch_shape(t, 87, rows, trees, splits, per_thread,
                               kbv.record_cap(1072, rows, 87, splits))


# ------------------------------------------------------------------ fault A

@pytest.mark.parametrize("t", [1, 3, 4096, 65_535, 65_536, 65_537, 200_000, 1_000_000])
@pytest.mark.parametrize("b", [1, 20, 1000, 65_536])
def test_pick_blocks_keep_the_tree_chunks_inside_grid_y(b, t):
    """Both CTA rules (the walks' ``ops.pick_blocks`` and K5's) split any
    forest into at most 65,535 tree chunks, staged or not."""
    from repro_torch.kernels import ops

    for n_features in (87, 4000):
        _, block_t = ops.pick_blocks(b, t, n_features, 132)
        assert -(-t // block_t) <= tt.MAX_TREE_CHUNKS
        tt.check_tree_chunks(t, block_t)
        rows, block_t, splits, per_thread = kbv.pick_blocks(b, t, n_features, 32, 1072, 132)
        assert -(-t // block_t) <= tt.MAX_TREE_CHUNKS
        kbv.check_launch_shape(t, n_features, rows, block_t, splits, per_thread)


def test_pinned_tree_chunks_over_grid_y_raise_before_launch():
    """A pinned ``block_t`` that makes more than 65,535 tree chunks raises
    ``ValueError`` naming the chunk count, for the walks and for K5; the
    tree count alone raises nothing."""
    tt.check_tree_chunks(65_536, 2)
    tt.check_tree_chunks(1_000_000, 16)
    with pytest.raises(ValueError, match="65536 tree chunks"):
        tt.check_tree_chunks(65_536, 1)
    with pytest.raises(ValueError, match="100000 tree chunks"):
        kbv.check_launch_shape(200_000, 87, 128, 2, 1)
    kbv.check_launch_shape(65_536, 87, 128, 2, 1)
    with pytest.raises(ValueError, match="threads"):
        kbv.check_launch_shape(8, 87, 128, 1, 16)
    with pytest.raises(ValueError, match="shared memory"):
        kbv.check_launch_shape(8, 87, 128, 1, 8, 2, rec_cap=6000)
    with pytest.raises(ValueError, match="shared memory"):
        kbv.check_launch_shape(8, 1800, 160, 1, 1)
    with pytest.raises(ValueError, match="rows per thread"):
        kbv.check_launch_shape(8, 87, 128, 1, 1, rows_per_thread=3)
    with pytest.raises(ValueError, match="bad CTA shape"):
        kbv.check_launch_shape(8, 87, 32, 1, 1, rows_per_thread=2)


# ------------------------------------------------------------------ packing

def _dense(arrays):
    return [arrays[k] for k in _TABLES]


def _assert_unpacks(dense, packed, label):
    """``packed`` unpacks to ``dense``'s ``inv_mask`` bit for bit, with each
    slot's feature and key wherever its clear set is not empty; its records
    are the nonzero mask words, grouped by tree and word; it keeps the dense
    grid (packed on the CPU) and its records' feature range."""
    feat, key, inv = (_u32(a) for a in dense[:3])
    u_feat, u_key, u_inv = (_u32(a) for a in kbv.unpack_bitvector_tables(packed)[:3])
    np.testing.assert_array_equal(u_inv, inv, err_msg=label)
    used = inv.any(-1)
    np.testing.assert_array_equal(u_feat[used], feat[used], err_msg=label)
    np.testing.assert_array_equal(u_key[used], key[used], err_msg=label)
    rec = packed.records.numpy()
    assert rec.shape == (int((inv != 0).sum()), 4) and (rec[:, 3] != 0).all(), label
    ws = packed.word_start.numpy()
    t, w32 = _u32(dense[3]).shape
    assert ws.shape == (t, w32 + 1) and ws[0, 0] == 0 and ws[-1, -1] == len(rec)
    assert (np.diff(ws, axis=1) >= 0).all() and (ws[1:, 0] == ws[:-1, -1]).all()
    for tree in range(t):
        for w in range(w32):
            assert (rec[ws[tree, w]:ws[tree, w + 1], 2] == w).all(), label
    for got, want in zip((packed.init_mask, packed.leaf_off, packed.leaf_fixed), dense[3:6]):
        np.testing.assert_array_equal(_u32(got), _u32(want), err_msg=label)
    assert packed.n_entry_slots == feat.shape[1]
    assert packed.feature_range == ((int(rec[:, 0].min()), int(rec[:, 0].max()))
                                    if len(rec) else (0, 0))
    assert packed.slot.shape == (len(rec),) and isinstance(packed.slot, np.ndarray)
    assert len(packed.dense) == 6


def test_packed_tables_unpack_to_the_dense_grid(case):
    """Every layout case packs and unpacks to its slot grid, and the wrapper
    on packed tables equals the plain version on the dense grid."""
    name, _, ir, rows = case
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    arrays.pop("n_entry_slots")
    packed = kbv.pack_bitvector_tables(*_dense(arrays), device="cpu")
    _assert_unpacks(_dense(arrays), packed, name)
    keys = float_to_key(torch.from_numpy(rows[131]))
    np.testing.assert_array_equal(_u32(kbv.tree_bitvector(keys, packed)),
                                  _u32(kbv.bitvector_plain(keys, *_dense(arrays))))


@pytest.mark.parametrize("bounds", [(0, 1), (2, 5), (3, 8)])
def test_packed_tables_of_subset_slices(bounds):
    ir = _port(JForestIR.from_forest(_trained(0))).subset(*bounds)
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    arrays.pop("n_entry_slots")
    _assert_unpacks(_dense(arrays), kbv.pack_bitvector_tables(*_dense(arrays), device="cpu"),
                    f"subset{bounds}")


@pytest.mark.parametrize("w32", [2, 8, 32, 36])
def test_random_span_masks_pack_exactly(w32):
    """Random non-range clear sets (multi-word spans with zero words
    inside) pack and unpack bit for bit, and the wrapper on the packed
    tables equals the plain version on the dense ones."""
    dense, keys = random_span_tables(w32, 5, 9, w32, 6, 40, 3)
    packed = kbv.pack_bitvector_tables(*dense, device="cpu")
    _assert_unpacks(dense, packed, f"W32={w32}")
    np.testing.assert_array_equal(_u32(kbv.tree_bitvector(keys, packed)),
                                  _u32(kbv.bitvector_plain(keys, *dense)))


def _jax_partials(dense, keys):
    arrays = dict(zip(_TABLES, (_u32(a) for a in dense)))
    return np.asarray(jbv._bitvector_partials(arrays, keys.numpy(), dense[0].shape[1]))


@pytest.mark.parametrize("w32", [2, 8, 32, 36])
def test_plain_matches_bitvector_partials_on_random_span_masks(w32):
    """On random clear sets whose features stray below 0, below -F and past
    F, and whose leaf rows stray below 0 and past the leaf table, the plain
    version equals ``_bitvector_partials`` (tolerance 0): both index as
    jnp does, a negative index wrapped once and then clamped."""
    dense, keys = random_span_tables(w32 + 100, 6, 40, w32, 7, 48, 3, n_rows=61)
    feat = dense[0].numpy()
    assert (feat < -7).any() and ((feat < 0) & (feat >= -7)).any() and (feat >= 7).any()
    assert (dense[4].numpy() < 0).any()
    np.testing.assert_array_equal(_u32(kbv.bitvector_plain(keys, *dense)),
                                  _jax_partials(dense, keys))


@pytest.mark.parametrize("w32", [2, 36])
def test_wrapped_records_score_as_the_raw_table(w32):
    """The records the wrapper hands K5 where a feature lies outside
    [0, F) hold every feature in [0, F), and score (unpacked, through the
    plain version) as the raw table does in the JAX package."""
    dense, keys = random_span_tables(w32 + 200, 6, 40, w32, 7, 48, 3, n_rows=61)
    packed = kbv.pack_bitvector_tables(*dense, device="cpu")
    lo, hi = packed.feature_range
    assert lo < 0 and hi >= 7
    wrapped = packed._replace(records=kbv._wrap_features(packed.records, 7))
    feat = wrapped.records[:, 0]
    assert int(feat.min()) >= 0 and int(feat.max()) < 7
    np.testing.assert_array_equal(_u32(kbv.bitvector_plain(
        keys, *kbv.unpack_bitvector_tables(wrapped))), _jax_partials(dense, keys))


def _exit_work_by_record(packed, dense, keys):
    """(compares, ORs) of K5's scan, record by record: each (row, tree)
    takes its words lowest first and stops at the first with a surviving
    bit."""
    rec, ws = packed.records.numpy(), packed.word_start.numpy()
    init = _u32(dense[3])
    x = keys.numpy()
    f = x.shape[1]
    compares = ors = 0
    for row in x:
        for t in range(init.shape[0]):
            for w in range(init.shape[1]):
                cleared = 0
                for r in rec[ws[t, w]:ws[t, w + 1]]:
                    feat = min(max(r[0] + f if r[0] < 0 else r[0], 0), f - 1)
                    compares += 1
                    if row[feat] > r[1]:
                        ors += 1
                        cleared |= int(r[3]) & 0xFFFFFFFF
                if int(init[t, w]) & ~cleared:
                    break
    return compares, ors


@pytest.mark.parametrize("w32", [2, 8])
def test_exit_work_counts_the_records_each_scan_needs(w32):
    """K5's bound counts, per (row, tree), the records in words up to its
    exit word and the false ones among them, as a scan record by record
    finds them; rows and records chunked so that no chunk divides evenly."""
    dense, keys = random_span_tables(w32 + 300, 4, 12, w32, 5, 40, 3, n_rows=23)
    packed = kbv.pack_bitvector_tables(*dense, device="cpu")
    nbytes, n_ops, compares, ors = bitvector_exit_work(packed, dense, keys, chunk_rows=7,
                                                       sub_rows=3)
    assert (compares, ors) == _exit_work_by_record(packed, dense, keys)
    assert n_ops == compares + ors + 23 * 4 * 3
    assert nbytes == keys.numel() * 4 + packed.nbytes() + 23 * 3 * 4
    assert 0 < compares < len(packed.records) * 23


@pytest.mark.parametrize("depth,w32", [(200, 8), (1000, 32)])
def test_chain_layouts_pack_exactly(depth, w32):
    """Chains whose bitvectors take 8 and 32 words pack to one record per
    nonzero word: one for most slots (a clear set is one leaf range)."""
    ir = ForestIR.from_forest(forest_from_trees([chain_tree(depth, 3), chain_tree(9, 3)], 3, 2))
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    arrays.pop("n_entry_slots")
    assert arrays["init_mask"].shape[-1] == w32
    packed = kbv.pack_bitvector_tables(*_dense(arrays), device="cpu")
    _assert_unpacks(_dense(arrays), packed, f"chain {depth}")
    assert len(packed.records) < 1.1 * (depth + 9)


def test_all_stump_tables_pack_to_no_records():
    ir = ForestIR.from_forest(DEGENERATE_FORESTS["stumps"]())
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    assert arrays.pop("n_entry_slots") == 0
    packed = kbv.pack_bitvector_tables(*_dense(arrays), device="cpu")
    assert packed.records.shape == (0, 4) and not packed.word_start.any()
    _assert_unpacks(_dense(arrays), packed, "all stumps")


def test_backend_packs_its_tables_once():
    ir = ForestIR.from_forest(_trained(1))
    backend = create_backend("bitvector", ir.materialize("bitvector"), device="cpu")
    assert isinstance(backend._tables, kbv.BitvectorTables)
    assert backend._tables.nbytes() < sum(
        a.numel() * 4 for a in _dense(kbv.bitvector_device_arrays(
            ir.materialize("bitvector"), "cpu")))
