"""The port's QuickScorer route against the JAX package's, bit for bit.

Every ``BitvectorEnsemble`` array, the tree-major slot grid of
``bitvector_device_arrays``, the partials of ``bitvector_plain`` (K5's plain
version, the one the CPU runs) and the scores of the ``flint:bitvector`` and
``integer:bitvector`` engines equal the JAX package's, with tolerance 0, on
trained forests, on ``forest_cases.DEGENERATE_FORESTS``, on a two-word
layout (a 71-leaf chain, as ``tests/test_bitvector.py``), on a layout wider
than K5's 32-word register chunk (a 1,101-leaf chain: W32 = 36) and on
``ForestIR.subset`` slices.  The chains' rows spread over the chain's whole
threshold range, so exit leaves land in every word, the high ones included.
Inputs come from seeds through numpy; the forest crosses packages through
``ForestIR.from_numpy``.
"""
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
    """The cases cover a two-word layout and one wider than K5's largest
    register chunk, whose high words are really reached."""
    wide = ForestIR.from_forest(CASES["wide"][0]()).materialize("bitvector")
    assert 2 * wide.words > kbv.CHUNK_WORDS and wide.words == 18
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
    """On CPU tensors the wrapper takes the plain version and counts no
    launch."""
    _, _, ir, rows = case
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), "cpu")
    keys = float_to_key(torch.from_numpy(rows[64]))
    before = dict(tt.LAUNCHES)
    out = kbv.tree_bitvector(keys, *(arrays[k] for k in _TABLES))
    assert tt.LAUNCHES == before
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
    """K5's CTA rule: 128 rows of the full-width model per CTA, tree chunks
    for about four waves, one tree per CTA at small batches."""
    assert kbv.pick_blocks(65_536, 128, 87) == (128, 22)
    assert kbv.pick_blocks(1000, 128, 87) == (128, 1)
    assert kbv.pick_blocks(20, 128, 87) == (128, 1)
    rows, trees = kbv.pick_blocks(300, 3, 2000)  # too wide to stage
    assert rows == 128 and trees == 1
