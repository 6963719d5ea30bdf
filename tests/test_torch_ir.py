"""The port's ForestIR and layouts against ``repro.ir``: every array equal in
dtype and value, on a trained forest and on the degenerate shapes."""
import numpy as np
import pytest

from forest_cases import DEGENERATE_FORESTS
from repro.ir import ForestIR as JForestIR
from repro_torch.ir import ForestIR, available_layouts, resolve_artifact
from repro_torch.ir.forest_ir import ARRAY_DTYPES
from test_backends import _child_before_parent_forest

PORTED_LAYOUTS = ("padded", "leaf_major", "ragged", "bitvector", "packed_leaf")
_META = ("n_trees", "n_classes", "n_features", "max_depth", "layout",
         "quant_scale", "scale")


def _port(jir):
    """The reference IR carried across as numpy arrays."""
    arrays = {name: getattr(jir, name) for name in ARRAY_DTYPES}
    return ForestIR.from_numpy(arrays, n_trees=jir.n_trees,
                               n_classes=jir.n_classes,
                               n_features=jir.n_features,
                               quant_scale=jir.quant_scale)


def _assert_same_arrays(port, ref, label):
    for name, value in vars(ref).items():
        if isinstance(value, np.ndarray):
            got = getattr(port, name)
            assert got.dtype == value.dtype, f"{label}.{name} dtype"
            np.testing.assert_array_equal(got, value, err_msg=f"{label}.{name}")
    for name in _META:
        if hasattr(ref, name):
            assert getattr(port, name) == getattr(ref, name), f"{label}.{name}"


def _assert_same_ir(port, ref):
    _assert_same_arrays(port, ref, "ir")
    for layout in PORTED_LAYOUTS:
        _assert_same_arrays(port.materialize(layout), ref.materialize(layout), layout)
    assert (port.materialize("leaf_major").internal_counts is None) == \
        (ref.materialize("leaf_major").internal_counts is None)
    ref_bytes = ref.nbytes_by_layout()
    assert port.nbytes_by_layout() == {k: ref_bytes[k] for k in PORTED_LAYOUTS}
    ref_fbytes = ref.nbytes_by_layout("float")
    assert port.nbytes_by_layout("float") == {k: ref_fbytes[k] for k in PORTED_LAYOUTS}


def test_ported_layout_registry():
    assert tuple(available_layouts()) == tuple(sorted(PORTED_LAYOUTS))


def test_trained_forest_through_from_numpy(small_forest):
    ref = JForestIR.from_forest(small_forest)
    _assert_same_ir(_port(ref), ref)


def test_trained_forest_through_from_forest(small_forest):
    """The port's own quantization of the reference's trained forest
    produces the same IR as the reference's."""
    ref = JForestIR.from_forest(small_forest)
    _assert_same_ir(ForestIR.from_forest(small_forest), ref)


@pytest.mark.parametrize("name", sorted(DEGENERATE_FORESTS))
def test_degenerate_forests(name):
    forest = DEGENERATE_FORESTS[name]()
    ref = JForestIR.from_forest(forest)
    _assert_same_ir(ForestIR.from_forest(forest), ref)
    _assert_same_ir(_port(ref), ref)


def test_unscannable_order_has_no_internal_counts():
    forest = _child_before_parent_forest()
    ref = JForestIR.from_forest(forest)
    port = ForestIR.from_forest(forest)
    assert port.materialize("leaf_major").internal_counts is None
    _assert_same_ir(port, ref)


@pytest.mark.parametrize("bounds", [(0, 1), (2, 7), (4, 9)])
def test_subset_carries_parent_scale(small_forest, bounds):
    ref = JForestIR.from_forest(small_forest).subset(*bounds)
    port = ForestIR.from_forest(small_forest).subset(*bounds)
    assert port.quant_scale == ref.quant_scale == \
        JForestIR.from_forest(small_forest).scale
    _assert_same_ir(port, ref)
    _assert_same_ir(_port(ref), ref)


def test_to_numpy_round_trip_is_verbatim(small_forest):
    ir = ForestIR.from_forest(small_forest)
    arrays = ir.to_numpy()
    again = ForestIR.from_numpy(arrays, n_trees=ir.n_trees,
                                n_classes=ir.n_classes,
                                n_features=ir.n_features)
    _assert_same_arrays(again, ir, "round trip")
    arrays["feature"][0] = 123  # a copy: the IR is untouched
    assert ir.feature[0] != 123


def test_from_numpy_refuses_to_convert(small_forest):
    arrays = ForestIR.from_forest(small_forest).to_numpy()
    meta = dict(n_trees=9, n_classes=small_forest.n_classes_,
                n_features=small_forest.n_features_)
    with pytest.raises(ValueError, match="dtype"):
        ForestIR.from_numpy({**arrays, "leaf_fixed": arrays["leaf_fixed"].astype(np.int64)},
                            **meta)
    with pytest.raises(ValueError, match="missing"):
        ForestIR.from_numpy({k: v for k, v in arrays.items() if k != "left"}, **meta)
    with pytest.raises(ValueError, match="trees"):
        ForestIR.from_numpy(arrays, **{**meta, "n_trees": 8})


def test_resolve_artifact_and_from_packed(small_forest):
    ref = JForestIR.from_forest(small_forest)
    port = ForestIR.from_forest(small_forest)
    padded = port.materialize("padded")
    assert resolve_artifact(padded, "padded") is padded
    _assert_same_arrays(resolve_artifact(padded, "leaf_major"),
                        ref.materialize("leaf_major"), "leaf_major")
    bare = type(padded)(**{k: v for k, v in vars(padded).items() if k != "ir"})
    _assert_same_arrays(bare.to_ir(), JForestIR.from_packed(ref.materialize("padded")),
                        "from_packed")
