"""The port's ``core`` predict helpers against the JAX package's, on two
``tests/forest_cases.py`` forests and a trained one: ``predict_float``,
``predict_flint``, ``predict_integer``, ``integer_probs``,
``make_partials_fn`` and ``make_predict_fn`` (each over ``predict_mode`` /
``predict_partials_mode`` with an explicit device), exported with
``ensemble_device_arrays``, ``predict_mode`` and ``predict_partials_mode``
from ``repro_torch.core``.

Tolerance 0 everywhere: ``flint`` and ``integer`` are exact integer sums,
and ``float`` adds the trees in the reference's order; ``predict_float``
divides the sums by ``n`` as the reference's eager helper does, and
``make_predict_fn`` multiplies by the float32 reciprocal of ``n`` as XLA
does with the reference's jitted ``acc / n``, so its bits are the
reference's too."""
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as core
from forest_cases import DEGENERATE_FORESTS
from repro.ir import ForestIR as JForestIR
from repro_torch.ir import ForestIR
from repro_torch.ir.forest_ir import ARRAY_DTYPES

HELPERS = ("ensemble_device_arrays", "predict_mode", "predict_partials_mode", "predict_float",
           "predict_flint", "predict_integer", "integer_probs", "make_partials_fn",
           "make_predict_fn")
FORESTS = ("trained", "depth_skewed", "single_tree")


@pytest.fixture(scope="module", params=FORESTS)
def case(request):
    """(the reference's packed forest, the port's from the same IR arrays,
    rows that reach every threshold)."""
    from repro.trees.forest import RandomForestClassifier

    rng = np.random.default_rng(5)
    if request.param == "trained":
        X = rng.normal(size=(900, 5)).astype(np.float32)
        y = (X[:, 0] > 0.2).astype(int) + (X[:, 1] + X[:, 3] > 0).astype(int)
        forest = RandomForestClassifier(n_estimators=7, max_depth=6, seed=2).fit(X, y)
    else:
        forest = DEGENERATE_FORESTS[request.param]()
    jir = JForestIR.from_forest(forest)
    ir = ForestIR.from_numpy({k: getattr(jir, k) for k in ARRAY_DTYPES},
                             n_trees=jir.n_trees, n_classes=jir.n_classes,
                             n_features=jir.n_features)
    rows = rng.normal(0.0, 4.0, (257, jir.n_features)).astype(np.float32)
    return jir.materialize("padded"), ir.materialize("padded"), rows


def test_core_exports_the_reference_helpers():
    for name in HELPERS:
        assert name in core.__all__ and callable(getattr(core, name)), name
        assert name in jcore.__all__, name


@pytest.mark.parametrize("mode", ("float", "flint", "integer"))
def test_predict_helpers_give_the_reference_bits(mode, case):
    jp, tp, X = case
    jfn = {"float": jcore.predict_float, "flint": jcore.predict_flint,
           "integer": jcore.predict_integer}[mode]
    fn = {"float": core.predict_float, "flint": core.predict_flint,
          "integer": core.predict_integer}[mode]
    want_s, want_p = (np.asarray(a) for a in jfn(jp, X))
    got_s, got_p = fn(tp, X, device="cpu")
    assert got_s.dtype == want_s.dtype and got_s.shape == want_s.shape
    np.testing.assert_array_equal(got_s.view(np.uint32), want_s.view(np.uint32))
    np.testing.assert_array_equal(got_p, want_p)
    # the closures over the device arrays: the reference jits its whole
    # function, so XLA turns its float ``acc / n`` into a multiply by the
    # reciprocal, as the port's ``make_predict_fn`` and ``predict_mode`` do
    want_s, want_p = (np.asarray(a) for a in jcore.make_predict_fn(jp, mode)(X))
    for s2, p2 in (core.make_predict_fn(tp, mode, device="cpu")(X),
                   core.predict_mode(tp, X, mode, device="cpu")):
        np.testing.assert_array_equal(s2.view(np.uint32), want_s.view(np.uint32))
        np.testing.assert_array_equal(p2, want_p)


@pytest.mark.parametrize("mode", ("flint", "integer"))
def test_partials_fn_gives_the_reference_bits(mode, case):
    jp, tp, X = case
    want = np.asarray(jcore.make_partials_fn(jp, mode)(X))
    got = core.make_partials_fn(tp, mode, device="cpu")(X)
    np.testing.assert_array_equal(core.ensemble.u32_numpy(got), want)
    arrays = core.ensemble_device_arrays(tp, mode, "cpu")
    again = core.predict_partials_mode(tp, X, mode, device="cpu", arrays=arrays)
    np.testing.assert_array_equal(core.ensemble.u32_numpy(again), want)


def test_partials_fn_refuses_float_as_the_reference_does(case):
    jp, tp, _ = case
    with pytest.raises(ValueError, match="does not produce integer partials"):
        jcore.make_partials_fn(jp, "float")
    with pytest.raises(ValueError, match="does not produce integer partials"):
        core.make_partials_fn(tp, "float", device="cpu")


def test_integer_probs_match_the_reference(case):
    jp, tp, X = case
    acc, _ = core.predict_integer(tp, X, device="cpu")
    want = np.asarray(jcore.integer_probs(jp, np.asarray(jcore.predict_integer(jp, X)[0])))
    got = core.integer_probs(tp, acc)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
