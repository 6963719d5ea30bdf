"""The serving path as a whole: the port's ``TreeEngine`` against the JAX package's,
route by route, with scores and predictions bit-identical.

``integer|flint:cuda@leaf_major|padded`` (plain versions on the CPU) is held
against ``...:pallas@...`` (interpret mode), and the port's ``reference``
backend against the JAX ``reference`` in all three modes, at batches of 1,
20, 37, 100 and 300 rows: the small-batch switch to the gather walk (20 rows
pad to 32) and the bounded walk (37 rows pad to 64) are both reached.  Float
mode is bit-identical too: the trees add in tree order on both sides and
the port's finalize multiplies by the float32 reciprocal of ``n``, which is
what XLA makes of the reference's jitted ``acc / n``.
"""
import numpy as np
import pytest
import torch

from forest_cases import DEGENERATE_FORESTS
from repro.ir import ForestIR as JForestIR
from repro.serve.engine import TreeEngine as JTreeEngine
from repro.serve.spec import EngineSpec as JEngineSpec
from repro_torch.backends import create_backend
from repro_torch.backends import cuda as cuda_backend
from repro_torch.ir import ForestIR
from repro_torch.ir.forest_ir import ARRAY_DTYPES
from repro_torch.kernels.ops import tree_predict_integer
from repro_torch.serve import EngineSpec, TreeEngine, bucket_rows
from test_backends import _child_before_parent_forest

BATCHES = (1, 20, 37, 100, 300)
KERNEL_ROUTES = [(f"{mode}:cuda@{layout}", f"{mode}:pallas@{layout}")
                 for mode in ("integer", "flint") for layout in ("leaf_major", "padded")]
KERNEL_ROUTES += [(f"integer:cuda@{layout}?impl=onehot", f"integer:pallas@{layout}?impl=onehot")
                  for layout in ("leaf_major", "padded")]
REFERENCE_ROUTES = [(f"{mode}:reference", f"{mode}:reference")
                    for mode in ("integer", "flint", "float")]
FORESTS = ["trained", *sorted(DEGENERATE_FORESTS)]


@pytest.fixture(scope="module")
def trained():
    from repro.trees.forest import RandomForestClassifier

    rng = np.random.default_rng(11)
    X = rng.normal(size=(1200, 6)).astype(np.float32)
    y = (X[:, 0] > 0.3).astype(int) + (X[:, 1] > 0).astype(int) + (X[:, 2] > 1).astype(int)
    return RandomForestClassifier(n_estimators=6, max_depth=5, seed=3).fit(X, y)


@pytest.fixture(scope="module", params=FORESTS)
def case(request, trained):
    """(reference IR, port IR carried across as numpy, rows per batch)."""
    forest = trained if request.param == "trained" else DEGENERATE_FORESTS[request.param]()
    jir = JForestIR.from_forest(forest)
    ir = ForestIR.from_numpy({k: getattr(jir, k) for k in ARRAY_DTYPES},
                             n_trees=jir.n_trees, n_classes=jir.n_classes,
                             n_features=jir.n_features)
    rng = np.random.default_rng(len(request.param))
    rows = {b: rng.normal(0.0, 2.0, (b, jir.n_features)).astype(np.float32)
            for b in BATCHES}
    return jir, ir, rows


def _assert_engines_agree(case, port_spec, ref_spec):
    jir, ir, rows = case
    ref, port = JTreeEngine(jir, spec=ref_spec), TreeEngine(ir, spec=port_spec, device="cpu")
    assert port.layout == ref.layout
    for b, x in rows.items():
        s_ref, p_ref = (np.asarray(a) for a in ref.predict_scores(x))
        s, p = port.predict_scores(x)
        assert s.dtype == s_ref.dtype and p.dtype == p_ref.dtype
        np.testing.assert_array_equal(s, s_ref, err_msg=f"{port_spec} b={b}")
        np.testing.assert_array_equal(p, p_ref, err_msg=f"{port_spec} b={b}")
        if port.deterministic:
            np.testing.assert_array_equal(port.predict_partials(x),
                                          np.asarray(ref.predict_partials(x)))


@pytest.mark.parametrize("port_spec,ref_spec", KERNEL_ROUTES)
def test_cuda_routes_match_pallas(case, port_spec, ref_spec):
    _assert_engines_agree(case, port_spec, ref_spec)


@pytest.mark.parametrize("port_spec,ref_spec", REFERENCE_ROUTES)
def test_reference_routes_match(case, port_spec, ref_spec):
    _assert_engines_agree(case, port_spec, ref_spec)


def test_unscannable_forest_auto_gathers_and_pinned_scan_raises():
    jforest = _child_before_parent_forest()
    ir = ForestIR.from_forest(jforest)
    rows = np.random.default_rng(3).normal(0, 3, (29, 2)).astype(np.float32)
    eng = TreeEngine(ir, spec="integer:cuda@leaf_major", device="cpu")
    assert eng.backend.impl == "gather"
    s, p = eng.predict_scores(rows)
    s_ref, p_ref = JTreeEngine(JForestIR.from_forest(jforest),
                               spec="integer:pallas@leaf_major").predict_scores(rows)
    np.testing.assert_array_equal(s, np.asarray(s_ref))
    np.testing.assert_array_equal(p, np.asarray(p_ref))
    with pytest.raises(ValueError, match="scannable"):
        create_backend("cuda", ir.materialize("leaf_major"), device="cpu", impl="leaf_major")
    with pytest.raises(ValueError, match="leaf_major"):
        create_backend("cuda", ir.materialize("padded"), device="cpu", impl="leaf_major")


@pytest.mark.parametrize("rows,bucket,impl", [(1, 1, "gather"), (20, 32, "gather"),
                                              (37, 64, "leaf_major"), (100, 128, "leaf_major"),
                                              (300, 512, "leaf_major")])
def test_small_batch_switch_follows_the_bucket(case, monkeypatch, rows, bucket, impl):
    """Under auto, buckets under 64 rows take K2, the rest K1; a pinned impl
    never switches."""
    _, ir, _ = case
    seen = []

    def spy(*args, **kw):
        seen.append((args[0].shape[0], kw["impl"]))
        return tree_predict_integer(*args, **kw)

    monkeypatch.setattr(cuda_backend, "tree_predict_integer", spy)
    x = np.zeros((rows, ir.n_features), np.float32)
    auto = TreeEngine(ir, spec="integer:cuda@leaf_major", device="cpu")
    pinned = TreeEngine(ir, spec="integer:cuda@leaf_major?impl=gather", device="cpu")
    auto.predict_scores(x)
    pinned.predict_scores(x)
    scannable = ir.materialize("leaf_major").internal_counts is not None
    assert bucket_rows(rows, max_bucket=auto.max_bucket) == bucket
    assert seen == [(bucket, impl if scannable else "gather"), (bucket, "gather")]


@pytest.mark.parametrize("text", [
    "integer",
    "flint:reference",
    "integer:reference+auto:3",
    "integer:reference?autotune=true",
    "integer:reference+single",
    "float:reference@padded+single:1",
])
def test_spec_canonical_matches_reference(text):
    assert EngineSpec.parse(text).canonical() == JEngineSpec.parse(text).canonical()
    assert EngineSpec.parse(text).to_dict() == JEngineSpec.parse(text).to_dict()


@pytest.mark.parametrize("layout", ["leaf_major", "padded"])
@pytest.mark.parametrize("mode", ["integer", "flint"])
def test_cuda_spec_renames_pallas_only(mode, layout):
    port = EngineSpec.parse(f"{mode}:cuda@{layout}?block_b=128")
    ref = JEngineSpec.parse(f"{mode}:pallas@{layout}?block_b=128")
    assert port.canonical() == ref.canonical().replace("pallas", "cuda")


def test_spec_validates_against_the_ports_registries():
    """Names the port does not register fail to parse; the QuickScorer
    layout and backend and the sharded plans are registered now."""
    with pytest.raises(ValueError, match="backend"):
        EngineSpec.parse("integer:pallas")
    with pytest.raises(ValueError, match="layout"):
        EngineSpec.parse("integer:reference@no_such_layout")
    with pytest.raises(ValueError, match="plan"):
        EngineSpec.parse("integer:reference+no_such_plan:2")
    for text in ("integer:bitvector@bitvector", "integer:reference+tree_parallel:2",
                 "float:reference+row_parallel:3", "integer:cuda|bitvector"):
        assert EngineSpec.parse(text).canonical() == JEngineSpec.parse(
            text.replace("cuda", "pallas")).canonical().replace("pallas", "cuda")


def test_entry_points_raise_without_a_card(monkeypatch, trained):
    """No ``device`` means cuda; with no card the entry points raise instead
    of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ir = ForestIR.from_forest(trained)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TreeEngine(ir, spec="integer:cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_backend("reference", ir.materialize("padded"))
    lm = ir.materialize("leaf_major")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tree_predict_integer(np.zeros((2, ir.n_features), np.int32), lm.feature,
                             lm.threshold_key, lm.left, lm.right, lm.leaf_fixed,
                             depth=lm.max_depth)


def test_unported_routes_fail_loudly(trained):
    """Float on the kernels and plans the port does not register still fail
    loudly; the autotuned route, the one-hot walk (K3) and the sharded plans
    now build and equal the JAX engines."""
    ir = ForestIR.from_forest(trained)
    jir = JForestIR.from_forest(trained)
    x = np.random.default_rng(8).normal(0.0, 2.0, (45, ir.n_features)).astype(np.float32)
    for spec, ref_spec in (("integer:cuda?autotune=true", "integer:pallas"),
                           ("integer:cuda?impl=onehot", "integer:pallas?impl=onehot")):
        eng = TreeEngine(ir, spec=spec, device="cpu")
        eng.warm(64)
        s, p = eng.predict_scores(x)
        s_ref, p_ref = JTreeEngine(jir, spec=ref_spec).predict_scores(x)
        np.testing.assert_array_equal(s, np.asarray(s_ref))
        np.testing.assert_array_equal(p, np.asarray(p_ref))
    assert eng.backend.impl == "onehot"
    for spec in (EngineSpec(backend="cuda", plan="tree_parallel", shards=2),
                 EngineSpec(backend="cuda", shards=2)):
        eng = TreeEngine(ir, spec=spec, device="cpu")
        assert eng.plan_name == "tree_parallel" and eng.n_shards == 2
        s, p = eng.predict_scores(x)
        s_ref, p_ref = JTreeEngine(jir, spec=spec.replace(backend="pallas")
                                   .canonical()).predict_scores(x)
        np.testing.assert_array_equal(s, np.asarray(s_ref))
        np.testing.assert_array_equal(p, np.asarray(p_ref))
    with pytest.raises(KeyError, match="unknown plan"):
        TreeEngine(ir, spec=EngineSpec(backend="cuda", plan="not_a_plan",
                                       shards=2), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        TreeEngine(ir, spec="float:cuda", device="cpu")


def test_cuda_backend_refuses_rows_with_too_few_features(trained):
    """The kernels take the row stride from the rows: fewer columns than the
    forest reads would walk into the next row (and past the buffer at the
    last one), so the backend raises on every device before any launch."""
    ir = ForestIR.from_forest(trained)
    x = np.zeros((40, ir.n_features - 1), np.float32)
    for layout, impl in (("leaf_major", "auto"), ("padded", "gather"), ("padded", "onehot")):
        backend = create_backend("cuda", ir.materialize(layout), device="cpu", impl=impl)
        with pytest.raises(ValueError, match="fewer columns"):
            backend.predict_partials(x)
    wide = np.zeros((40, ir.n_features + 3), np.float32)
    np.testing.assert_array_equal(backend.predict_partials(wide),
                                  backend.predict_partials(wide[:, :ir.n_features]))


def test_warm_and_timing_ledgers(trained):
    ir = ForestIR.from_forest(trained)
    eng = TreeEngine(ir, spec="integer:cuda", device="cpu")
    assert eng.max_bucket == 256 and eng.layout == "leaf_major"
    eng.warm(300)
    assert eng.compiled_buckets == {1, 2, 4, 8, 16, 32, 64, 128, 256, 512}
    assert set(eng.drain_compile_timings()) == eng.compiled_buckets
    assert eng.drain_shard_timings()["s0:cuda"][1] == 10
    assert set(eng.drain_stage_timings()) == {"pad", "finalize"}
    eng.close()
    assert eng.closed
