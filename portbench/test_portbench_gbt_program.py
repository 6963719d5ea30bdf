"""CPU tests of the program's boosted path against the ``gbt`` family's
yardstick: seeded boosters from ``families/gbt.make_forest`` at small sizes,
handed over by ``program_model``, scored through ``TreeEngine`` on every route
that takes a margin model (the card's backends run their plain versions with
``device="cpu"``), through ``ModelRegistry`` and ``Gateway`` with cache hits,
and through the harness's own bulk run.  Each answer must equal
``Reference.scores`` bit for bit: the (B, C) int32 margins with the base, and
the first largest class.  Every other route refuses the model by name, and
the averaged forest keeps its uint32 scores."""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import catalog

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.backends.cuda import _SMALL_BATCH_GATHER_ROWS  # noqa: E402
from repro_torch.ir import ForestIR  # noqa: E402
from repro_torch.serve import Gateway, ModelRegistry, TreeEngine  # noqa: E402
from repro_torch.trees import (GradientBoostedClassifier, pack_gbt,  # noqa: E402
                               predict_gbt_integer)

GBT = catalog.family({"family": "gbt"})
# (seed, classes, depth, features): 6 rounds each, 3 and 7 classes, depth 3
# to 5, 5 to 12 features, a seed past 32 signed bits
CASES = [(0, 3, 3, 5), (1, 7, 5, 12), (2, 7, 4, 9), (2 ** 31 + 5, 3, 5, 8)]
ROUTES = [
    "integer:reference",
    "integer:reference@packed_leaf",
    "integer:cuda@leaf_major",           # K1; K2 under _SMALL_BATCH_GATHER_ROWS
    "integer:cuda@padded",               # K2
    "integer:cuda@padded?impl=onehot",   # K3
    "integer:bitvector",                 # K5
    "integer:cuda+tree_parallel:2",
    "integer:cuda|bitvector+tree_parallel:3",
    "integer:reference+row_parallel:2",
    "integer:cuda+row_parallel:2",
]
ROWS = (1, 20, _SMALL_BATCH_GATHER_ROWS - 1, _SMALL_BATCH_GATHER_ROWS,
        _SMALL_BATCH_GATHER_ROWS + 1, 300)


def cfg_of(classes, depth, features):
    return dict(family="gbt", n_rounds=6, n_classes=classes, depth=depth,
                n_features=features, learning_rate=0.3, threshold_sample_rows=256)


@functools.lru_cache(maxsize=None)
def case(seed, classes, depth, features):
    """(model, IR, rows, reference scores, reference preds) of one case."""
    model = GBT.make_forest(cfg_of(classes, depth, features), seed)
    x = np.random.default_rng(seed % 2 ** 32).standard_normal((300, features), dtype=np.float32)
    x[:3] = model.threshold[0, 0]  # rows on a threshold take the left branch
    x[3:5] = -0.0
    scores, preds = GBT.Reference(model, "cpu").scores(x)
    return model, ForestIR.from_forest(GBT.program_model(model)), x, scores, preds


def dominated(seed=1, classes=7, depth=5, features=12, cls=2):
    """A case whose class ``cls`` has a base far above every other margin."""
    model = GBT.make_forest(cfg_of(classes, depth, features), seed)
    model.base = model.base.copy()
    model.base[cls] = 6.0
    return model


def trained_booster():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((600, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.4).astype(int)
    return GradientBoostedClassifier(n_estimators=5, max_depth=3, seed=2).fit(X, y), X


@pytest.mark.parametrize("c", CASES, ids=lambda c: f"seed{c[0]}-C{c[1]}-d{c[2]}-F{c[3]}")
def test_the_ir_is_pack_gbts_quantization(c):
    model, ir, *_ = case(*c)
    booster = GBT.program_model(model)
    packed = pack_gbt(booster)
    assert ir.kind == "margin" and ir.n_trees == c[1] * 6 and ir.n_features == c[3]
    assert ir.scale == packed.scale and ir.quant_scale == int(packed.scale)
    assert np.array_equal(ir.base_fixed, packed.base_fixed) and ir.base_fixed.dtype == np.int32
    assert np.array_equal(ir.tree_class, packed.tree_class)
    assert ir.trees_per_class() == [6] * c[1]
    signed = ir.leaf_fixed.view(np.int32)
    for t in range(ir.n_trees):
        lo, hi = ir.node_offsets[t], ir.node_offsets[t + 1]
        n = hi - lo
        assert np.array_equal(ir.threshold_key[lo:hi], packed.threshold_key[t, :n])
        assert np.array_equal(signed[lo:hi, packed.tree_class[t]], packed.leaf_fixed[t, :n])
        others = np.delete(signed[lo:hi], packed.tree_class[t], axis=1)
        assert not others.any()
    # the family's own fixed point is the same: leaves of both signs
    leaf, base = GBT.fixed_point(model)
    assert np.array_equal(base, ir.base_fixed)
    assert signed.min() < 0 < signed.max() and leaf.min() < 0 < leaf.max()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("c", CASES, ids=lambda c: f"seed{c[0]}-C{c[1]}")
def test_every_margin_route_equals_the_reference(c, route):
    model, ir, x, ref_s, ref_p = case(*c)
    eng = TreeEngine(ir, spec=route, device="cpu")
    try:
        for n in ROWS:
            s, p = eng.predict_scores(x[:n])
            assert s.dtype == np.int32 and p.dtype == np.int32 and s.shape == (n, c[1])
            assert np.array_equal(s, ref_s[:n]), (route, n)
            assert np.array_equal(p, ref_p[:n]), (route, n)
        assert eng.describe()["kind"] == "margin"
    finally:
        eng.close()


@pytest.mark.parametrize("route", ["integer:reference", "integer:cuda@leaf_major",
                                   "integer:bitvector", "integer:cuda+tree_parallel:2"])
def test_a_dominating_base_wins_every_row(route):
    model = dominated()
    x = np.random.default_rng(3).standard_normal((200, model.n_features), dtype=np.float32)
    ref_s, ref_p = GBT.Reference(model, "cpu").scores(x)
    assert (ref_p == 2).all()
    eng = TreeEngine(ForestIR.from_forest(GBT.program_model(model)), spec=route, device="cpu")
    s, p = eng.predict_scores(x)
    assert np.array_equal(s, ref_s) and np.array_equal(p, ref_p)
    eng.close()


def test_a_trained_booster_scores_as_pack_gbt_predicts():
    booster, X = trained_booster()
    assert booster.n_features_ == X.shape[1]
    ir = ForestIR.from_forest(booster)
    packed = pack_gbt(booster)
    want = predict_gbt_integer(packed, X)
    for route in ("integer:reference", "integer:cuda", "integer:bitvector"):
        eng = TreeEngine(ir, spec=route, device="cpu")
        s, p = eng.predict_scores(X)
        assert np.array_equal(p, want), route
        # the margins are pack_gbt's: the base plus each tree's leaf at its class
        assert np.array_equal(s.astype(np.int64) - packed.base_fixed,
                              eng.predict_partials(X).view(np.int32))
        # a backend called on its own adds the base too
        bs, bp = eng.backend.predict_scores(X)
        assert np.array_equal(bs, s) and np.array_equal(bp, p)
        eng.close()


def test_the_describe_reports_kind_trees_a_class_and_scale():
    _, ir, *_ = case(*CASES[1])
    d = TreeEngine(ir, spec="integer:cuda", device="cpu").describe()
    assert d["kind"] == "margin" and d["n_trees"] == 42 and d["n_classes"] == 7
    assert d["trees_per_class"] == [6] * 7 and d["margin_scale"] == ir.scale
    assert d["plan"] == "single" and d["layout"] == "leaf_major"


def test_the_gateway_serves_margins_and_cache_hits():
    model, _, x, ref_s, ref_p = case(*CASES[2])
    reg = ModelRegistry()
    mv = reg.register_forest("xgb", GBT.program_model(model))
    assert mv.source == "forest" and reg.describe()["xgb"]["kind"] == "margin"
    gw = Gateway(reg, "integer:cuda", max_batch_rows=64, max_delay_ms=1.0, device="cpu")
    spans = [(0, 1), (0, 20), (10, 80), (0, 20), (100, 300), (0, 300)]

    async def run():
        out = [await gw.submit("xgb", x[a:b]) for a, b in spans]
        await gw.close()
        return out

    for (a, b), (s, p) in zip(spans, asyncio.run(run()), strict=True):
        assert s.dtype == np.int32
        assert np.array_equal(s, ref_s[a:b]) and np.array_equal(p, ref_p[a:b])
    st = gw.cache.stats()
    # rows 0 to 2 (equal rows); rows 10 to 19; the repeat of 0 to 20; all but 80 to 99
    assert st["hits"] == 3 + 10 + 20 + 280
    assert gw.stats()["per_model"]["xgb"]["hit_requests"] == 1


@pytest.mark.parametrize("route,name", [
    ("flint:reference", "'flint'"),
    ("float:reference", "'float'"),
    ("flint:cuda", "'flint'"),
    ("flint:bitvector", "'flint'"),
    ("flint:cuda+tree_parallel:2", "'flint'"),
    ("integer:native_c", "'native_c'"),
    ("integer:native_c_table", "'native_c_table'"),
    ("integer:native_c_bitvector", "'native_c_bitvector'"),
    ("integer:cuda|native_c_table+tree_parallel:2", "'native_c_table'"),
    ("integer:reference+remote_tree_parallel:2", "'remote_tree_parallel'"),
])
def test_a_route_that_takes_no_margin_model_refuses_it_by_name(route, name):
    _, ir, *_ = case(*CASES[0])
    with pytest.raises(ValueError, match=f"{name}.*boosted \\(margin\\) model"):
        TreeEngine(ir, spec=route, device="cpu")


@pytest.mark.parametrize("entry", ["predict_mode", "predict_integer", "make_predict_fn"])
@pytest.mark.parametrize("c", CASES[:2], ids=lambda c: f"seed{c[0]}-C{c[1]}")
def test_the_core_entry_points_give_a_margin_models_margins(c, entry):
    from repro_torch import core

    model, _, x, ref_s, ref_p = case(*c)
    packed = core.pack_forest(GBT.program_model(model))
    s, p = {
        "predict_mode": lambda: core.predict_mode(packed, x, "integer", device="cpu"),
        "predict_integer": lambda: core.predict_integer(packed, x, device="cpu"),
        "make_predict_fn": lambda: core.make_predict_fn(packed, "integer", device="cpu")(x),
    }[entry]()
    assert s.dtype == np.int32 and p.dtype == np.int32
    assert np.array_equal(s, ref_s) and np.array_equal(p, ref_p)


@pytest.mark.parametrize("entry,name", [
    ("predict_mode:flint", "mode 'flint'"),
    ("predict_mode:float", "mode 'float'"),
    ("predict_float", "mode 'float'"),
    ("predict_flint", "mode 'flint'"),
    ("make_predict_fn:float", "mode 'float'"),
    ("make_partials_fn:flint", "mode 'flint'"),
    ("integer_probs", "integer_probs"),
])
def test_the_core_entry_points_refuse_a_margin_model_in_other_modes(entry, name):
    from repro_torch import core

    model, _, x, *_ = case(*CASES[0])
    packed = core.pack_forest(GBT.program_model(model))
    call = {
        "predict_mode:flint": lambda: core.predict_mode(packed, x, "flint", device="cpu"),
        "predict_mode:float": lambda: core.predict_mode(packed, x, "float", device="cpu"),
        "predict_float": lambda: core.predict_float(packed, x, device="cpu"),
        "predict_flint": lambda: core.predict_flint(packed, x, device="cpu"),
        "make_predict_fn:float": lambda: core.make_predict_fn(packed, "float", device="cpu"),
        "make_partials_fn:flint": lambda: core.make_partials_fn(packed, "flint", device="cpu"),
        "integer_probs": lambda: core.integer_probs(packed, np.zeros((2, 3), np.uint32)),
    }[entry]
    with pytest.raises(ValueError, match=f"{name}.*boosted \\(margin\\) model"):
        call()


@pytest.mark.parametrize("what", ["emit_c", "emit_table_walk_c", "emit_bitvector_c",
                                  "itrf", "to_numpy"])
def test_codegen_itrf_and_the_canonical_arrays_refuse_a_margin_model(what, tmp_path):
    from repro_torch.codegen.bitvector_emitter import emit_bitvector_c
    from repro_torch.codegen.c_emitter import emit_c
    from repro_torch.codegen.table_emitter import emit_table_walk_c

    _, ir, *_ = case(*CASES[0])
    call = {
        "emit_c": lambda: emit_c(ir.materialize("padded")),
        "emit_table_walk_c": lambda: emit_table_walk_c(ir.materialize("ragged")),
        "emit_bitvector_c": lambda: emit_bitvector_c(ir.materialize("bitvector")),
        "itrf": lambda: ir.to_itrf(tmp_path / "m.itrf"),
        "to_numpy": ir.to_numpy,
    }[what]
    with pytest.raises(ValueError, match="boosted \\(margin\\) model"):
        call()
    assert not (tmp_path / "m.itrf").exists()


def test_a_scale_that_cannot_bound_the_sum_is_rejected():
    model = GBT.make_forest(cfg_of(3, 3, 5), 4)
    huge = GBT.program_model(model)
    huge.base_ = np.array([1e9, 0.0, 0.0])  # (T + 1) * ceil(M) > 2**31 - 1: scale 0
    with pytest.raises(ValueError, match="cannot bound 19 signed terms"):
        ForestIR.from_forest(huge)
    infinite = GBT.program_model(model)
    infinite.trees_[1][2].leaf_probs[-1, 0] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        ForestIR.from_forest(infinite)
    # a leaf table past what the scale bounds, however it was built
    _, ir, *_ = case(*CASES[0])
    big = ir.leaf_fixed.copy()
    big[-1, ir.tree_class[-1]] = np.uint32(2 ** 31 - 1)
    with pytest.raises(ValueError, match="can leave int32"):
        dataclasses.replace(ir, leaf_fixed=big)
    with pytest.raises(ValueError, match="tree_class"):
        dataclasses.replace(ir, tree_class=ir.tree_class[1:])


def test_a_tree_shard_keeps_the_kind_and_the_parents_scale():
    _, ir, x, ref_s, _ = case(*CASES[1])
    sub = ir.subset(10, 30)
    assert sub.kind == "margin" and sub.scale == ir.scale
    assert np.array_equal(sub.tree_class, ir.tree_class[10:30])
    parts = [TreeEngine(ir.subset(a, b), spec="integer:reference", device="cpu")
             .predict_partials(x) for a, b in ((0, 10), (10, 30), (30, 42))]
    merged = (parts[0] + parts[1] + parts[2]).view(np.int32)  # wrapping uint32 sums
    assert np.array_equal(merged.astype(np.int64) + ir.base_fixed, ref_s)


def test_an_averaged_forest_keeps_its_uint32_scores():
    from repro_torch.trees.forest import RandomForestClassifier

    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
    rf = RandomForestClassifier(n_estimators=4, max_depth=4, seed=3).fit(X, y)
    ir = ForestIR.from_forest(rf)
    assert ir.kind == "averaged" and ir.tree_class is None and ir.trees_per_class() is None
    eng = TreeEngine(ir, spec="integer:cuda", device="cpu")
    s, p = eng.predict_scores(X)
    assert s.dtype == np.uint32 and np.array_equal(s, eng.predict_partials(X))
    assert np.array_equal(p, np.argmax(s, axis=1))
    assert eng.describe()["kind"] == "averaged" and "margin_scale" not in eng.describe()
    assert "margins" not in eng.drain_stage_timings()
    ForestIR.from_numpy(ir.to_numpy(), n_trees=ir.n_trees, n_classes=ir.n_classes,
                        n_features=ir.n_features)


def test_the_margins_stage_and_ranges():
    """``ir.margins`` around the IR's build, ``plan.margins`` inside
    ``plan.finalize``, and the stage ``margins`` beside ``finalize``."""
    model, _, x, *_ = case(*CASES[2])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ir = ForestIR.from_forest(GBT.program_model(model))
        eng = TreeEngine(ir, spec="integer:cuda", device="cpu")
        eng.predict_scores(x)
        eng.predict_scores(x[:7])
    names = {e.key for e in prof.key_averages()}
    assert {"ir.margins", "plan.finalize", "plan.margins"} <= names
    stages = eng.drain_stage_timings()
    assert stages["margins"][1] == stages["finalize"][1] == 2
    assert 0 < stages["margins"][0] <= stages["finalize"][0]


def test_the_harness_runs_a_boosted_cell_on_the_cpu(tmp_path):
    """A tiny ``gbt`` configuration on the ``bulk`` driver through
    ``portbench/run.py``: correct, traced and not, with the boosted cell's
    host-side metrics read; an altered answer is caught."""
    from portbench.test_portbench_runs import add_checkout, run_cell

    where = add_checkout(tmp_path)
    cfg = dict(cfg_of(7, 4, 9), name="tinyxgb")
    (where / "portbench" / "configs" / "tinyxgb.json").write_text(json.dumps(cfg))
    bench = json.loads((where / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyxgb", "source": "a test", "reduced": [],
                             "why": "a test", "file": "portbench/configs/tinyxgb.json"})
    bench["workloads"].append({"name": "tinyxgb.tbulk", "config": "tinyxgb",
                               "traffic": "tbulk", "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        if m["name"] in ("xgbcell.p95_ms", "xgbcell.margins_ms"):
            m["workloads"].append("tinyxgb.tbulk")
    (where / "BENCHMARK.json").write_text(json.dumps(bench))

    proc, result = run_cell(where, "tinyxgb.tbulk")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True and result["check"]["rows_checked"]["value"] > 0
    assert {"rows_per_s", "setup_s"} <= set(result["metrics"])
    proc, result = run_cell(where, "tinyxgb.tbulk", trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True
    assert {"xgbcell.p95_ms", "xgbcell.margins_ms", "mfu.trees"} <= set(result["metrics"])
    assert result["metrics"]["xgbcell.margins_ms"]["value"] > 0
    proc, result = run_cell(where, "tinyxgb.tbulk", "altered")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False and result["check"]["rows_wrong"]["value"] > 0
