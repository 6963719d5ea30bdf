"""The port's execution plans against the JAX package's, bit for bit.

The cases of ``tests/test_plans.py``, each run through the port with
``device="cpu"`` (the kernels' plain versions) and held against the JAX
engine on the same inputs, tolerance 0: plan registry and auto-selection,
``tree_parallel`` refusing ``float`` and ``single`` refusing several shards,
``tree_ranges`` and the core-budget clamp, bit identity across plans x
backends (``reference``, ``cuda``, ``bitvector``; the JAX counterpart of
``cuda`` is ``pallas``) x ``DEGENERATE_FORESTS``, the heterogeneous
``cuda|bitvector|reference`` plan, forced threads against auto (the fused
strategy is not ported, so ``device_parallel=True`` raises on one device as
it does in the JAX package, and where the JAX rule would fuse, "auto" takes
the threaded path and only ``True`` raises), warm covering every shard, and
shard timings draining into the gateway.
"""
import asyncio

import numpy as np
import pytest

from forest_cases import DEGENERATE_FORESTS
from repro.ir import ForestIR as JForestIR
from repro.plan import select_plan as j_select_plan
from repro.plan import tree_ranges as j_tree_ranges
from repro.serve.engine import TreeEngine as JTreeEngine
from repro_torch.backends import backend_class
from repro_torch.ir import ForestIR
from repro_torch.ir.forest_ir import ARRAY_DTYPES
from repro_torch.plan import (
    RowParallelPlan,
    SingleShardPlan,
    TreeParallelPlan,
    available_plans,
    create_plan,
    plan_class,
    select_plan,
    thread_shard_cap,
    tree_ranges,
)
from repro_torch.serve import EngineSpec, Gateway, ModelRegistry, TreeEngine

BACKENDS = ["reference", "cuda", "bitvector"]
#: the JAX package's backend for each of the port's
J_BACKEND = {"reference": "reference", "cuda": "pallas", "bitvector": "bitvector"}
PLAN_SPECS = [
    ("single", None),
    ("tree_parallel", 2),
    ("tree_parallel", 3),
    ("tree_parallel", 8),
    ("row_parallel", 2),
    ("row_parallel", 4),
]


def _jax_spec(spec: str) -> str:
    """The JAX route for a port route: ``cuda`` -> ``pallas``."""
    s = EngineSpec.parse(spec, validate=False)
    names = [s.backend] if isinstance(s.backend, str) else list(s.backend)
    return str(s.replace(backend="|".join(J_BACKEND[n] for n in names)))


def _port_ir(jir):
    return ForestIR.from_numpy({k: getattr(jir, k) for k in ARRAY_DTYPES},
                               n_trees=jir.n_trees, n_classes=jir.n_classes,
                               n_features=jir.n_features, quant_scale=jir.quant_scale)


def _scores(eng, rows):
    s, p = eng.predict_scores(rows)
    return np.asarray(s), np.asarray(p)


def _assert_same(got, want, label):
    assert got[0].dtype == want[0].dtype, label
    np.testing.assert_array_equal(got[0], want[0], err_msg=label)
    np.testing.assert_array_equal(got[1], want[1], err_msg=label)


@pytest.fixture(scope="module")
def irs(small_forest):
    """(reference IR, the port's IR carried across as numpy)."""
    jir = JForestIR.from_forest(small_forest)
    return jir, _port_ir(jir)


@pytest.fixture(scope="module")
def probe_rows(shuttle_small):
    _, _, Xte, _ = shuttle_small
    return Xte[:33]  # odd row count: partial row chunks and padding


@pytest.fixture(scope="module")
def jax_scores(irs, probe_rows):
    """The JAX single plan's scores per mode, which every JAX plan equals
    (``tests/test_plans.py``)."""
    jir, _ = irs
    return {mode: _scores(JTreeEngine(jir, spec=f"{mode}:reference"), probe_rows)
            for mode in ("float", "flint", "integer")}


# ------------------------------------------------------------------ registry

def test_plan_registry_contents():
    assert set(available_plans()) == {"single", "tree_parallel", "row_parallel",
                                      "remote_tree_parallel"}
    assert plan_class("tree_parallel") is TreeParallelPlan
    assert plan_class("row_parallel") is RowParallelPlan
    assert plan_class("single") is SingleShardPlan
    assert TreeParallelPlan.deterministic_only and not RowParallelPlan.deterministic_only
    with pytest.raises(KeyError, match="single"):
        plan_class("no-such-plan")


@pytest.mark.parametrize("kw", [
    dict(mode="integer"), dict(mode="integer", shards=1), dict(mode="integer", shards=4),
    dict(mode="flint", shards=2), dict(mode="float", shards=4),
    dict(mode="integer", backend=("reference", "cuda")),
    dict(mode="integer", shards=3, plan="row_parallel"),
    dict(mode="integer", shards=2, model=False),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_plan_auto_selection(irs, kw):
    """The port selects the plan the JAX package selects."""
    jir, ir = irs
    kw = dict(kw)
    plan = kw.pop("plan", None)
    with_model = kw.pop("model", True)
    backend = kw.pop("backend", "reference")
    j_backend = backend if isinstance(backend, str) else \
        tuple(J_BACKEND[b] for b in backend)
    got = select_plan(plan, backend=backend, model=ir if with_model else None, **kw)
    want = j_select_plan(plan, backend=j_backend, model=jir if with_model else None, **kw)
    assert got == want
    with pytest.raises(KeyError, match="no-such"):
        select_plan("no-such-plan", mode="integer", backend="reference")


def test_tree_parallel_rejects_float(irs):
    _, ir = irs
    with pytest.raises(ValueError, match="partials"):
        create_plan("tree_parallel", ir, mode="float", shards=2, device="cpu")


def test_single_plan_rejects_multi_shards(irs):
    _, ir = irs
    with pytest.raises(ValueError, match="single"):
        create_plan("single", ir, mode="integer", shards=3, device="cpu")


@pytest.mark.parametrize("n_trees", [1, 3, 9, 11, 128])
def test_tree_ranges_match_reference(n_trees):
    for shards in (1, 2, 3, 4, 8, 200):
        spans = tree_ranges(n_trees, shards)
        assert spans == j_tree_ranges(n_trees, shards)
        assert spans[0][0] == 0 and spans[-1][1] == n_trees
        assert all(b1 == a2 for (_, b1), (a2, _) in zip(spans[:-1], spans[1:]))
        assert len(spans) == min(shards, n_trees)


def test_threaded_shards_clamped_to_core_budget(irs, probe_rows, jax_scores,
                                                monkeypatch):
    """Threaded fan-out is clamped to the cores, and clamping never moves a
    bit; ``clamp_shards=False`` and an explicit backend mix opt out."""
    _, ir = irs
    monkeypatch.setattr("os.cpu_count", lambda: 2)
    assert thread_shard_cap() == 2
    eng = TreeEngine(ir, spec="integer:reference+tree_parallel:8", device="cpu")
    assert not eng.plan.fused and eng.n_shards == 2
    _assert_same(_scores(eng, probe_rows), jax_scores["integer"], "clamped")
    monkeypatch.setattr("os.cpu_count", lambda: 1)
    assert thread_shard_cap() == 2
    eng = TreeEngine(ir, spec="integer:reference+tree_parallel:8", device="cpu",
                     plan_kwargs={"clamp_shards": False})
    assert eng.n_shards == min(8, ir.n_trees)
    _assert_same(_scores(eng, probe_rows), jax_scores["integer"], "unclamped")
    eng = TreeEngine(ir, spec="integer:reference|cuda|bitvector|reference",
                     device="cpu")
    assert eng.n_shards == 4
    _assert_same(_scores(eng, probe_rows), jax_scores["integer"], "mix")


# ----------------------------------------------------- the acceptance matrix

@pytest.mark.parametrize("plan,shards", PLAN_SPECS,
                         ids=[f"{p}-{s}" for p, s in PLAN_SPECS])
@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_bit_identity(irs, probe_rows, jax_scores, backend, plan, shards):
    """flint/integer scores of every plan x backend x layout the backend
    walks equal the JAX package's; the JAX engine runs the same route on its
    counterpart backend for the two-shard plans."""
    jir, ir = irs
    caps = backend_class(backend).capabilities
    for layout in caps.supported_layouts:
        for mode in caps.deterministic_modes:
            spec = f"{mode}:{backend}@{layout}+{plan}" + (f":{shards}" if shards else "")
            eng = TreeEngine(ir, spec=spec, device="cpu")
            got = _scores(eng, probe_rows)
            _assert_same(got, jax_scores[mode], spec)
            if shards == 2:
                _assert_same(got, _scores(JTreeEngine(jir, spec=_jax_spec(spec)),
                                          probe_rows), f"{spec} against JAX's route")
            assert eng.plan_name == plan and eng.layout == layout
            if plan == "tree_parallel":
                assert eng.n_shards == min(shards, ir.n_trees, thread_shard_cap())
                assert [b.name for b in eng.plan.backends] == [backend] * eng.n_shards
            elif plan == "row_parallel":
                assert eng.n_shards == shards


def test_row_parallel_float_is_bit_exact(irs, probe_rows, jax_scores):
    """Row shards leave every row's float accumulation as it was."""
    jir, ir = irs
    eng = TreeEngine(ir, spec="float:reference+row_parallel:3", device="cpu")
    got = _scores(eng, probe_rows)
    _assert_same(got, jax_scores["float"], "float row_parallel")
    _assert_same(got, _scores(JTreeEngine(jir, spec="float:reference+row_parallel:3"),
                              probe_rows), "float row_parallel against JAX's")
    with pytest.raises(NotImplementedError, match="partials"):
        eng.plan.predict_partials(probe_rows)


@pytest.mark.parametrize("plan,shards", [("tree_parallel", 3), ("row_parallel", 2)])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(DEGENERATE_FORESTS))
def test_plan_bit_identity_degenerate(case, backend, plan, shards):
    """Stumps, one tree and a depth-skewed mix through the sharded plans:
    more shards than trees degenerate to one tree per shard."""
    jir = JForestIR.from_forest(DEGENERATE_FORESTS[case]())
    ir = _port_ir(jir)
    rng = np.random.default_rng(sum(map(ord, case)))
    rows = rng.normal(0.0, 6.0, (19, jir.n_features)).astype(np.float32)
    for mode in ("flint", "integer"):
        spec = f"{mode}:{backend}+{plan}:{shards}"
        got = _scores(TreeEngine(ir, spec=spec, device="cpu"), rows)
        _assert_same(got, _scores(JTreeEngine(jir, spec=f"{mode}:reference"), rows), spec)
        _assert_same(got, _scores(JTreeEngine(jir, spec=_jax_spec(spec)), rows),
                     f"{spec} against JAX's route")


def test_heterogeneous_cuda_bitvector_reference(irs, probe_rows, jax_scores):
    """One plan over three backends (the walks, the QuickScorer scorer and
    the reference walk), each shard on its own preferred layout, equals the
    JAX package's ``pallas|bitvector|reference`` plan and its single plan."""
    jir, ir = irs
    for mode in ("flint", "integer"):
        spec = f"{mode}:cuda|bitvector|reference"
        eng = TreeEngine(ir, spec=spec, device="cpu")
        assert eng.plan_name == "tree_parallel"
        assert [b.name for b in eng.plan.backends] == ["cuda", "bitvector", "reference"]
        assert eng.layout == "leaf_major+bitvector+padded"
        assert eng.backend_name == "cuda+bitvector+reference"
        got = _scores(eng, probe_rows)
        _assert_same(got, jax_scores[mode], spec)
        ref = JTreeEngine(jir, spec=_jax_spec(spec))
        assert ref.plan.ranges == eng.plan.ranges
        _assert_same(got, _scores(ref, probe_rows), f"{spec} against JAX's route")
        np.testing.assert_array_equal(eng.predict_partials(probe_rows),
                                      np.asarray(ref.predict_partials(probe_rows)))


def test_forced_threads_match_auto_and_fused_raises(irs, probe_rows):
    """Auto and forced threads agree; on fewer devices than shards (the CPU
    is one device) ``device_parallel=True`` raises as in the JAX package,
    naming the fused strategy that waits for several cards."""
    jir, ir = irs
    auto = TreeEngine(ir, spec="integer:reference+tree_parallel:2", device="cpu")
    thr = TreeEngine(ir, spec="integer:reference+tree_parallel:2", device="cpu",
                     plan_kwargs={"device_parallel": False})
    assert not auto.plan.fused and not thr.plan.fused
    assert auto.plan.describe()["fused"] is False
    _assert_same(_scores(auto, probe_rows), _scores(thr, probe_rows), "auto vs threads")
    for spec in ("integer:reference+tree_parallel:2", "integer:cuda+tree_parallel:2"):
        with pytest.raises(ValueError, match="several cards"):
            TreeEngine(ir, spec=spec, device="cpu", plan_kwargs={"device_parallel": True})
    with pytest.raises(ValueError, match="jax devices"):
        JTreeEngine(jir, spec="integer:pallas+tree_parallel:2",
                    plan_kwargs={"device_parallel": True})


def test_auto_takes_threads_where_the_fused_rule_applies(irs, probe_rows, monkeypatch):
    """Where the JAX package's rule picks the fused strategy (made true
    here, as on a host with a card per shard), ``device_parallel="auto"``
    builds the threaded plan, bit-identical to ``single``, and only
    ``device_parallel=True`` raises for want of the fused strategy."""
    _, ir = irs
    asked = []
    monkeypatch.setattr(TreeParallelPlan, "_can_fuse",
                        lambda self, *args: asked.append(args[-1]) or True)
    spec = "integer:reference+tree_parallel:2"
    single = TreeEngine(ir, spec="integer:reference", device="cpu")
    for kw in ({}, {"plan_kwargs": {"device_parallel": "auto"}}):
        auto = TreeEngine(ir, spec=spec, device="cpu", **kw)
        assert auto.plan.name == "tree_parallel" and auto.plan.n_shards == 2
        assert not auto.plan.fused and auto.plan.describe()["fused"] is False
        _assert_same(_scores(auto, probe_rows), _scores(single, probe_rows), "auto vs single")
        auto.close()
    assert asked == ["auto", "auto"]
    with pytest.raises(ValueError, match="fused .* not ported"):
        TreeEngine(ir, spec=spec, device="cpu", plan_kwargs={"device_parallel": True})


def test_engine_partials_match_scores(irs, probe_rows):
    """Engine-level partials are the integer scores, through the bucketed
    path, for the single and the sharded plans."""
    _, ir = irs
    for spec in ("integer:bitvector", "integer:cuda+tree_parallel:3",
                 "integer:bitvector+row_parallel:2"):
        eng = TreeEngine(ir, spec=spec, device="cpu")
        np.testing.assert_array_equal(eng.predict_partials(probe_rows),
                                      _scores(eng, probe_rows)[0], err_msg=spec)


def test_shard_partials_merge_to_the_whole(irs, probe_rows):
    """Each tree shard's backend is built on ``ForestIR.subset`` and its
    partials add up, mod 2^32, to the single plan's."""
    _, ir = irs
    plan = create_plan("tree_parallel", ir, backend=("cuda", "bitvector"), shards=3,
                       device="cpu")
    assert plan.ranges == tree_ranges(ir.n_trees, 3)
    whole = create_plan("single", ir, backend="reference", device="cpu")
    parts = [b.predict_partials(probe_rows) for b in plan.backends]
    for b, (a, e) in zip(plan.backends, plan.ranges):
        assert b.packed.n_trees == e - a and b.packed.scale == ir.scale
        assert b.device.type == "cpu"
    np.testing.assert_array_equal(sum(parts[1:], parts[0]),
                                  whole.predict_partials(probe_rows))
    np.testing.assert_array_equal(plan.predict_partials(probe_rows),
                                  whole.predict_partials(probe_rows))
    assert set(plan.drain_stage_timings()) == {"merge"}
    plan.close()
    plan.close()  # idempotent, and the plan stays usable
    np.testing.assert_array_equal(plan.predict_partials(probe_rows[:5]),
                                  whole.predict_partials(probe_rows[:5]))
    plan.close()


# ------------------------------------------------------------- warm + timing

@pytest.mark.parametrize("spec", ["integer:reference+row_parallel:4",
                                  "integer:bitvector+tree_parallel:3",
                                  "integer:reference|bitvector+tree_parallel:2"])
def test_warm_covers_every_shard(irs, monkeypatch, spec):
    """warm() drives every shard backend at the shapes real predicts hand
    it: after warming, no predict of 1 to 16 rows presents a new shape to
    any shard."""
    from repro_torch.backends.bitvector import BitvectorBackend
    from repro_torch.backends.reference import ReferenceBackend

    _, ir = irs
    seen = []
    for cls in (ReferenceBackend, BitvectorBackend):
        orig = cls.predict_partials

        def spy(self, X, _orig=orig):
            seen.append((id(self), np.asarray(X).shape[0]))
            return _orig(self, X)

        monkeypatch.setattr(cls, "predict_partials", spy)
    eng = TreeEngine(ir, spec=spec, device="cpu", max_bucket=16)
    eng.warm(16)
    warm_shapes = set(seen)
    assert {i for i, _ in warm_shapes} == {id(b) for b in eng.plan.backends}
    seen.clear()
    for b in (1, 5, 13, 16):
        eng.predict(np.zeros((b, ir.n_features), np.float32))
    assert seen and set(seen) <= warm_shapes, spec


def test_plan_shard_timings_drain(irs, shuttle_small):
    _, _, Xte, _ = shuttle_small
    _, ir = irs
    eng = TreeEngine(ir, spec="integer:cuda|bitvector+tree_parallel:3", device="cpu")
    eng.predict_scores(Xte[:8])
    t = eng.drain_shard_timings()
    assert sorted(t) == ["s0:cuda[0:3]", "s1:bitvector[3:6]", "s2:cuda[6:9]"]
    assert all(ms >= 0 and calls == 1 for ms, calls in t.values())
    assert eng.drain_shard_timings() == {}
    assert set(eng.drain_stage_timings()) == {"pad", "merge", "finalize"}


def test_gateway_surfaces_shard_timings(small_forest, shuttle_small):
    """A gateway on a heterogeneous tree-parallel route answers as the JAX
    gateway does, and its stats and table show one label per shard;
    ``plan_kwargs`` reach the engine and key the registry's memo."""
    from repro.serve.gateway import Gateway as JGateway
    from repro.serve.registry import ModelRegistry as JModelRegistry

    _, _, Xte, _ = shuttle_small
    reg, jreg = ModelRegistry(), JModelRegistry()
    reg.register_forest("m", small_forest)
    jreg.register_forest("m", small_forest)
    spec = "integer:cuda|bitvector+tree_parallel:2"
    gw = Gateway(reg, spec, max_delay_ms=1.0, device="cpu",
                 plan_kwargs={"device_parallel": False})
    jgw = JGateway(jreg, _jax_spec(spec), max_delay_ms=1.0,
                   plan_kwargs={"device_parallel": False})

    async def run(g):
        out = [await g.submit("m", Xte[i:i + n]) for i, n in ((0, 8), (8, 1), (0, 8))]
        await g.close()
        return out

    for got, want in zip(asyncio.run(run(gw)), asyncio.run(run(jgw))):
        _assert_same(got, tuple(np.asarray(a) for a in want), "gateway")
    shards = gw.stats()["per_model"]["m"]["shards"]
    assert sorted(shards) == ["s0:cuda[0:4]", "s1:bitvector[4:9]"]
    assert all(v["calls"] >= 1 for v in shards.values())
    assert gw.render_table().splitlines()[-1].split()[-2] == "2"
    mv = reg.get("m")
    eng = mv.engine(spec, device="cpu", plan_kwargs={"device_parallel": False})
    assert mv.engine(spec, device="cpu", plan_kwargs={"device_parallel": False}) is eng
    assert mv.engine(spec, device="cpu") is not eng
    assert "integer/cuda|bitvector/None/tree_parallel/cpu" in \
        reg.describe()["m"]["engine_builds"]


def test_gateway_validates_sharded_routes(small_forest):
    reg = ModelRegistry()
    reg.register_forest("m", small_forest)
    with pytest.raises(ValueError, match="partials"):
        Gateway(reg, "float:reference+tree_parallel:2", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        Gateway(reg, "float:reference|bitvector", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        Gateway(reg, "integer:cuda|bitvector@padded", device="cpu")
    gw = Gateway(reg, "float:reference+row_parallel:2", device="cpu")
    assert gw.cache.capacity_rows == 0
    assert Gateway(reg, "integer:cuda|bitvector", device="cpu").cache.capacity_rows > 0


@pytest.mark.parametrize("spec", ["integer:cuda|bitvector+tree_parallel:2",
                                  "integer:reference+row_parallel:3"])
def test_many_threads_share_one_plan(irs, probe_rows, jax_scores, spec, monkeypatch):
    """More callers than cores share one sharded engine, with a short
    switch interval: every answer is right, one shard pool serves them all,
    and the shard ledger counts every call (a lost update would not)."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    import repro_torch.plan.row_parallel as rp
    import repro_torch.plan.tree_parallel as tp

    _, ir = irs
    eng = TreeEngine(ir, spec=spec, device="cpu")
    made = []

    def counting_pool(*args, **kw):
        made.append(1)
        return ThreadPoolExecutor(*args, **kw)

    for module in (rp, tp):
        monkeypatch.setattr(module, "ThreadPoolExecutor", counting_pool)
    callers = 2 * (os.cpu_count() or 1) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(callers) as pool:
            futs = [pool.submit(eng.predict_scores, probe_rows) for _ in range(3 * callers)]
            outs = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for got in outs:
        _assert_same(tuple(np.asarray(a) for a in got), jax_scores["integer"], spec)
    calls = sum(c for _, c in eng.drain_shard_timings().values())
    assert calls == len(outs) * eng.n_shards and len(made) == 1
    eng.close()
    assert eng.plan._pool is None
