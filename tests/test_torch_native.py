"""The port's host-C backends against the JAX package, bit for bit.

``native_c``, ``native_c_table`` and ``native_c_bitvector`` compile the
port's emitted C with gcc and serve it through ctypes on the host CPU.  On
the random forests of ``tests/test_backends.py`` and the degenerate forests
of ``tests/forest_cases.py``, their uint32 partials, scores and predictions
must equal the JAX ``reference`` backend's, tolerance 0, in ``flint`` and
``integer``, through every layout they declare, at every ``block_rows``
(1, 4, 8, 16) and ``interleave`` (1, 4, 8) with SIMD on and off, and under
``REPRO_CC_EXTRA_FLAGS=-mno-avx2``; ``native_c``'s float scores must equal
the JAX ``native_c``'s.  Their capabilities and ``simd_isa()`` are the JAX
backends'.  They run on the CPU whatever device they are given, and without
gcc they raise ``BackendUnavailable`` with no fallback.

The routes: the mixed plans (a C shard beside ``cuda``, ``bitvector`` or
``reference`` shards, ``row_parallel`` over C) against the JAX plans with
``pallas`` for ``cuda``, per-shard labels and ``simd_isa`` included; the
gateway's ``isa`` column; and the C autotune winners' round trip through
an ITRF file under ``torch-cpu:<isa>``.  Compiling tests carry
``requires_gcc``; libraries are built a few at a time on threads.
"""
import asyncio
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict

import numpy as np
import pytest
import torch

from forest_cases import DEGENERATE_FORESTS
from repro.backends import backend_class as jbackend_class
from repro.backends import create_backend as jcreate
from repro.ir import ForestIR as JForestIR
from repro.serve import Gateway as JGateway
from repro.serve import ModelRegistry as JModelRegistry
from repro.serve.engine import TreeEngine as JTreeEngine
from repro_torch.backends import (
    BackendUnavailable,
    CompiledCBackend,
    available_backends,
    backend_class,
    create_backend,
)
from repro_torch.ir import ForestIR
from repro_torch.ir.artifact import host_isa_key, inspect_itrf, serialize_tuned
from repro_torch.ir.forest_ir import ARRAY_DTYPES
from repro_torch.serve import EngineSpec, Gateway, ModelRegistry, TreeEngine

C_BACKENDS = ["native_c", "native_c_table", "native_c_bitvector"]
DETERMINISTIC = ("flint", "integer")


def _port_ir(jir):
    return ForestIR.from_numpy({k: getattr(jir, k) for k in ARRAY_DTYPES},
                               n_trees=jir.n_trees, n_classes=jir.n_classes,
                               n_features=jir.n_features, quant_scale=jir.quant_scale)


@pytest.fixture(scope="module", params=[(3, 7, 5), (11, 16, 7)], ids=["t7d5", "t16d7"])
def random_case(request):
    """(JAX IR, port IR, rows): the random forests of test_backends.py."""
    from repro.data.tabular import make_shuttle_like, train_test_split
    from repro.trees.forest import RandomForestClassifier

    seed, n_trees, depth = request.param
    X, y = make_shuttle_like(n=3000, seed=seed)
    Xtr, ytr, Xte, _ = train_test_split(X, y, seed=seed)
    rf = RandomForestClassifier(n_estimators=n_trees, max_depth=depth, seed=seed).fit(Xtr, ytr)
    jir = JForestIR.from_forest(rf)
    return jir, _port_ir(jir), Xte[:97]  # odd row count: partial row blocks


@pytest.fixture(scope="module")
def all_cases(random_case):
    """The random forest of this module instance beside every degenerate
    forest, each with its probe rows."""
    cases = {"random": random_case}
    for name in sorted(DEGENERATE_FORESTS):
        jir = JForestIR.from_forest(DEGENERATE_FORESTS[name]())
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        rows = rng.normal(0.0, 6.0, (33, jir.n_features)).astype(np.float32)
        cases[name] = (jir, _port_ir(jir), rows)
    return cases


_JAX_REF: dict = {}


def _jax_reference(jir, rows, mode):
    """The JAX reference backend's (partials, scores, preds), memoized."""
    key = (id(jir), rows.shape, mode)
    if key not in _JAX_REF:
        b = jcreate("reference", jir.materialize("padded"), mode=mode)
        s, p = b.predict_scores(rows)
        _JAX_REF[key] = (np.asarray(b.predict_partials(rows)), np.asarray(s), np.asarray(p))
    return _JAX_REF[key]


def _build_all(backends):
    """Compile the libraries a few at a time (gcc runs outside the GIL)."""
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda b: b._ensure_lib(), backends))
    return backends


def _assert_matches_jax_reference(b, jir, rows, label):
    partials, scores, preds = _jax_reference(jir, rows, b.mode)
    got = b.predict_partials(rows)
    assert got.dtype == np.uint32, label
    np.testing.assert_array_equal(got, partials, err_msg=label)
    s, p = b.predict_scores(rows)
    assert s.dtype == scores.dtype, label
    np.testing.assert_array_equal(s, scores, err_msg=label)
    np.testing.assert_array_equal(p, preds, err_msg=label)


# ------------------------------------------------------------ registry, host

@pytest.mark.parametrize("name", C_BACKENDS)
def test_capabilities_are_the_jax_backends(name):
    assert name in available_backends()
    assert asdict(backend_class(name).capabilities) == \
        asdict(jbackend_class(name).capabilities)
    assert issubclass(backend_class(name), CompiledCBackend)


@pytest.mark.parametrize("name", C_BACKENDS)
def test_c_backends_run_on_the_host_whatever_device_they_get(small_packed, name):
    """No device is resolved: ``None`` and a card this host lacks both give
    a CPU backend (constructing compiles nothing)."""
    layout = backend_class(name).capabilities.preferred_layout
    art = _port_ir(small_packed.to_ir()).materialize(layout)
    for device in (None, "cuda", "cuda:3", "cpu"):
        assert backend_class(name).placement(device) == torch.device("cpu")
        assert create_backend(name, art, mode="integer", device=device).device.type == "cpu"


def test_knobs_are_checked_as_in_the_jax_package(small_packed):
    ir = _port_ir(small_packed.to_ir())
    with pytest.raises(ValueError, match="block_rows"):
        create_backend("native_c_table", ir.materialize("ragged"), block_rows=0)
    with pytest.raises(ValueError, match="interleave"):
        create_backend("native_c_bitvector", ir.materialize("bitvector"), interleave=0)
    with pytest.raises(ValueError, match="layout"):
        create_backend("native_c_table", ir.materialize("padded"))
    with pytest.raises(ValueError, match="mode"):
        create_backend("native_c_table", ir.materialize("ragged"), mode="float")
    t = create_backend("native_c_table", ir.materialize("ragged"))
    v = create_backend("native_c_bitvector", ir.materialize("bitvector"))
    assert (t.block_rows, t.simd, v.interleave, v.simd) == (8, True, 8, True)


@pytest.mark.parametrize("name", C_BACKENDS)
def test_without_gcc_the_backend_raises_and_nothing_falls_back(small_packed, monkeypatch,
                                                              name):
    layout = backend_class(name).capabilities.preferred_layout
    ir = _port_ir(small_packed.to_ir())
    rows = np.zeros((3, ir.n_features), np.float32)
    monkeypatch.setenv("PATH", "")
    b = create_backend(name, ir.materialize(layout), mode="integer")
    with pytest.raises(BackendUnavailable, match="needs a C compiler; 'gcc' not on PATH"):
        b.predict_partials(rows)
    assert b.simd_isa() is None
    eng = TreeEngine(ir, spec=f"integer:{name}", device="cpu")
    with pytest.raises(BackendUnavailable):
        eng.predict_scores(rows)


@pytest.mark.requires_gcc
def test_a_refused_build_raises_with_the_compilers_message(small_packed):
    ir = _port_ir(small_packed.to_ir())
    b = create_backend("native_c_table", ir.materialize("ragged"),
                       cflags=("-O2", "-fno-such-option-anywhere"))
    with pytest.raises(BackendUnavailable, match="no-such-option-anywhere"):
        b.predict_partials(np.zeros((2, ir.n_features), np.float32))


# ------------------------------------------------------- compiled partials

@pytest.mark.requires_gcc
@pytest.mark.parametrize("name", C_BACKENDS)
def test_partials_are_the_jax_reference_on_every_layout(all_cases, name):
    """Every (layout, deterministic mode) the backend declares, on the
    random forest and the degenerate ones."""
    caps = backend_class(name).capabilities
    built = []
    for case, (jir, pir, rows) in all_cases.items():
        for layout in caps.supported_layouts:
            for mode in DETERMINISTIC:
                b = create_backend(name, pir.materialize(layout), mode=mode)
                built.append((f"{case}/{layout}/{mode}", b, jir, rows))
    _build_all([b for _, b, _, _ in built])
    for label, b, jir, rows in built:
        _assert_matches_jax_reference(b, jir, rows, f"{name}/{label}")
        assert b.build_info["source_bytes"] > 0


@pytest.mark.requires_gcc
@pytest.mark.parametrize("simd", [True, False], ids=["simd", "scalar"])
@pytest.mark.parametrize("block_rows", [1, 4, 8, 16])
def test_table_walk_block_rows(all_cases, block_rows, simd):
    built = [(case, create_backend("native_c_table", pir.materialize("ragged"),
                                   mode="integer", block_rows=block_rows, simd=simd), jir, rows)
             for case, (jir, pir, rows) in all_cases.items()]
    _build_all([b for _, b, _, _ in built])
    for case, b, jir, rows in built:
        _assert_matches_jax_reference(b, jir, rows, f"{case}/rows{block_rows}/simd={simd}")
        isa = b.simd_isa()
        assert isa in ("avx2", "neon", "scalar")
        if not simd or block_rows == 1:
            assert isa == "scalar"


@pytest.mark.requires_gcc
@pytest.mark.parametrize("simd", [True, False], ids=["simd", "scalar"])
@pytest.mark.parametrize("interleave", [1, 4, 8])
def test_bitvector_interleave(all_cases, interleave, simd):
    built = [(case, create_backend("native_c_bitvector", pir.materialize("bitvector"),
                                   mode="integer", interleave=interleave, simd=simd),
              jir, rows)
             for case, (jir, pir, rows) in all_cases.items()]
    _build_all([b for _, b, _, _ in built])
    for case, b, jir, rows in built:
        _assert_matches_jax_reference(b, jir, rows, f"{case}/k{interleave}/simd={simd}")
        isa = b.simd_isa()
        assert isa == "scalar" if not simd else (isa == "scalar"
                                                 or isa.endswith(f"-k{interleave}"))


@pytest.mark.requires_gcc
@pytest.mark.parametrize("name", C_BACKENDS)
def test_builds_without_avx2_stay_bit_identical(random_case, monkeypatch, name):
    """``REPRO_CC_EXTRA_FLAGS=-mno-avx2`` degrades every unit to its scalar
    path, as in the JAX package."""
    jir, pir, rows = random_case
    monkeypatch.setenv("REPRO_CC_EXTRA_FLAGS", "-mno-avx2")
    layout = backend_class(name).capabilities.preferred_layout
    b = create_backend(name, pir.materialize(layout), mode="integer")
    assert "-DREPRO_NO_SIMD" in b._effective_cflags
    _assert_matches_jax_reference(b, jir, rows, f"{name} -mno-avx2")
    assert b.simd_isa() == "scalar"


@pytest.mark.requires_gcc
@pytest.mark.parametrize("name,kwargs", [
    ("native_c", {}), ("native_c_table", {}), ("native_c_table", {"block_rows": 1}),
    ("native_c_table", {"simd": False}), ("native_c_bitvector", {}),
    ("native_c_bitvector", {"interleave": 4}), ("native_c_bitvector", {"simd": False}),
], ids=lambda v: v if isinstance(v, str) else ",".join(f"{k}={x}" for k, x in v.items()))
def test_simd_isa_is_the_jax_backends(small_packed, name, kwargs):
    layout = backend_class(name).capabilities.preferred_layout
    jir = small_packed.to_ir()
    port = create_backend(name, _port_ir(jir).materialize(layout), mode="integer", **kwargs)
    jax = jcreate(name, jir.materialize(layout), mode="integer", **kwargs)
    _build_all([port, jax])
    assert port.simd_isa() == jax.simd_isa()


@pytest.mark.requires_gcc
def test_native_c_float_scores_are_the_jax_native_cs(random_case):
    jir, pir, rows = random_case
    port = create_backend("native_c", pir.materialize("padded"), mode="float")
    jax = jcreate("native_c", jir.materialize("padded"), mode="float")
    _build_all([port, jax])
    s, p = port.predict_scores(rows)
    js, jp = jax.predict_scores(rows)
    assert s.dtype == np.float32
    np.testing.assert_array_equal(s, np.asarray(js))
    np.testing.assert_array_equal(p, np.asarray(jp))
    with pytest.raises(NotImplementedError):
        port.predict_partials(rows)


# ------------------------------------------------------------------ routes

J_BACKEND = {"cuda": "pallas"}
MIXED_ROUTES = [
    "integer:cuda|native_c_table+tree_parallel:2",
    "flint:bitvector|native_c_bitvector+tree_parallel:2",
    "integer:native_c_table|reference+tree_parallel:3",
    "integer:native_c|cuda+tree_parallel:2",
    "integer:native_c_table+row_parallel:2",
    "flint:native_c_bitvector+row_parallel:3",
    "float:native_c+row_parallel:2",
]


def _jax_route(spec: str) -> str:
    s = EngineSpec.parse(spec, validate=False)
    names = [s.backend] if isinstance(s.backend, str) else list(s.backend)
    return str(s.replace(backend="|".join(J_BACKEND.get(n, n) for n in names)))


@pytest.mark.requires_gcc
@pytest.mark.parametrize("spec", MIXED_ROUTES)
def test_mixed_plans_are_the_jax_plans(random_case, spec):
    """A C shard beside a card backend's plain version, K5's, or the
    reference walk, and row shards over C: the JAX plan's bits, shard labels
    and ``simd_isa``."""
    jir, pir, rows = random_case
    eng = TreeEngine(pir, spec=spec, device="cpu")
    jeng = JTreeEngine(jir, _jax_route(spec))
    s, p = eng.predict_scores(rows)
    js, jp = jeng.predict_scores(rows)
    assert s.dtype == np.asarray(js).dtype
    np.testing.assert_array_equal(s, np.asarray(js), err_msg=spec)
    np.testing.assert_array_equal(p, np.asarray(jp), err_msg=spec)
    labels = sorted(eng.drain_shard_timings())
    assert labels == sorted(l.replace("pallas", "cuda") for l in jeng.drain_shard_timings())
    assert [b.name for b in eng.plan.backends] == \
        [b.name.replace("pallas", "cuda") for b in jeng.plan.backends]
    assert eng.simd_isa() == jeng.simd_isa()
    assert all(b.device.type == "cpu" for b in eng.plan.backends)
    eng.close()
    jeng.close()


@pytest.mark.requires_gcc
def test_gateway_records_the_isa_as_the_jax_gateway_does(random_case):
    """The ``isa`` column reaches the gateway metrics: a plan whose first
    shard is C reports its dispatched ISA, one whose first shard is on the
    card reports none (``-``), in both packages."""
    jir, pir, rows = random_case
    routes = ("integer:native_c_table|cuda+tree_parallel:2",
              "integer:cuda|native_c_table+tree_parallel:2", "integer:native_c_bitvector")

    async def serve(gw, n_rows):
        out = await gw.submit("m", rows[:n_rows])
        await gw.close()
        return out

    for route in routes:
        reg, jreg = ModelRegistry(), JModelRegistry()
        reg.register_packed("m", pir)
        jreg.register_packed("m", jir)
        gw = Gateway(reg, route, device="cpu", cache_rows=0)
        jgw = JGateway(jreg, _jax_route(route), cache_rows=0)
        s, p = asyncio.run(serve(gw, 40))
        js, jp = asyncio.run(serve(jgw, 40))
        np.testing.assert_array_equal(s, np.asarray(js), err_msg=route)
        isa = gw.stats()["per_model"]["m"]["isa"]
        assert isa == jgw.stats()["per_model"]["m"]["isa"], route
        assert (isa == "-") == route.startswith("integer:cuda"), route
        assert isa in gw.render_table()


@pytest.mark.requires_gcc
@pytest.mark.parametrize("name,knob", [("native_c_bitvector", "interleave"),
                                       ("native_c_table", "block_rows")])
def test_c_tunes_round_trip_under_the_cpu_host_key(small_packed, tmp_path, name, knob):
    """A C route's measured winner is a property of the host CPU: it is keyed
    on ``cpu``, written under ``torch-cpu:<isa>``, read back by the port's
    registry (which then skips the sweep) and ignored by the JAX one."""
    from repro_torch.serve import autotune as at

    path = str(tmp_path / "m.itrf")
    _port_ir(small_packed.to_ir().subset(0, 4)).to_itrf(path)
    reg = ModelRegistry()
    mv = reg.register_artifact("m", path)
    eng = mv.engine(f"integer:{name}?autotune=true", device="cpu")
    eng.warm(64)
    grid = at.candidate_grid(name, eng.backend.packed)
    assert [kw[knob] for kw in grid] == ([8, 1, 4, 16] if knob == "block_rows" else [8, 1, 4])
    (key, winner), = mv._tuned.items()
    assert key[0] == name and key[4] == "cpu" and winner in grid
    assert eng.tuned_config == at.config_str(winner)
    assert "tune" in eng.drain_compile_timings()
    assert list(serialize_tuned(mv._tuned)) == [f"torch-cpu:{host_isa_key()}"]
    reg.export_tuned("m", path)
    assert inspect_itrf(path)["tuned_hosts"] == [f"torch-cpu:{host_isa_key()}"]
    mv2 = ModelRegistry().register_artifact("m", path)
    assert mv2._tuned == mv._tuned
    eng2 = mv2.engine(f"integer:{name}?autotune=true", device="cpu")
    eng2.warm(64)
    assert eng2.tuned_config == eng.tuned_config
    assert "tune" not in eng2.drain_compile_timings()
    assert JModelRegistry().register_artifact("m", path)._tuned == {}
    rows = np.random.default_rng(2).normal(0, 2, (50, mv.packed.n_features)).astype(np.float32)
    np.testing.assert_array_equal(eng2.predict_scores(rows)[0], eng.predict_scores(rows)[0])
