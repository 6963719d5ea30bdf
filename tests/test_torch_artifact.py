"""The port's ITRF artifact, ``packed_leaf`` layout, registry integration and
converter against the JAX package's, byte for byte and bit for bit.

The cases of ``tests/test_artifact.py``, each run through ``repro_torch``
with ``device="cpu"`` (the kernels' plain versions) and, where the JAX
package computes the same thing, held against it, tolerance 0 in the
deterministic modes and the same bytes for every section: round trips with
mmap on and off (the degenerate forests, the 36-word chain, a single
stump), inspect, newer-major refusal, bad magic and truncation, unknown
sections skipped, read-only mmap views that no layout's tables alias, the
group codec's edges and its dictionary/raw choice, ``packed_leaf``
registered, smaller and refusing float, ``register_artifact`` serving as
JSON does with its load in the ledger, hot-swap reuse, retention and gateway
pruning, ``tune_db`` persistence with foreign hosts ignored (in both
packages' directions), the worker HELLO fast path, the convert CLI, and
byte compatibility: a file written by either package loads in the other
with identical arrays and partials, and both ``--verify`` print one digest.
"""
import asyncio
import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

from forest_cases import DEGENERATE_FORESTS, chain_tree, forest_from_trees
from repro.ir import ForestIR as JForestIR
from repro.ir import artifact as jart
from repro.ir import packed_leaf as jpl
from repro.serve.engine import TreeEngine as JTreeEngine
from repro.serve.registry import ModelRegistry as JModelRegistry
from repro_torch.ir import ForestIR
from repro_torch.ir import artifact as art
from repro_torch.ir.artifact import (
    FLAG_FLOAT,
    FLAG_PACKED_LEAVES,
    FLAG_TUNED,
    ITRF_VERSION,
    inspect_itrf,
    read_itrf,
    read_itrf_bytes,
    tune_host_key,
    update_tuned,
)
from repro_torch.ir.packed_leaf import (
    pack_groups,
    pack_leaf_payload,
    unpack_groups,
    unpack_leaf_payload,
)
from repro_torch.serve import Gateway, ModelRegistry, TreeEngine

ROOT = Path(__file__).resolve().parents[1]
IR_ARRAYS = ("feature", "threshold", "threshold_key", "left", "right",
             "leaf_probs", "leaf_fixed", "node_offsets", "tree_depths")
WRITER_OPTIONS = {
    "full": {},
    "stripped": {"include_float": False},
    "packed": {"pack_leaves": True},
    "stripped+packed": {"include_float": False, "pack_leaves": True},
}
#: every (backend, layout) route the port serves, on the CPU
ROUTES = ("integer:reference@padded", "integer:reference@leaf_major",
          "integer:reference@packed_leaf", "flint:reference@packed_leaf",
          "integer:cuda@padded", "integer:cuda@leaf_major",
          "integer:cuda@padded?impl=onehot", "flint:cuda@leaf_major",
          "integer:bitvector@bitvector", "flint:bitvector@bitvector")
#: the JAX route of each port route: ``cuda`` is ``pallas`` there
J_ROUTE = lambda route: route.replace(":cuda", ":pallas")


def _assert_ir_equal(a, b, *, msg=""):
    for name in IR_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, f"{msg}{name} dtype {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg}{name}")
    assert (a.n_trees, a.n_classes, a.n_features, a.quant_scale) == \
           (b.n_trees, b.n_classes, b.n_features, b.quant_scale)


def _scores(eng, rows):
    s, p = eng.predict_scores(rows)
    return np.asarray(s), np.asarray(p)


def _assert_same(got, want, label):
    assert got[0].dtype == want[0].dtype, label
    np.testing.assert_array_equal(got[0], want[0], err_msg=label)
    np.testing.assert_array_equal(got[1], want[1], err_msg=label)


@pytest.fixture(scope="module")
def trained_ir(small_forest):
    return ForestIR.from_forest(small_forest)


@pytest.fixture(scope="module")
def jax_ir(small_forest):
    return JForestIR.from_forest(small_forest)


@pytest.fixture(scope="module")
def rows(shuttle_small):
    return shuttle_small[2][:37]


# ------------------------------------------------------------- round trips

@pytest.mark.parametrize("mmap_arrays", [True, False], ids=["mmap", "eager"])
@pytest.mark.parametrize("option", sorted(WRITER_OPTIONS))
def test_round_trip_trained(trained_ir, jax_ir, tmp_path, option, mmap_arrays):
    """Every writer option round-trips, and the file is the JAX writer's
    byte for byte."""
    kwargs = WRITER_OPTIONS[option]
    path, jpath = tmp_path / "m.itrf", tmp_path / "j.itrf"
    info = trained_ir.to_itrf(str(path), **kwargs)
    jax_ir.to_itrf(str(jpath), **kwargs)
    assert path.read_bytes() == jpath.read_bytes()
    assert info["file_bytes"] == os.path.getsize(path)
    out = ForestIR.from_itrf(str(path), mmap=mmap_arrays)
    if kwargs.get("include_float", True):
        _assert_ir_equal(trained_ir, out)
    else:
        for name in IR_ARRAYS:
            if name in ("threshold", "leaf_probs"):
                assert not np.asarray(getattr(out, name)).any()
            else:
                np.testing.assert_array_equal(getattr(trained_ir, name),
                                              getattr(out, name), err_msg=name)
    assert out.itrf_version == ITRF_VERSION
    assert bool(out.itrf_flags & FLAG_PACKED_LEAVES) == bool(kwargs.get("pack_leaves"))
    assert out.itrf_source == str(path) and out.itrf_tuned == {}
    assert out.itrf_bytes.nbytes == os.path.getsize(path)


@pytest.mark.parametrize("case", sorted(DEGENERATE_FORESTS))
@pytest.mark.parametrize("pack_leaves", [False, True], ids=["raw", "packed"])
def test_round_trip_degenerate(case, pack_leaves, tmp_path):
    forest = DEGENERATE_FORESTS[case]()
    ir = ForestIR.from_forest(forest)
    path, jpath = tmp_path / f"{case}.itrf", tmp_path / f"{case}.j.itrf"
    ir.to_itrf(str(path), pack_leaves=pack_leaves)
    JForestIR.from_forest(forest).to_itrf(str(jpath), pack_leaves=pack_leaves)
    assert path.read_bytes() == jpath.read_bytes()
    _assert_ir_equal(ir, ForestIR.from_itrf(str(path)), msg=f"{case}: ")


def test_round_trip_multiword_bitvector_chain(tmp_path):
    """A depth-70 chain has over 64 leaves a tree, so the bitvector tables
    need several mask words; the reloaded artifact serves the QuickScorer
    route bit-identically to the JAX engine."""
    forest = forest_from_trees([chain_tree(70, 3)], 3, 4)
    ir = ForestIR.from_forest(forest)
    path = tmp_path / "chain.itrf"
    ir.to_itrf(str(path), pack_leaves=True)
    out = ForestIR.from_itrf(str(path))
    _assert_ir_equal(ir, out)
    assert out.materialize("bitvector").words > 1
    x = np.random.default_rng(5).normal(0, 40, (33, 4)).astype(np.float32)
    want = _scores(JTreeEngine(JForestIR.from_forest(forest), "integer"), x)
    for spec in ("integer:bitvector", "integer:reference", "integer:cuda"):
        _assert_same(_scores(TreeEngine(out, spec, device="cpu"), x), want, spec)


def test_round_trip_single_stump(tmp_path):
    ir = ForestIR.from_forest(forest_from_trees(
        [DEGENERATE_FORESTS["stumps"]().trees_[0]], 3, 4))
    path = tmp_path / "stump.itrf"
    ir.to_itrf(str(path), pack_leaves=True)
    _assert_ir_equal(ir, ForestIR.from_itrf(str(path)))


def test_inspect_reports_header_and_sections(trained_ir, tmp_path):
    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path), pack_leaves=True)
    info = inspect_itrf(str(path))
    assert tuple(info["version"]) == ITRF_VERSION
    assert info["n_trees"] == trained_ir.n_trees
    assert info["total_nodes"] == trained_ir.total_nodes
    assert set(info["sections"]) >= {"feature", "threshold_key", "left", "right",
                                     "node_offsets", "tree_depths",
                                     "leaf_pack_data", "meta"}
    for ent in info["sections"].values():
        assert ent["offset"] % 64 == 0
    assert info == jart.inspect_itrf(str(path))


# --------------------------------------------------------- format gating

def _patch_header(path, **over):
    raw = bytearray(path.read_bytes())
    fields = list(art._HEADER.unpack_from(raw))
    names = ["magic", "vmaj", "vmin", "flags", "n_trees", "n_classes",
             "n_features", "total_nodes", "quant_scale", "n_sections"]
    for k, v in over.items():
        fields[names.index(k)] = v
    raw[:art._HEADER.size] = art._HEADER.pack(*fields)
    path.write_bytes(bytes(raw))


def test_refuses_newer_major_version(trained_ir, tmp_path):
    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path))
    _patch_header(path, vmaj=ITRF_VERSION[0] + 1)
    with pytest.raises(ValueError, match="format version"):
        read_itrf(str(path))
    with pytest.raises(ValueError, match="format version"):
        inspect_itrf(str(path))
    _patch_header(path, vmaj=ITRF_VERSION[0], vmin=ITRF_VERSION[1] + 7)
    out = read_itrf(str(path))
    _assert_ir_equal(trained_ir, out)
    assert out.itrf_version == (ITRF_VERSION[0], ITRF_VERSION[1] + 7)


def test_refuses_bad_magic_and_truncation(trained_ir, tmp_path):
    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path))
    _patch_header(path, magic=b"NOPE")
    with pytest.raises(ValueError, match="magic"):
        read_itrf(str(path))
    with pytest.raises(ValueError, match="not an ITRF"):
        read_itrf_bytes(b"IT")


def test_missing_sections_are_refused(trained_ir, tmp_path):
    """A file without a required node section, or without any leaf
    payload, is refused, never half-parsed."""
    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path))
    buf = path.read_bytes()
    head = art._parse_header(buf)
    table = art._parse_sections(buf, head["n_sections"])
    fields = (*head["version"], head["flags"], head["n_trees"], head["n_classes"],
              head["n_features"], head["total_nodes"], int(head["quant_scale"] or 0))
    for drop, match in (("left", "missing required"), ("leaf_fixed", "neither")):
        sections = [(n, art._section_array(buf, e, copy=False))
                    for n, e in table.items() if n != drop]
        art._write_raw(str(path), fields, sections)
        with pytest.raises(ValueError, match=match):
            read_itrf(str(path))


def test_unknown_sections_are_skipped(trained_ir, tmp_path):
    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path))
    ir = read_itrf(str(path), mmap_arrays=False)
    buf = path.read_bytes()
    head = art._parse_header(buf)
    table = art._parse_sections(buf, head["n_sections"])
    sections = [(n, art._section_array(buf, e, copy=False)) for n, e in table.items()]
    sections.append(("future_thing", np.arange(9, dtype=np.uint8)))
    art._write_raw(str(path), (*head["version"], head["flags"], head["n_trees"],
                               head["n_classes"], head["n_features"],
                               head["total_nodes"], int(head["quant_scale"] or 0)),
                   sections)
    _assert_ir_equal(ir, read_itrf(str(path)))
    _assert_ir_equal(ir, jart.read_itrf(str(path)))


# ------------------------------------------------------- mmap safety

def test_mmap_views_are_read_only_and_file_unchanged(trained_ir, jax_ir, tmp_path, rows):
    """The mapped canon is read-only; every route the port serves runs from
    it on the CPU, equal to the JAX engine, and leaves the file as it was;
    the eager load gives private writable copies."""
    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path))
    before = path.read_bytes()
    ir = ForestIR.from_itrf(str(path), mmap=True)
    for name in IR_ARRAYS:
        a = getattr(ir, name)
        assert not a.flags.writeable, f"{name} must be a read-only view"
        with pytest.raises((ValueError, RuntimeError)):
            a[...] = 0
    for route in ROUTES:
        _assert_same(_scores(TreeEngine(ir, route, device="cpu"), rows),
                     _scores(JTreeEngine(jax_ir, J_ROUTE(route)), rows), route)
    assert path.read_bytes() == before
    eager = ForestIR.from_itrf(str(path), mmap=False)
    assert eager.feature.flags.writeable
    eager.feature[0] = -1  # must not raise


@pytest.mark.parametrize("layout", ["padded", "leaf_major", "ragged", "bitvector",
                                    "packed_leaf"])
def test_no_layout_table_aliases_the_mapping(trained_ir, tmp_path, layout):
    """Backends turn a layout's arrays into tensors (``torch.from_numpy``,
    which on the CPU keeps the memory): so no array a backend reads may
    share memory with the mapping.  ``packed_leaf`` keeps the node arrays
    as views (its own artifact is read-only) and serves the tables its
    payload decodes to, which are fresh."""
    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path), pack_leaves=True)
    ir = ForestIR.from_itrf(str(path), mmap=True)
    mapping = ir.itrf_bytes
    art_ = ir.materialize(layout)
    walked = art_.decoded_tables() if layout == "packed_leaf" else art_
    arrays = {k: v for k, v in vars(walked).items() if isinstance(v, np.ndarray)}
    assert arrays
    for name, a in arrays.items():
        assert not np.shares_memory(a, mapping), f"{layout}.{name} aliases the file"


# ------------------------------------------------- packed-leaf codec edges

@pytest.mark.parametrize("group", [64, 7])
def test_pack_groups_round_trip_edges(group):
    for values in (
        np.zeros(0, np.uint32),
        np.zeros(64, np.uint32),
        np.full(7, 2**32 - 1, np.uint32),
        np.arange(200, dtype=np.uint32),
        np.array([0, 2**32 - 1] * 65, np.uint32),
    ):
        base, bits, payload = pack_groups(values, group)
        for got, want in zip((base, bits, payload), jpl.pack_groups(values, group)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        out = unpack_groups(base, bits, payload, len(values), group)
        np.testing.assert_array_equal(out, values)
        assert out.dtype == np.uint32


def test_pack_leaf_payload_picks_dictionary_for_near_one_hot():
    rng = np.random.default_rng(0)
    scale = (2**32 - 1) // 16
    values = rng.choice(np.array([0, scale // 2, scale], np.uint32), 4096).astype(np.uint32)
    dictionary, base, bits, payload = pack_leaf_payload(values, 64)
    assert dictionary.size == 3
    np.testing.assert_array_equal(payload, jpl.pack_leaf_payload(values, 64)[3])
    out = unpack_leaf_payload(dictionary, base, bits, payload, len(values), 64)
    np.testing.assert_array_equal(out, values)


def test_pack_leaf_payload_falls_back_to_raw_for_high_entropy():
    rng = np.random.default_rng(1)
    values = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    dictionary, base, bits, payload = pack_leaf_payload(values, 64)
    assert dictionary.size == 0
    np.testing.assert_array_equal(payload, jpl.pack_leaf_payload(values, 64)[3])
    out = unpack_leaf_payload(dictionary, base, bits, payload, len(values), 64)
    np.testing.assert_array_equal(out, values)


def test_packed_leaf_layout_registered_and_smaller(trained_ir, jax_ir):
    sizes = trained_ir.nbytes_by_layout(mode="integer")
    assert "packed_leaf" in sizes
    assert sizes["packed_leaf"] < sizes["padded"]
    assert sizes == jax_ir.nbytes_by_layout(mode="integer")
    assert trained_ir.nbytes_by_layout("float") == jax_ir.nbytes_by_layout("float")


def test_packed_leaf_decodes_without_the_ir(trained_ir):
    """``decoded_tables`` rebuilds the tables from the payload alone: with
    the back-reference gone and the leaves' source zeroed, it still gives
    the padded tables of the IR."""
    import dataclasses

    packed = trained_ir.materialize("packed_leaf")
    orphan = dataclasses.replace(packed, ir=None, _tables=None)
    tables = orphan.decoded_tables()
    want = trained_ir.materialize("padded")
    for name in ("feature", "threshold_key", "left", "right", "leaf_fixed"):
        np.testing.assert_array_equal(getattr(tables, name), getattr(want, name))
    assert orphan.decoded_tables() is tables  # memoized


def test_packed_leaf_rejects_float_mode(trained_ir, rows):
    from repro_torch.backends import create_backend

    art_ = trained_ir.materialize("packed_leaf")
    with pytest.raises(ValueError, match="deterministic"):
        create_backend("reference", art_, mode="float", device="cpu")
    with pytest.raises(ValueError, match="deterministic"):
        TreeEngine(trained_ir, "float:reference@packed_leaf", device="cpu")
    for backend in ("cuda", "bitvector"):  # only the reference walk serves it
        with pytest.raises(ValueError, match="layout"):
            TreeEngine(trained_ir, f"integer:{backend}@packed_leaf", device="cpu")


# ----------------------------------------------------- registry integration

@pytest.fixture()
def artifact_path(trained_ir, tmp_path):
    path = tmp_path / "reg.itrf"
    trained_ir.to_itrf(str(path))
    return str(path)


def test_register_artifact_serves_identically_to_json(small_forest, artifact_path, rows):
    from repro_torch.trees.io import forest_to_json

    reg = ModelRegistry()
    mv_j = reg.register_json("j", forest_to_json(small_forest))
    mv_a = reg.register_artifact("a", artifact_path)
    assert mv_a.source == "artifact"
    for spec in ("flint:reference", "integer:reference", "integer:cuda",
                 "integer:bitvector", "integer:reference@packed_leaf"):
        _assert_same(_scores(mv_a.engine(spec, device="cpu"), rows),
                     _scores(mv_j.engine(spec, device="cpu"), rows), spec)
    want = JModelRegistry().register_artifact("a", artifact_path).engine("integer")
    _assert_same(_scores(mv_a.engine("integer:cuda", device="cpu"), rows),
                 _scores(want, rows), "JAX registry")


def test_register_artifact_load_ms_lands_in_engine_ledger(artifact_path):
    mv = ModelRegistry().register_artifact("m", artifact_path)
    eng = mv.engine("integer:reference", device="cpu")
    assert eng.drain_compile_timings()["load"] > 0.0
    assert "load" not in mv.engine("flint:reference", device="cpu").drain_compile_timings()


def test_hot_swap_reuses_mapped_artifact(artifact_path):
    reg = ModelRegistry()
    mv1 = reg.register_artifact("m", artifact_path)
    mv2 = reg.register_artifact("m", artifact_path)
    assert mv2.version == mv1.version + 1
    assert mv2.packed is mv1.packed
    os.utime(artifact_path, ns=(1, 1))
    mv3 = reg.register_artifact("m", artifact_path)
    assert mv3.packed is not mv1.packed
    mv4 = reg.register_artifact("m", artifact_path, mmap=False)  # eager: no cache
    assert mv4.packed is not mv3.packed and mv4.packed.feature.flags.writeable


def test_retention_releases_swapped_out_versions(artifact_path):
    reg = ModelRegistry(retain=2)
    mv1 = reg.register_artifact("m", artifact_path)
    eng1 = mv1.engine("integer:reference", device="cpu")
    ref = weakref.ref(eng1)
    mv2 = reg.register_artifact("m", artifact_path)
    assert not mv1.released
    mv3 = reg.register_artifact("m", artifact_path)
    assert mv1.released and eng1.closed
    assert not mv2.released
    with pytest.raises(RuntimeError, match="released"):
        mv1.engine("integer:reference", device="cpu")
    del eng1, mv1
    gc.collect()
    assert ref() is None, "released engine still referenced"
    reg.release("m", mv2.version)
    assert mv2.released
    with pytest.raises(ValueError, match="current"):
        reg.release("m", mv3.version)
    with pytest.raises(KeyError):
        reg.release("m", mv2.version)
    assert reg.get("m") is mv3


def test_registry_retain_validation():
    with pytest.raises(ValueError, match="retain"):
        ModelRegistry(retain=0)


def test_gateway_prunes_closed_engines(artifact_path, rows):
    reg = ModelRegistry(retain=1)
    gw = Gateway(reg, "integer:cuda", max_delay_ms=0.5, device="cpu")
    reg.register_artifact("m", artifact_path)
    asyncio.run(gw.submit("m", rows[:8]))
    assert len(gw._engines) == 1
    reg.register_artifact("m", artifact_path)
    asyncio.run(gw.submit("m", rows[:8]))
    assert all(not e.closed for e in gw._engines.values())
    assert len(gw._engines) == 1
    asyncio.run(gw.close())


# --------------------------------------------------------- tune-db sidecar

CPU_WINNER = {("cuda", "leaf_major", "integer", (), "cpu"): {"block_b": 64, "block_t": 2}}


def test_tune_host_keys_name_the_device(monkeypatch):
    """The port's host keys start with ``torch-`` (no ISA key does) and name
    the device; a card this host lacks has no key, and its winners are not
    written."""
    import torch

    assert tune_host_key("cpu") == f"torch-cpu:{art.host_isa_key()}"
    assert not jart.host_isa_key().startswith(art.PORT_HOST_PREFIX)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tune_host_key("cuda") is None
    winners = {**CPU_WINNER, ("cuda", "leaf_major", "integer", (), "cuda"): {"block_b": 8}}
    assert art.serialize_tuned(winners) == {
        tune_host_key("cpu"): {"cuda|leaf_major|integer|cpu|[]":
                               {"block_b": 64, "block_t": 2}}}
    kw_key = ("cuda", "padded", "flint", (("impl", "onehot"),), "cpu")
    db = art.serialize_tuned({kw_key: {"block_b": 32}})
    assert art.deserialize_tuned(db) == {kw_key: {"block_b": 32}}


def test_tune_db_persists_and_foreign_hosts_ignore(trained_ir, tmp_path):
    path = tmp_path / "tuned.itrf"
    trained_ir.to_itrf(str(path), tuned=CPU_WINNER)
    info = inspect_itrf(str(path))
    assert info["flags"] & FLAG_TUNED
    assert info["tuned_hosts"] == [tune_host_key("cpu")]
    mv = ModelRegistry().register_artifact("m", str(path))
    assert mv._tuned == CPU_WINNER
    # foreign hosts' entries, planted through the JAX package's writer
    other = {("bitvector", "bitvector", "flint"): {"block_b": 32}}
    jart.update_tuned(str(path), other, host_key="torch-cuda:Some Other Card")
    jart.update_tuned(str(path), other, host_key="riscv64+vext")
    assert sorted(inspect_itrf(str(path))["tuned_hosts"]) == sorted(
        [tune_host_key("cpu"), "torch-cuda:Some Other Card", "riscv64+vext"])
    mv2 = ModelRegistry().register_artifact("m", str(path))
    assert mv2._tuned == CPU_WINNER


def test_export_tuned_round_trips_through_registry(trained_ir, artifact_path, rows):
    """A route autotuned on the CPU exports its winner; a fresh registry
    mapping the file serves that route on it without measuring again."""
    reg = ModelRegistry()
    mv = reg.register_artifact("m", artifact_path)
    eng = mv.engine("integer:cuda?autotune=true", device="cpu")
    eng.warm(64)
    assert eng.tuned_config is not None and len(mv._tuned) == 1
    reg.export_tuned("m", artifact_path)
    mv2 = ModelRegistry().register_artifact("m", artifact_path)
    assert mv2._tuned == mv._tuned
    eng2 = mv2.engine("integer:cuda?autotune=true", device="cpu")
    eng2.warm(64)
    assert eng2.tuned_config == eng.tuned_config
    assert "tune" not in eng2.drain_compile_timings()
    _assert_same(_scores(eng2, rows), _scores(eng, rows), "tuned")


def test_port_tunes_register_in_the_jax_registry(trained_ir, artifact_path, rows):
    """An artifact carrying the port's tunes registers and serves in the JAX
    registry, which never reads (or splits) the port's entries."""
    update_tuned(artifact_path, CPU_WINNER)
    jmv = JModelRegistry().register_artifact("m", artifact_path)
    assert jmv._tuned == {}
    _assert_same(_scores(jmv.engine("integer"), rows),
                 _scores(ModelRegistry().register_artifact("m", artifact_path)
                         .engine("integer:reference", device="cpu"), rows), "jax")


def test_jax_tunes_are_ignored_by_the_port(jax_ir, tmp_path, rows):
    path = tmp_path / "j.itrf"
    jwin = {("native_c_table", None, "integer"): {"block_rows": 8}}
    jax_ir.to_itrf(str(path), tuned=jwin)
    assert inspect_itrf(str(path))["tuned_hosts"] == [jart.host_isa_key()]
    mv = ModelRegistry().register_artifact("m", str(path))
    assert mv._tuned == {}
    _assert_same(_scores(mv.engine("integer:cuda", device="cpu"), rows),
                 _scores(JTreeEngine(jax_ir, "integer"), rows), "port")


def test_tunes_survive_round_trips_through_the_other_package(jax_ir, tmp_path):
    """Each package rewrites the tune_db carrying the other's entries
    verbatim: both sets of winners read back after either order of
    writers."""
    jwin = {("native_c_bitvector", None, "integer"): {"interleave": 8}}
    first = tmp_path / "jax_first.itrf"
    jax_ir.to_itrf(str(first), tuned=jwin)
    update_tuned(str(first), CPU_WINNER)
    second = tmp_path / "port_first.itrf"
    jax_ir.to_itrf(str(second))
    update_tuned(str(second), CPU_WINNER)
    jart.update_tuned(str(second), jwin)
    for path in (first, second):
        assert ModelRegistry().register_artifact("m", str(path))._tuned == CPU_WINNER
        assert JModelRegistry().register_artifact("m", str(path))._tuned == jwin


# ------------------------------------------------- worker HELLO fast path

def test_worker_session_decodes_itrf_hello(trained_ir, tmp_path, rows):
    """A HELLO whose payload is one raw ITRF image rebuilds the forest and
    serves the JAX reference's shard partials on the worker's device."""
    from repro.backends import create_backend as jcreate_backend
    from repro_torch.serve import wire
    from repro_torch.serve.worker import _Session

    path = tmp_path / "w.itrf"
    trained_ir.to_itrf(str(path), include_float=False)
    ir = ForestIR.from_itrf(str(path))
    half = ir.n_trees // 2
    meta = {"artifact_format": "itrf", "mode": "integer", "model_id": "m",
            "version": 1,
            "shards": [{"shard": 0, "start": 0, "stop": half, "backend": "cuda"},
                       {"shard": 1, "start": half, "stop": ir.n_trees,
                        "backend": "bitvector"}]}
    session = _Session(wire.encode_hello(meta, {"itrf": ir.itrf_bytes}), "cpu")
    _assert_ir_equal(ir, session.ir)
    jref = jart.read_itrf(str(path))
    merged = 0
    for shard, (a, b) in enumerate(((0, half), (half, ir.n_trees))):
        backend, built = session.backend(shard)
        assert built and backend.device.type == "cpu"
        assert session.backend(shard) == (backend, False)
        want = jcreate_backend("reference", jref.subset(a, b).materialize("padded"),
                               mode="integer").predict_partials(rows)
        got = backend.predict_partials(rows)
        np.testing.assert_array_equal(got, np.asarray(want))
        merged = merged + got.astype(np.uint64)
    full = jcreate_backend("reference", jref.materialize("padded"), mode="integer")
    np.testing.assert_array_equal((merged % 2**32).astype(np.uint32),
                                  np.asarray(full.predict_partials(rows)))
    with pytest.raises(KeyError, match="shard table"):
        session.backend(7)


def test_remote_plan_prefers_artifact_bytes_when_smaller(trained_ir, tmp_path):
    stripped, full = tmp_path / "s.itrf", tmp_path / "f.itrf"
    trained_ir.to_itrf(str(stripped), include_float=False)
    trained_ir.to_itrf(str(full), include_float=True)
    wire_arrays_nbytes = sum(
        getattr(trained_ir, n).nbytes
        for n in ("feature", "threshold", "threshold_key", "left", "right",
                  "leaf_fixed", "node_offsets", "tree_depths"))
    assert ForestIR.from_itrf(str(stripped)).itrf_bytes.nbytes <= wire_arrays_nbytes
    assert ForestIR.from_itrf(str(full)).itrf_bytes.nbytes > wire_arrays_nbytes


# ------------------------------------------------------------ converter CLI

def test_convert_cli_and_inspect(small_forest, tmp_path, capsys):
    from repro.trees.convert import main as jmain
    from repro_torch.trees.convert import main
    from repro_torch.trees.io import forest_to_json

    src, dst, jdst = tmp_path / "model.json", tmp_path / "model.itrf", tmp_path / "j.itrf"
    src.write_text(forest_to_json(small_forest))
    assert main([str(src), str(dst), "--strip-float", "--pack-leaves"]) == 0
    out = capsys.readouterr().out
    assert "packed_leaf=" in out and "bitvector=" in out
    assert jmain([str(src), str(jdst), "--strip-float", "--pack-leaves"]) == 0
    jout = capsys.readouterr().out
    assert out.splitlines()[1] == jout.splitlines()[1]  # the layout bytes line
    assert dst.read_bytes() == jdst.read_bytes()
    ir = ForestIR.from_itrf(str(dst))
    assert ir.itrf_flags & FLAG_PACKED_LEAVES
    assert not ir.itrf_flags & FLAG_FLOAT
    ref = ForestIR.from_forest(small_forest)
    for name in ("feature", "threshold_key", "left", "right", "leaf_fixed",
                 "node_offsets", "tree_depths"):
        np.testing.assert_array_equal(getattr(ref, name), getattr(ir, name), err_msg=name)
    assert main(["--inspect", str(dst)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["n_trees"] == small_forest.n_estimators


def test_convert_cli_requires_paths(capsys):
    from repro_torch.trees.convert import main

    with pytest.raises(SystemExit):
        main([])


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, env=env)


def test_convert_selftest_reloads_in_a_fresh_process(tmp_path):
    out = _run(["repro_torch.trees.convert", "--selftest", str(tmp_path / "demo.itrf"),
                "--device", "cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SELFTEST OK" in out.stdout


def test_verify_scores_on_the_card_unless_asked(trained_ir, tmp_path, monkeypatch, capsys):
    """``--verify`` takes the CPU only when asked: without a card and
    without ``--device cpu`` it raises instead of carrying on."""
    import torch

    from repro_torch.trees.convert import main

    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--verify", str(path)])
    assert main(["--verify", str(path), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("PARTIALS_SHA256 ")


# ------------------------------------------------------- byte compatibility

@pytest.mark.parametrize("option", ["full", "stripped", "packed"])
def test_jax_written_artifact_loads_in_the_port(jax_ir, tmp_path, rows, option):
    path = tmp_path / "j.itrf"
    jax_ir.to_itrf(str(path), **WRITER_OPTIONS[option])
    want = jart.read_itrf(str(path))
    got = ForestIR.from_itrf(str(path))
    _assert_ir_equal(got, want)
    assert (got.itrf_version, got.itrf_flags) == (want.itrf_version, want.itrf_flags)
    for route in ("integer:cuda@leaf_major", "flint:bitvector",
                  "integer:reference@packed_leaf"):
        _assert_same(_scores(TreeEngine(got, route, device="cpu"), rows),
                     _scores(JTreeEngine(want, J_ROUTE(route)), rows), route)


@pytest.mark.parametrize("option", ["full", "stripped", "packed"])
def test_port_written_artifact_loads_in_jax(trained_ir, tmp_path, rows, option):
    path = tmp_path / "p.itrf"
    trained_ir.to_itrf(str(path), **WRITER_OPTIONS[option])
    want = ForestIR.from_itrf(str(path))
    got = jart.read_itrf(str(path))
    _assert_ir_equal(got, want)
    for route in ("integer:cuda@leaf_major", "flint:bitvector",
                  "integer:reference@packed_leaf"):
        _assert_same(_scores(JTreeEngine(got, J_ROUTE(route)), rows),
                     _scores(TreeEngine(want, route, device="cpu"), rows), route)


def test_verify_digests_equal_across_packages(trained_ir, tmp_path):
    """The JAX and port ``--verify`` print one digest for one file, each
    in a fresh interpreter, and it is the in-process digest."""
    from repro_torch.trees.convert import _partials_digest

    path = tmp_path / "m.itrf"
    trained_ir.to_itrf(str(path), include_float=False, pack_leaves=True)
    port = _run(["repro_torch.trees.convert", "--verify", str(path), "--device", "cpu"])
    jax = _run(["repro.trees.convert", "--verify", str(path)])
    assert port.returncode == 0 and jax.returncode == 0, port.stderr + jax.stderr
    line = f"PARTIALS_SHA256 {_partials_digest(trained_ir, device='cpu')}"
    assert port.stdout.strip() == jax.stdout.strip() == line
