"""CPU tests of the benchmark's pieces: the reference against the port's
``integer:reference`` route, the ``rf`` family's forests and answers pinned,
the work counts, the catalog, the traffic generator and the metric readers on
a small recorded trace."""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import catalog, devtrace, stats, work
from portbench.forest import ROWS_STREAM, make_forest, rng_for
from portbench.reference import Reference
from portbench.traffic import Traffic, check_mix

ROOT = Path(__file__).resolve().parents[1]
CFGS = {name: json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
        for name in ("intreeger-rf", "covtype-rf500")}
SMALL = [dict(n_trees=6, depth=4, n_features=9, n_classes=7, threshold_sample_rows=256),
         dict(n_trees=3, depth=6, n_features=5, n_classes=8, threshold_sample_rows=512),
         dict(n_trees=1, depth=3, n_features=4, n_classes=2, threshold_sample_rows=64)]


def port_scores(forest, x):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.ir import ForestIR
    from repro_torch.serve import TreeEngine

    from portbench.system import program_forest

    engine = TreeEngine(ForestIR.from_forest(program_forest(forest)),
                        spec="integer:reference", device="cpu")
    return engine.predict_scores(x)


@pytest.mark.parametrize("cfg", SMALL)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_reference_bit_for_bit_with_the_port(cfg, seed):
    forest = make_forest(cfg, seed)
    x = np.random.default_rng(seed).standard_normal((700, cfg["n_features"]), dtype=np.float32)
    x[:5] = forest.threshold[0, 0]  # rows on a threshold take the left branch on both sides
    x[5:10] = -0.0
    want_s, want_p = port_scores(forest, x)
    got_s, got_p = Reference(forest, "cpu").scores(x, block_rows=256)
    assert got_s.dtype == np.uint32 and np.array_equal(got_s, want_s)
    assert np.array_equal(got_p, want_p)


def test_control_in_bfloat16_fails_the_comparison():
    cfg = SMALL[0]
    forest = make_forest(cfg, 11)
    x = np.random.default_rng(11).standard_normal((2000, cfg["n_features"]), dtype=np.float32)
    ref_s, _ = Reference(forest, "cpu").scores(x)
    ctl_s, _ = Reference(forest, "cpu", rows_dtype=torch.bfloat16).scores(x)
    assert np.count_nonzero(np.any(ref_s != ctl_s, axis=1)) > 0


def test_reference_imports_nothing_of_the_program_or_jax():
    probe = ("import sys; sys.path.insert(0, sys.argv[1]); import portbench.reference, "
             "portbench.check, portbench.forest, portbench.traffic, portbench.work; "
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# the forests' arrays and the reference's answers on the first 4,096 ring rows,
# as the benchmark drew and computed them before configurations had families
PINNED = {
    ("intreeger-rf", 0): ("74fd856d10ccc2727e1353ce4332b00976b6d4149d1c0b61cd00ed839df82c06",
                          "90a530032208ede3a007528358f79a95a08ff309b19dbd3a64c1709004cabd29"),
    ("intreeger-rf", 1): ("985893ed558fc32bd4e46b6abc4c6ec3d4a225e99cf70808ae724afbc0818cc4",
                          "b889f3b3e28f8c979bf8908971b6b58973d546ba3df35f74b1185ad41d6f0cc8"),
    ("intreeger-rf", 2): ("307086c519fdeb296e982cb4fa98ff5ff991c174d555f5acc20f60b049944fc4",
                          "a6cd3721bd6020e6b2f3c5fcb25e9e9a517dacf9ecc0af0798d418ffe71dafec"),
    ("covtype-rf500", 0): ("9df38d8ed5b994d785af453e0e2e45ce6f1819d9d8bf18fdd53165c5a0a69b80",
                           "65a27e09265f4ca4ab3bf1093301c1ded084668aa9ce0610faa06358d919884f"),
    ("covtype-rf500", 1): ("88d760ecffb4cc24fe3dc263f8af6632943fad6ad67f43bc10b258dee4692dd8",
                           "0d1d640ba82ffacc6891d78a01425b75aefa48e343eb455c0c9e901d578b9f49"),
    ("covtype-rf500", 2): ("3b9ab192f117ad18a8f8eb9463d374fbb5cb250f2d8fe69de126d45e9fd6337c",
                           "6a471c2cfed54be444c5c66dae506e85747977ddc00fd388571553c2a3e7f5dd"),
}


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_the_rf_family_draws_and_answers_as_before(name, seed):
    cfg = CFGS[name]
    fam = catalog.family(cfg)
    assert "family" not in cfg
    assert (fam.make_forest, fam.Reference) == (make_forest, Reference)
    assert (fam.batch_bytes, fam.batch_ops, fam.bound_s) == (work.batch_bytes, work.batch_ops,
                                                             work.bound_s)
    forest = fam.make_forest(cfg, seed)
    x = rng_for(seed, ROWS_STREAM).standard_normal((4096, cfg["n_features"]), dtype=np.float32)
    scores, preds = fam.Reference(forest, "cpu").scores(x)
    got = (digest(forest.feature, forest.threshold, forest.left, forest.right, forest.leaf_probs),
           digest(scores, preds))
    assert got == PINNED[(name, seed)]


def test_work_counts_pinned_for_65536_rows():
    rf, cov = CFGS["intreeger-rf"], CFGS["covtype-rf500"]
    assert work.batch_bytes(rf, 65536) == 31_193_088
    assert work.batch_ops(rf, 65536) == 318_767_104
    assert work.batch_bytes(cov, 65536) == 21_614_784
    assert work.batch_ops(cov, 65536) == 1_015_808_000
    s, by = work.bound_s(rf, 65536)
    assert by == "bytes" and s == pytest.approx(9.311e-6, rel=1e-3)
    s, by = work.bound_s(cov, 65536)
    assert by == "operations" and s == pytest.approx(15.161e-6, rel=1e-3)


def test_every_cell_of_the_benchmark_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = catalog.load_cell(w["name"])
        check_mix(cell.mix)
        catalog.driver(cell.mix)
        for m in cell.end_to_end + cell.per_layer:
            if m["name"] != "setup_s":
                assert hasattr(catalog.reader(m["name"]), "read")
        names = {m["name"] for m in cell.end_to_end}
        assert {"rows_per_s", "setup_s"} <= names
        assert all(m["moves"] in names for m in cell.per_layer)


@pytest.mark.parametrize("what", ["workload", "traffic", "reader", "driver", "mix key",
                                  "family"])
def test_an_unknown_name_fails_loudly(what, tmp_path):
    if what == "family":  # a configuration file that names a family with no module
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        for c in bench["configs"]:
            c["file"] = f"configs/{c['name']}.json"
            cfg = dict(CFGS[c["name"]], family="no_such_family")
            (tmp_path / "configs").mkdir(exist_ok=True)
            (tmp_path / c["file"]).write_text(json.dumps(cfg))
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        (tmp_path / "portbench").symlink_to(ROOT / "portbench")
        with pytest.raises(catalog.UnknownName, match="no_such_family"):
            catalog.load_cell(bench["workloads"][0]["name"], root=tmp_path)
        with pytest.raises(catalog.UnknownName):
            catalog.family({"family": "no_such_family"})
    elif what == "mix key":  # a client model that no driver implements
        mix = json.loads((ROOT / "portbench" / "traffic" / "gateway.c32.json").read_text())
        catalog.driver(mix)
        with pytest.raises(catalog.UnknownName, match="loop"):
            catalog.driver(dict(mix, loop="open"))
    elif what == "workload":
        with pytest.raises(catalog.UnknownName):
            catalog.load_cell("no-such.cell")
    elif what == "reader":
        with pytest.raises(catalog.UnknownName):
            catalog.reader("no_such_metric")
    elif what == "driver":
        with pytest.raises(catalog.UnknownName):
            catalog.driver({"driver": "no_such_driver"})
    else:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        bench["workloads"].append({"name": "x.y", "config": "intreeger-rf",
                                   "traffic": "no_such_mix", "chips": 1, "why": "x"})
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        (tmp_path / "portbench").symlink_to(ROOT / "portbench")
        with pytest.raises(catalog.UnknownName):
            catalog.load_cell("x.y", root=tmp_path)


def test_the_run_refuses_an_unknown_cell():
    from portbench import run

    assert run.main(["--workload", "no-such.cell", "--seed", "1", "--seconds", "1"]) == 2


def draw(mix, n_requests, seed=7):
    tr = Traffic(mix, 2, seed)
    return tr, [tr.next() for _ in range(n_requests)]


def test_traffic_keeps_its_size_and_repeat_shares():
    mix = json.loads((ROOT / "portbench" / "traffic" / "gateway.c32.json").read_text())
    _, reqs = draw(mix, 20000)
    sizes = Counter(r.n for r in reqs)
    for n, share in zip(mix["sizes"], mix["shares"]):
        assert sizes[n] / len(reqs) == pytest.approx(share, abs=0.015)
    assert sum(not r.fresh for r in reqs) / len(reqs) == pytest.approx(mix["repeat_share"], abs=0.015)
    # the same seed draws the same sequence
    assert draw(mix, 500)[1] == reqs[:500]


def test_fresh_rows_never_repeat_within_the_cache_reach():
    mix = json.loads((ROOT / "portbench" / "traffic" / "gateway.c32.json").read_text())
    tr, reqs = draw(mix, 30000)
    reach = mix["gateway"]["cache_rows"] + mix["clients"] * max(mix["sizes"])
    last = np.full(len(tr.ring), -np.inf)  # fresh rows handed out at each row's last use
    fresh = 0
    wrapped = False
    for r in reqs:
        rows = slice(r.start, r.start + r.n)
        if r.fresh:
            assert fresh - last[rows].max() >= reach
            fresh += r.n
            wrapped |= r.start == 0 and fresh > r.n
        last[rows] = fresh
    assert wrapped  # the ring came round


def test_a_mix_whose_ring_is_too_small_is_refused():
    mix = json.loads((ROOT / "portbench" / "traffic" / "gateway.c32.json").read_text())
    with pytest.raises(ValueError):
        check_mix(dict(mix, ring_rows=65536))


# the symbols as the profiler printed them on an NVIDIA H100 80GB HBM3
K1_NAME = ("void (anonymous namespace)::walk_tile<4, ((anonymous namespace)::Walk)0, true>"
           "((anonymous namespace)::TileArgs)")
K2_NAME = ("void (anonymous namespace)::walk_tile<4, ((anonymous namespace)::Walk)1, true>"
           "((anonymous namespace)::TileArgs)")
K5_NAME = "void (anonymous namespace)::bitvector_tile<2, true, true>((anonymous namespace)::BvArgs)"
COPY = "Memcpy HtoD (Pageable -> Device)"


def recorded(kernel=K1_NAME):
    """A small trace: two requests of 65,536 rows and one of 20, 1,000 us apart."""
    chrome = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0.0, "dur": 3000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": COPY, "ts": 100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": kernel, "ts": 300.0, "dur": 400.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": COPY, "ts": 1100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": K2_NAME, "ts": 1300.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": COPY, "ts": 2100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": kernel, "ts": 2300.0, "dur": 400.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::argmax", "ts": 800.0, "dur": 250.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0},
    ]
    dev, host = devtrace.split_events(chrome)
    return {"device_events": dev, "host_events": host, "trace_window": (0.0, 3000.0),
            "t0": 10.0, "t1": 10.003, "batches": [65536, 20, 65536], "stuck": 0,
            "requests": [(10.0, 10.001, 65536, True), (10.001, 10.0015, 20, True),
                         (10.002, 10.003, 65536, True)]}


def test_metric_readers_on_a_small_recorded_trace():
    rf = CFGS["intreeger-rf"]
    rec = recorded()
    read = lambda name, r=rec: catalog.reader(name).read(r, rf)
    assert read("k1_roofline") == pytest.approx(100 * 2 * work.bound_s(rf, 65536)[0] / 800e-6)
    assert read("device.idle") == pytest.approx(100 * (1 - 1500 / 3000))
    assert read("copy.h2d_ms") == pytest.approx(0.2)
    assert read("rows_per_s") == pytest.approx((65536 * 2 + 20) / 0.003)
    ops = 2 * work.batch_ops(rf, 65536) + work.batch_ops(rf, 20)
    assert read("mfu.trees") == pytest.approx(100 * ops / (0.003 * 67e12))
    assert read("bulk.p95_ms") == pytest.approx(np.percentile([1.0, 0.5, 1.0], 95))
    cov = CFGS["covtype-rf500"]
    k5 = recorded(K5_NAME)
    k5["batches"] = [65536, 65536]
    k5["device_events"] = [e for e in k5["device_events"] if e[1] != K2_NAME]
    assert catalog.reader("k5_roofline").read(k5, cov) == pytest.approx(
        100 * 2 * work.bound_s(cov, 65536)[0] / 800e-6)
    b = devtrace.breakdown(stats.window_events(rec), rec["host_events"], *rec["trace_window"])
    assert b["device_ops"][0] == [K1_NAME, pytest.approx(800e-6)]
    assert ["host: aten::argmax", pytest.approx(400e-6)] in b["idle_gaps"]


def test_the_readers_take_the_counts_of_the_configurations_family():
    boosted = dict(family="gbt", n_rounds=500, n_classes=7, depth=8, n_features=54,
                   learning_rate=0.3, threshold_sample_rows=4096)
    gbt = catalog.family(boosted)
    rec = recorded()
    assert catalog.reader("k1_roofline").read(rec, boosted) == pytest.approx(
        100 * 2 * gbt.bound_s(boosted, 65536)[0] / 800e-6)
    ops = 2 * gbt.batch_ops(boosted, 65536) + gbt.batch_ops(boosted, 20)
    assert catalog.reader("mfu.trees").read(rec, boosted) == pytest.approx(
        100 * ops / (0.003 * 67e12))


@pytest.mark.parametrize("name", ["k1_roofline", "k5_roofline", "device.idle", "copy.h2d_ms"])
def test_a_reader_with_nothing_to_match_reads_nothing(name):
    rec = recorded()
    rec["device_events"] = [e for e in rec["device_events"] if e[0] != "kernel" or name == "copy.h2d_ms"]
    if name == "copy.h2d_ms":
        rec["device_events"] = [e for e in rec["device_events"] if e[0] != "gpu_memcpy"]
    if name == "device.idle":
        rec["device_events"] = []
    assert catalog.reader(name).read(rec, CFGS["intreeger-rf"]) is None


def test_a_roofline_whose_launches_do_not_pair_with_batches_reads_nothing():
    rec = recorded()
    rec["batches"] = [65536, 65536]
    assert catalog.reader("k1_roofline").read(rec, CFGS["intreeger-rf"]) is None
