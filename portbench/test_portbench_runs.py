"""Whole runs of the harness on the CPU, at tiny sizes, in fresh processes.

Each test copies the benchmark into a temporary checkout and adds a tiny
configuration, two tiny mixes and a metric there as new files and entries,
which the harness finds by name.  The look for a card is skipped and the
program runs its plain versions on the CPU; the rest is a run as on the card:
sound runs come out correct, and the timed path broken underneath (half of each
batch left out, an answer altered where it is produced, the control in
bfloat16) comes out not correct.  A traced run on the CPU has no kernels in
its trace, so a cell given a kernel's metric there fails and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TINY = {"name": "tiny", "n_trees": 6, "depth": 4, "n_features": 9, "n_classes": 7,
        "threshold_sample_rows": 256}
MIXES = {
    "tbulk": {"driver": "bulk", "route": "integer:cuda@leaf_major", "clients": 2,
              "sizes": [512], "shares": [1.0], "repeat_share": 0.0, "repeat_window_rows": 0,
              "ring_rows": 2048, "keep_share": 0.5, "warmup_s": 0.2},
    "tgw": {"driver": "gateway", "route": "integer:cuda", "clients": 4,
            "sizes": [1, 20, 64], "shares": [0.4, 0.4, 0.2], "repeat_share": 0.25,
            "repeat_window_rows": 128, "ring_rows": 1024, "keep_share": 1.0, "warmup_s": 0.2,
            "gateway": {"max_batch_rows": 64, "max_delay_ms": 2.0, "max_queue_rows": 4096,
                        "cache_rows": 256}},
}
NEW_METRIC = '''"""Requests answered in the window."""


def read(records, cfg):
    return sum(1 for r in records["requests"] if r[3])
'''
PATCHES = {
    "sound": "",
    # half of each batch left out: its answers taken from the other half
    "half": """
from repro_torch.serve.engine import TreeEngine
import numpy as np
_orig = TreeEngine.predict_scores
def _half(self, X):
    h = max(len(X) // 2, 1)
    s, p = _orig(self, X[:h])
    return np.resize(s, (len(X), s.shape[1])), np.resize(p, len(X))
TreeEngine.predict_scores = _half
""",
    # one answer altered where it is produced: the first row's first score
    "altered": """
from repro_torch.serve.engine import TreeEngine
_orig = TreeEngine.predict_scores
def _altered(self, X):
    s, p = _orig(self, X)
    s = s.copy()
    s[0, 0] ^= 1
    return s, p
TreeEngine.predict_scores = _altered
""",
    "control": """
from portbench import control
control.install(run)
""",
    "jax": """
import types
sys.modules["jax"] = types.ModuleType("jax")
""",
}


TINY_OF = {"intreeger-rf.gateway.c32": "tiny.tgw", "covtype-rf500.bulk64k.k1": "tiny.tbulk"}


def add_checkout(tmp_path, kernel_metric_for=()):
    """A checkout of the benchmark alone, with the tiny pieces added as files.
    The tiny cells read the host's metrics of the cells of their driver; of
    the trace's, only the kernel metrics of ``kernel_metric_for``'s cells."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    (tmp_path / "portbench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for name, mix in MIXES.items():
        (tmp_path / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "metrics" / "requests_answered.py").write_text(NEW_METRIC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test", "reduced": [], "why": "a test",
                             "file": "portbench/configs/tiny.json"})
    for mix in MIXES:
        bench["workloads"].append({"name": f"tiny.{mix}", "config": "tiny", "traffic": mix,
                                   "chips": 1, "why": "a test"})
    real = [w["name"] for w in bench["workloads"] if not w["name"].startswith("tiny.")]
    for m in bench["per_layer"]:
        if m["source"] == "device_trace":
            m.setdefault("workloads", list(real))
        for cell, tiny in TINY_OF.items():
            if cell in m.get("workloads", []) and (
                    m["source"] != "device_trace"
                    or (m["name"].endswith("_roofline") and tiny in kernel_metric_for)):
                m["workloads"].append(tiny)
    bench["end_to_end"].append({"name": "requests_answered", "unit": "requests",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.tbulk", "tiny.tgw"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture
def checkout(tmp_path):
    return add_checkout(tmp_path)


def run_cell(where: Path, workload: str, patch: str = "sound", trace: int = 0,
             on_cpu: bool = True):
    script = "\n".join([
        "import json, sys",
        f"sys.path[:0] = [{str(where)!r}, {str(ROOT / 'src')!r}]",
        "from portbench import run",
        *(["run.DEVICE = 'cpu'", "run.require_cards = lambda n: None"] if on_cpu else []),
        PATCHES[patch],
        "rc = run.main(sys.argv[1:])",
        "print('MODULES ' + json.dumps(sorted({m.split('.')[0] for m in sys.modules})), file=sys.stderr)",
        "sys.exit(rc)",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script, "--workload", workload, "--seed",
                           str(2 ** 31 + 9), "--seconds", "1", "--trace", str(trace)],
                          cwd=where, env=env, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc, result


@pytest.mark.parametrize("workload", ["tiny.tbulk", "tiny.tgw"])
def test_a_sound_run_is_correct_and_finds_the_new_files(checkout, workload):
    proc, result = run_cell(checkout, workload)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True and result["failed"] == 0
    assert result["check"]["rows_checked"]["value"] > 0
    assert set(result["metrics"]) == {"rows_per_s", "setup_s", "requests_answered"}
    assert result["metrics"]["requests_answered"]["value"] > 0
    assert list(result)[-1] == "check"
    stderr = proc.stderr.strip().splitlines()
    assert stderr[-4].startswith("check: rows_wrong 0 (limit 0)")
    modules = set(json.loads(stderr[-1].split(" ", 1)[1]))
    assert not modules & {"jax", "jaxlib", "flax", "repro"}


def test_a_traced_run_reports_the_per_layer_metrics(checkout):
    proc, result = run_cell(checkout, "tiny.tgw", trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True
    assert {"gateway.p95_ms", "gateway.queue_ms", "mfu.trees"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", ["tiny.tbulk", "tiny.tgw"])
def test_a_kernel_metric_that_finds_no_kernel_fails_the_run(tmp_path, workload):
    """The cell is given K1's roofline, and its trace holds no walk kernel."""
    proc, result = run_cell(add_checkout(tmp_path, (workload,)), workload, trace=1)
    assert proc.returncode == 4 and result is None
    assert "k1_roofline" in proc.stderr and "found nothing to read" in proc.stderr


@pytest.mark.parametrize("patch,workload", [("half", "tiny.tbulk"), ("half", "tiny.tgw"),
                                            ("altered", "tiny.tbulk"), ("altered", "tiny.tgw"),
                                            ("control", "tiny.tbulk"), ("control", "tiny.tgw")])
def test_a_broken_timed_path_is_not_correct(checkout, patch, workload):
    proc, result = run_cell(checkout, workload, patch)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False
    assert result["check"]["rows_wrong"]["value"] > 0


def test_a_configuration_of_an_unknown_family_fails_and_prints_no_result(checkout):
    (checkout / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(dict(TINY, family="no_such_family")))
    proc, result = run_cell(checkout, "tiny.tbulk")
    assert proc.returncode == 2 and result is None and proc.stdout.strip() == ""
    assert "no_such_family" in proc.stderr


def test_a_run_that_holds_jax_prints_no_result(checkout):
    proc, result = run_cell(checkout, "tiny.tbulk", "jax")
    assert proc.returncode == 3 and result is None
    assert "jax" in proc.stderr


def test_without_a_card_a_run_fails_and_prints_no_result(checkout):
    proc, result = run_cell(checkout, "tiny.tbulk", on_cpu=False)
    assert proc.returncode == 2 and result is None
    assert "CUDA card" in proc.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "covtype-rf500.bulk64k.k1", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
