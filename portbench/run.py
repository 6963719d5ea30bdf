#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the cards of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  It

1. makes the cell's model, by its configuration's family
   (``portbench/families/``), and its traffic from ``--seed``, builds the
   program's engine or gateway on the mix's route (the kernels are built with
   ``nvcc`` into ``build/repro_torch/`` in the checkout on the first run
   there), warms the cell's own buckets and runs the mix's warm-up traffic:
   ``setup_s``;
2. drives the mix for ``--seconds`` (under ``torch.profiler`` with
   ``--trace 1``);
3. frees the program's state and compares the kept answers with the family's
   plain reference on the card;
4. fails, printing no result, if JAX or the JAX package is loaded;
5. fails, printing no result, if a metric that ``BENCHMARK.json`` gives the
   cell reads nothing: a kernel renamed, launches that no longer pair with
   batches, or a stage that is gone, fail loudly and never drop out of the line;
6. prints each number compared beside its limit on standard error, then one
   JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
   end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
   with ``--trace 1`` ``breakdown``, and last ``check``.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; so it does for a name, a family or a mix key that nothing
reads.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import catalog, check, devtrace, stats  # noqa: E402
from portbench.traffic import Traffic  # noqa: E402

DEVICE = "cuda"
# top-level module names no run may hold: JAX, its libraries and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every cache a library could build, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {n} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(device) -> dict:
    import torch

    dev = torch.device(device)
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit"] = q.stdout.strip().splitlines()[0] if q.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        out["power_limit"] = "unknown"
    return out


class Window:
    """Entered at the window's start, which ends set-up, and left at its end;
    with tracing on it runs the profiler and marks the window as
    ``portbench.window``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.prof = None
        self.setup_s = None

    def __enter__(self):
        self.setup_s = time.perf_counter() - T_START
        if self.traced:
            import torch

            self.prof = devtrace.Profiled().__enter__()
            self._mark = torch.profiler.record_function(devtrace.WINDOW)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.traced:
            self._mark.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False


def trace_records(prof) -> dict:
    dev, host = prof.events()
    _, t0, dur = next(h for h in host if h[0] == devtrace.WINDOW)
    return {"device_events": dev, "host_events": host, "trace_window": (t0, t0 + dur)}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    try:
        cell = catalog.load_cell(args.workload)
        driver = catalog.driver(cell.mix)
    except catalog.UnknownName as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    readers = {m["name"]: catalog.reader(m["name"])
               for m in (cell.per_layer if args.trace else cell.end_to_end)
               if m["name"] != "setup_s"}
    require_cards(cell.chips)
    import torch

    traced = bool(args.trace)
    marks = [("start", time.perf_counter())]
    forest = cell.family.make_forest(cell.cfg, args.seed)
    marks.append(("forest", time.perf_counter()))
    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, family=cell.family, forest=forest,
                          device=torch.device(DEVICE),
                          traffic=Traffic(cell.mix, cell.cfg["n_features"], args.seed),
                          trace=traced)
    marks.append(("rows", time.perf_counter()))
    drv = driver.Driver(ctx)
    drv.build()
    marks.append(("program", time.perf_counter()))
    window = Window(traced)
    drv.serve(cell.mix["warmup_s"], args.seconds, window)
    marks.append(("warm-up traffic", T_START + window.setup_s))
    print("setup: " + ", ".join(f"{name} {t - marks[i][1]:.3f} s" for i, (name, t)
                                in enumerate(marks[1:])) + f" after {marks[0][1] - T_START:.3f} s"
          " of imports", file=sys.stderr)
    records = dict(drv.records)
    device = card(DEVICE)
    if traced:
        records.update(trace_records(window.prof))
        events = stats.window_events(records)
        t0, t1 = records["trace_window"]
        device["busy_s"] = devtrace.busy_us(events) * 1e-6
        device["window_s"] = (t1 - t0) * 1e-6
    failed = sum(1 for r in records["requests"] if not r[3]) + records["stuck"]
    answers, errors = drv.answers, drv.errors
    drv.close()
    del drv
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    ref = cell.family.Reference(forest, ctx.device)
    ref_scores, ref_preds = ref.scores(ctx.traffic.ring)
    correct, limits = check.verdict(check.compare(answers, ref_scores, ref_preds, failed))

    metrics, unread = {}, []
    for m in (cell.per_layer if traced else cell.end_to_end):
        if m["name"] == "setup_s":
            value = window.setup_s
        else:
            value = readers[m["name"]].read(records, cell.cfg)
        if value is None:
            unread.append(m["name"])
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    for e in sorted(set(errors))[:5]:
        print(f"portbench: request error: {e}", file=sys.stderr)
    result = {"correct": correct, "attempted": len(records["requests"]) + records["stuck"],
              "failed": failed, "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = devtrace.breakdown(stats.window_events(records),
                                                 records["host_events"], *records["trace_window"])
    result["check"] = limits
    for name, v in limits.items():
        bound = f"limit {v['limit']}" if "limit" in v else f"at least {v['least']}"
        print(f"check: {name} {v['value']} ({bound})", file=sys.stderr)
    if unread:
        print(f"portbench: the cell's metrics {unread} found nothing to read", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that no run may hold: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
