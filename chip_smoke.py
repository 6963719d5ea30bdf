#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout (it imports ``src/repro_torch``) on a host
with one CUDA card.  It

  1. builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``,
  2. builds the full-width ``intreeger-rf`` model (128 complete trees of
     depth 10, 87 features, 8 classes) from the seed, thresholds drawn from
     the rows' own quantiles and leaves from a Dirichlet, and quantizes it
     through ``ForestIR.from_forest``,
  3. serves requests of 65,536, 1,000, 100, 20 and 1 rows through
     ``TreeEngine(ir, spec="integer:cuda@leaf_major")``, and 65,536 rows each
     through ``flint:cuda@leaf_major`` and ``integer:cuda@padded``, with the
     kernels' launch counters set to 0 just before and read just after,
  4. holds every result bit for bit against the torch reference walk on the
     card, a 100-row result against the independent CPU oracle, and each
     kernel against its plain version at the 65,536-row shape,
  5. times each kernel (L2 flushed before every launch), its plain version
     and the end-to-end request with CUDA events and the host clock.

Any mismatch, build failure or launch error ends the run with a non-zero
exit.  On success the lines before the last hold the card's name and power
limit and one JSON object of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the repo's serving configuration (src/repro/configs/intreeger_rf.py) and
# the serve_64k request shape (src/repro/launch/shapes.py)
N_TREES, DEPTH, N_FEATURES, N_CLASSES = 128, 10, 87, 8
ROWS = 65_536
SMALL_REQUESTS = (1000, 100, 20, 1)
THRESHOLD_SAMPLE_ROWS = 4096

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the float32 rate
# outside the tensor cores, the nearest published rate for these integer
# compares, selects and adds
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12

KERNEL_TIMING_REPS = 20
PLAIN_TIMING_REPS = 5
REQUEST_TIMING_REPS = 10


def fail(message: str, code: int = 1):
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr)
    sys.exit(code)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def complete_tree(rng, sample, tree_arrays_cls):
    """One complete tree of DEPTH levels in BFS order (children 2i+1, 2i+2).
    Each split takes a random feature and, as its threshold, a random
    quantile in [0.2, 0.8) of the sample rows that reach the node, so both
    branches are taken all the way down."""
    n_int = 2 ** DEPTH - 1
    n = 2 ** (DEPTH + 1) - 1
    feature = np.full(n, -1, np.int32)
    threshold = np.zeros(n, np.float32)
    left = np.arange(n, dtype=np.int32)
    right = left.copy()
    left[:n_int] = 2 * np.arange(n_int) + 1
    right[:n_int] = 2 * np.arange(n_int) + 2
    feature[:n_int] = rng.integers(0, N_FEATURES, n_int)
    rows = np.arange(len(sample))
    node = np.zeros(len(sample), np.int64)
    for level in range(DEPTH):
        lo, hi = 2 ** level - 1, 2 ** (level + 1) - 1
        vals = sample[rows, feature[node]]
        order = np.lexsort((vals, node))
        counts = np.bincount(node - lo, minlength=hi - lo)
        starts = np.cumsum(counts) - counts
        pick = starts + np.floor(rng.uniform(0.2, 0.8, hi - lo) * counts).astype(np.int64)
        chosen = vals[order][np.minimum(pick, len(vals) - 1)]
        # a node no sample row reaches takes some row's value of its feature
        fallback = sample[rng.integers(0, len(sample), hi - lo), feature[lo:hi]]
        threshold[lo:hi] = np.where(counts > 0, chosen, fallback)
        node = np.where(vals <= threshold[node], left[node], right[node])
    probs = np.zeros((n, N_CLASSES), np.float64)
    probs[n_int:] = rng.dirichlet(np.full(N_CLASSES, 0.5), n - n_int)
    return tree_arrays_cls(feature=feature, threshold=threshold, left=left,
                           right=right, leaf_probs=probs, depth=DEPTH)


def build_model(seed: int):
    from repro_torch.ir import ForestIR
    from repro_torch.trees import TreeArrays

    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, (ROWS, N_FEATURES)).astype(np.float32)
    sample = X[rng.choice(ROWS, THRESHOLD_SAMPLE_ROWS, replace=False)]
    forest = SimpleNamespace(
        trees_=[complete_tree(rng, sample, TreeArrays) for _ in range(N_TREES)],
        n_classes_=N_CLASSES, n_features_=N_FEATURES)
    return ForestIR.from_forest(forest), X


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, flush=None) -> float:
    """Median device ms of ``fn()`` over ``reps`` runs after one warm-up,
    each timed with its own CUDA events; ``flush()`` runs before each."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn()``, which must return host data."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    import torch

    to64 = lambda t: t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return int((to64(a) - to64(b)).abs().max())


def leaf_major_steps(x_keys, feature, threshold_key, left, right, nint) -> int:
    """Walk steps the bounded walk takes on this run's data, summed over
    (row, tree)."""
    import torch

    node = torch.zeros((feature.shape[0], x_keys.shape[0]), dtype=torch.int64,
                       device=x_keys.device)
    nint = nint.long()[:, None]
    x_t = x_keys.t()
    steps = 0
    while True:
        inside = node < nint
        count = int(inside.sum())
        if count == 0:
            return steps
        steps += count
        feat = feature.gather(1, node).clamp(min=0).long()
        go_left = x_t.gather(0, feat) <= threshold_key.gather(1, node)
        nxt = torch.where(go_left, left.gather(1, node), right.gather(1, node)).long()
        node = torch.where(inside, nxt, node)


def bound(nbytes: int, ops: int):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}; run it from "
             "the root of a checkout", code=2)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, str(SRC))
    from repro_torch.core.ensemble import finalize_partials
    from repro_torch.core.flint import float_to_key
    from repro_torch.kernels import _build, tree_traverse as tt
    from repro_torch.kernels.ops import pick_blocks
    from repro_torch.kernels.ref import tree_predict_integer_ref
    from repro_torch.serve import TreeEngine

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 1. build the kernels
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.2f} s)")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line
                                     or "Function properties" in line):
            print("  " + line.strip())

    # 2. the model
    t0 = time.perf_counter()
    ir, X = build_model(args.seed)
    print(f"model: {ir.n_trees} trees, depth {ir.max_depth}, {ir.n_features} "
          f"features, {ir.n_classes} classes, {ir.total_nodes} nodes; built and "
          f"quantized in {time.perf_counter() - t0:.2f} s")

    # 3. the main path, with the launch counters read around it
    routes = ("integer:cuda@leaf_major", "flint:cuda@leaf_major",
              "integer:cuda@padded")
    engines = {spec: TreeEngine(ir, spec=spec) for spec in routes}
    requests = [("integer:cuda@leaf_major", X)]
    requests += [("integer:cuda@leaf_major", X[:n]) for n in SMALL_REQUESTS]
    requests += [("flint:cuda@leaf_major", X), ("integer:cuda@padded", X)]
    tt.reset_launches()
    results = [engines[spec].predict_scores(rows) for spec, rows in requests]
    torch.cuda.synchronize()
    launches = dict(tt.LAUNCHES)
    print(f"main path: {len(requests)} requests, kernel launches {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")

    # 4a. every result against the torch reference walk on the card
    refs = {mode: TreeEngine(ir, spec=f"{mode}:reference", device=dev)
            for mode in ("integer", "flint")}
    for (spec, rows), (scores, preds) in zip(requests, results):
        mode = spec.split(":")[0]
        ref_scores, ref_preds = refs[mode].predict_scores(rows)
        if scores.shape != (len(rows), N_CLASSES) or preds.shape != (len(rows),):
            fail(f"{spec} on {len(rows)} rows: shapes {scores.shape} {preds.shape}")
        if scores.dtype != ref_scores.dtype or not np.array_equal(scores, ref_scores) \
                or not np.array_equal(preds, ref_preds):
            fail(f"{spec} on {len(rows)} rows differs from {mode}:reference")
        if mode == "flint":
            total = scores.astype(np.float64).sum(axis=1)
            if not np.all(np.isfinite(scores)) or np.abs(total - 1.0).max() > 1e-5:
                fail("flint probabilities do not sum to 1")
        print(f"  {spec:<24} {len(rows):>6} rows: bit-identical to {mode}:reference")

    # 4b. a small request against the independent oracle on the CPU
    lm = ir.materialize("leaf_major")
    small = X[:100]
    oracle = tree_predict_integer_ref(
        float_to_key(torch.from_numpy(small)), torch.from_numpy(lm.feature),
        torch.from_numpy(lm.threshold_key), torch.from_numpy(lm.left),
        torch.from_numpy(lm.right), torch.from_numpy(lm.leaf_fixed),
        lm.max_depth)
    got = engines["integer:cuda@leaf_major"].predict_scores(small)[0]
    if not np.array_equal(got, oracle.numpy()):
        fail("100-row integer:cuda result differs from the CPU oracle")
    print("  integer:cuda@leaf_major    100 rows: bit-identical to the CPU oracle")

    # 4c. each kernel against its plain version at the main path's shape
    def on_card(packed):
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return (as_t(packed.feature), as_t(packed.threshold_key),
                as_t(packed.left), as_t(packed.right),
                as_t(packed.leaf_fixed.view(np.int32)))

    keys = float_to_key(torch.from_numpy(X).to(dev))
    lm_tables, pad_tables = on_card(lm), on_card(ir.materialize("padded"))
    nint = torch.from_numpy(lm.internal_counts.astype(np.int32)).to(dev)
    block_b, block_t = pick_blocks(ROWS, N_TREES,
                                   torch.cuda.get_device_properties(dev).multi_processor_count)
    f, k, l, r, leaf = lm_tables
    kernels = {
        "leaf_major": (
            lambda: tt.tree_traverse_leaf_major(keys, f, k, l, r, nint, leaf,
                                                block_b=block_b, block_t=block_t),
            lambda: tt.leaf_major_plain(keys, f, k, l, r, nint, leaf,
                                        block_b=block_b, block_t=block_t),
            "src/repro/kernels/tree_traverse.py:110"),
        "gather": (
            lambda: tt.tree_traverse_gather(keys, *pad_tables, depth=ir.max_depth,
                                            block_b=block_b, block_t=block_t),
            lambda: tt.gather_plain(keys, *pad_tables, depth=ir.max_depth,
                                    block_b=block_b, block_t=block_t),
            "src/repro/kernels/tree_traverse.py:80"),
    }
    errors = {}
    for name, (kernel, plain, _) in kernels.items():
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        errors[name] = max_abs_err(out, ref)
        print(f"kernel {name}: {block_b} rows x {block_t} trees per CTA, "
              f"max |kernel - plain| = {errors[name]} (tolerance 0: integer sums)")
        if errors[name] != 0:
            fail(f"kernel {name} disagrees with its plain version")

    # 5. times and bounds
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.fill_(1)
    table_bytes = sum(t.numel() * 4 for t in lm_tables)
    io_bytes = keys.numel() * 4 + ROWS * N_CLASSES * 4
    steps = {
        "leaf_major": leaf_major_steps(keys, f, k, l, r, nint),
        "gather": ROWS * N_TREES * ir.max_depth,
    }
    rows_out = []
    for name, (kernel, plain, replaces) in kernels.items():
        ms = cuda_ms(kernel, KERNEL_TIMING_REPS, flush)
        warm_ms = cuda_ms(kernel, KERNEL_TIMING_REPS)
        plain_ms = cuda_ms(plain, PLAIN_TIMING_REPS, flush)
        nbytes = table_bytes + io_bytes + (N_TREES * 4 if name == "leaf_major" else 0)
        # per walk step: the key compare, the child select and the loop's
        # own compare; per (row, tree): one add per class
        ops = 3 * steps[name] + ROWS * N_TREES * N_CLASSES
        bound_ms, bound_by = bound(nbytes, ops)
        print(f"kernel {name}: {ms:.4f} ms L2-flushed, {warm_ms:.4f} ms warm, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes} bytes, {ops} ops, {steps[name]} walk steps), "
              f"launches {launches[name]}; no single PyTorch call computes "
              "this function, so there is no library time")
        rows_out.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/tree_traverse.cu",
            replaces=replaces, launches=launches[name], max_abs_err=errors[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))

    for spec in routes:
        eng = engines[spec]
        ms = host_ms(lambda: eng.predict_scores(X), REQUEST_TIMING_REPS)
        print(f"request {spec}: {ROWS} rows end to end (H2D, keys, kernel, D2H, "
              f"finalize) {ms:.3f} ms median, host clock")

    # the integer:cuda@leaf_major request's steps, each timed on its own
    x_dev = torch.from_numpy(X).to(dev)
    acc = kernels["leaf_major"][0]()
    acc_host = acc.view(torch.int32).cpu().numpy().view(np.uint32)
    steps_ms = {
        "h2d": cuda_ms(lambda: torch.from_numpy(X).to(dev), REQUEST_TIMING_REPS),
        "keys": cuda_ms(lambda: float_to_key(x_dev), REQUEST_TIMING_REPS),
        "kernel": cuda_ms(kernels["leaf_major"][0], REQUEST_TIMING_REPS),
        "d2h": cuda_ms(lambda: acc.view(torch.int32).cpu(), REQUEST_TIMING_REPS),
        "finalize": host_ms(lambda: finalize_partials("integer", acc_host, ir.n_trees,
                                                      ir.scale), REQUEST_TIMING_REPS),
    }
    print("request integer:cuda@leaf_major steps, ms median: " + ", ".join(
        f"{k} {v:.4f}" for k, v in steps_ms.items()))

    print(card_line())
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
