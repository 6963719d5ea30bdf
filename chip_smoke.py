#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --kernels-only [--src DIR]

Run from the root of a checkout (it imports ``src/repro_torch``) on a host
with one CUDA card.  It

  1. builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
     (one ``nvcc`` per source, started together),
  2. builds the full-width ``intreeger-rf`` model (128 complete trees of
     depth 10, 87 features, 8 classes) from the seed, thresholds drawn from
     the rows' own quantiles and leaves from a Dirichlet, and quantizes it
     through ``ForestIR.from_forest``,
  3. serves requests of 65,536, 1,000, 100, 20 and 1 rows through
     ``TreeEngine(ir, spec="integer:cuda@leaf_major")``, and 65,536 rows each
     through ``flint:cuda@leaf_major`` and ``integer:cuda@padded``; requests
     of 65,536, 1,000, 20 and 1 rows through ``integer:bitvector`` (K5, the
     QuickScorer scorer) and 65,536 through ``flint:bitvector``; and 65,536
     rows through each sharded plan route, ``integer:cuda+tree_parallel:2``,
     ``integer:cuda|bitvector+tree_parallel:2`` (half the trees on K1, half
     on K5) and ``integer:cuda+row_parallel:2``; with the kernels' launch
     counters set to 0 just before and read just after,
  4. holds every result bit for bit against the torch reference walk on the
     card, a 100-row result against the independent CPU oracle, and each
     kernel (K1, K2, K3, the one-hot walk, and K5) against its plain version
     at the 65,536-row shape and the gateway's small batches, K3 also on
     small malformed tables at every walk count and staging, K5 also on a
     small forest whose bitvectors span 36 words and on random clear sets
     that are no leaf range (multi-word spans with zero words inside) at
     pinned CTA shapes, and prints K5's packed table bytes beside the
     dense slot grid's, and K5's bound from the records each (row, tree)
     needs up to its exit word beside the count over every entry,
  5. times each kernel (L2 flushed before every launch, and warm), its plain
     version and the end-to-end request of every route with CUDA events and
     the host clock; each kernel also at the gateway's small batches (K1 at
     1,000 rows, K2 at 20, K3 and K5 at both), and prints each kernel's CTA
     shape and shared memory as its wrapper launched it,
  6. serves a seeded open-loop workload through two ``Gateway``s over one
     ``ModelRegistry`` at once — ``integer:cuda?autotune=true`` (K1, and K2
     under 64 rows) and ``integer:cuda@padded?impl=onehot`` (K3) — with
     repeated rows for the cache and a hot swap to a second forest halfway,
     with the launch counters set to 0 just before and read just after, and
     holds every response against the reference walk of the version that
     served it,
  7. serves a shorter seeded workload through a gateway on the
     heterogeneous plan route ``integer:cuda|bitvector+tree_parallel:2``,
     with the launch counters read around it, holds every response against
     the reference walk, and checks that its stats show both shard labels,
  8. deploys the model: writes its JSON, converts it to ITRF with
     ``python -m repro_torch.trees.convert`` twice (plain, and with
     ``--strip-float --pack-leaves``), checks both files' ``--verify``
     digests, each from a fresh process, against the in-process digest,
     registers the plain file by mmap and serves 65,536 rows through
     ``integer:cuda@leaf_major`` (K1), ``integer:bitvector`` (K5) and
     ``integer:reference@packed_leaf``; then starts two loopback shard
     workers on the card and serves 65,536 rows through
     ``integer:cuda+remote_tree_parallel:2`` and
     ``integer:cuda|bitvector+remote_tree_parallel:2`` over both files (the
     stripped one ships its ITRF image in HELLO, the plain one its arrays),
     timed beside ``integer:cuda+tree_parallel:2``, with the workers' own
     launch counts read from their span records around it; then serves
     65,536 rows through
     ``integer:cuda|native_c_table+remote_tree_parallel:2`` over the plain
     file: worker 0 launches K1, worker 1 builds the C table walk of the
     other half on its host and launches nothing,
  9. serves the plan gateway's workload through a gateway on
     ``integer:cuda|bitvector+remote_tree_parallel:2`` over the stripped
     artifact and those workers, holds every response against the reference
     walk, and fails if either worker launched no kernel,
 10. serves the host-C routes, emitted C compiled by gcc and run on the
     host CPU (the libraries built on threads: the if-else ones from the
     run's beginning, the others while step 8 converts the model in other
     processes): ``integer|flint:native_c_table`` and
     ``integer|flint:native_c_bitvector`` at 65,536, 1,000, 20 and 1 rows,
     ``?block_rows=1``, ``?simd=false`` and ``?interleave=1`` at 1,000;
     ``integer|float:native_c`` on the first 4 trees at 65,536 and 20 rows;
     ``integer:cuda|native_c_table+tree_parallel:2`` (K1 beside C) and
     ``integer:bitvector|native_c_bitvector+tree_parallel:2`` (K5 beside
     C) at 65,536 rows; the plan gateway's workload on
     ``integer:native_c_table|cuda+tree_parallel:2``, whose ``isa`` column
     must name the C shard's ISA; and ``integer:native_c_bitvector?
     autotune=true`` on the first 16 trees, its winner exported to an ITRF
     file under ``torch-cpu:<isa>`` and read back without measuring.  Each
     is held bit for bit against the reference walk (the float if-else
     route's scores within 1e-6, its predictions equal), and the host
     CPU's model, each library's source bytes and build seconds, each
     route's ISA and host-clock median are printed.  The three requests of
     the C bitvector scorer on 65,536 rows take seconds each, so they run
     once each, at once on threads, beside the autotune step.

``--kernels-only`` builds the kernels and the model and only checks and
times the kernel cases of step 5, printing them as one JSON line;
``--src`` names another checkout's ``src`` to take ``repro_torch`` from (an
older tree, for a before/after comparison in one process per tree), through
entry points both trees have.

Any mismatch, build failure or launch error ends the run with a non-zero
exit.  On success the lines before the last hold the card's name and power
limit and one JSON object of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
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
# a kernel timing starts behind this many cycles of device sleep (about half
# a millisecond), so the host's launch work before a kernel lies outside the
# events and the time is the device's alone
LEAD_SLEEP_CYCLES = 1_000_000
# the gateway's small batches, at which each kernel is also timed: gateway
# A's batches of 1,000 rows take K1 and those under 64 rows (20) K2;
# gateway B's take K3 at both
SMALL_ROWS = {"leaf_major": (1000,), "gather": (20,), "onehot": (1000, 20),
              "bitvector": (1000, 20)}

# the TPU kernels that K1, K2 and K3 replace, and the jnp function K5 does
REPLACES = {"leaf_major": "src/repro/kernels/tree_traverse.py:110",
            "gather": "src/repro/kernels/tree_traverse.py:80",
            "onehot": "src/repro/kernels/tree_traverse.py:80",
            "bitvector": "src/repro/kernels/bitvector.py:83"}
SOURCES = {"leaf_major": "src/repro_torch/csrc/tree_traverse.cu",
           "gather": "src/repro_torch/csrc/tree_traverse.cu",
           "onehot": "src/repro_torch/csrc/tree_traverse.cu",
           "bitvector": "src/repro_torch/csrc/bitvector.cu"}

# the QuickScorer route's requests, and the sharded plan routes (each at
# ROWS rows); the plan gateway's workload is GATEWAY_* with fewer requests
BITVECTOR_REQUESTS = (ROWS, 1000, 20, 1)
PLAN_ROUTES = ("integer:cuda+tree_parallel:2", "integer:cuda|bitvector+tree_parallel:2",
               "integer:cuda+row_parallel:2")
PLAN_GATEWAY_ROUTE = "integer:cuda|bitvector+tree_parallel:2"
PLAN_GATEWAY_REQUESTS = 60
# the small forest whose bitvectors span 36 uint32 words: chains of these
# depths (a chain of d splits has d + 1 leaves) beside random trees
WIDE_CHAINS = (1100, 70)
WIDE_ROWS = 2000
# K5 on random clear sets that are no leaf range: the widths, the tables'
# size, and the CTA shapes pinned beside K5's own (rows, trees, splits; the
# last reads its records from the table)
SPAN_WIDTHS = (2, 8, 36)
SPAN_TREES, SPAN_SLOTS, SPAN_FEATURES, SPAN_ROWS, SPAN_KEYS = 24, 300, 87, 1000, 40
SPAN_SHAPES = ({}, dict(block_b=32, block_t=1, splits=16), dict(block_b=64, block_t=5, splits=3),
               dict(block_b=128, block_t=24, splits=1), dict(block_b=256, block_t=2, splits=2),
               dict(block_b=128, block_t=3, splits=4, _stage_records=False))

# the gateway phase: request sizes and their shares, the share of requests
# that repeat an earlier request's rows, the open-loop arrival rate
GATEWAY_REQUESTS = 240
GATEWAY_ROWS = (1, 20, 256, 4096)
GATEWAY_ROW_SHARES = (0.35, 0.35, 0.2, 0.1)
GATEWAY_REPEAT_SHARE = 0.25
GATEWAY_RATE_PER_S = 100.0
GATEWAY_MAX_BATCH_ROWS = 4096
MODEL_ID = "intreeger-rf"

# the deployment phase: the routes served from the registered plain
# artifact, the remote routes (two loopback workers on the card) with the
# in-process plan timed beside them, each at ROWS rows, and the remote
# gateway's route; its files go under DEPLOY_DIR, which git ignores
DEPLOY_ROUTES = ("integer:cuda@leaf_major", "integer:bitvector",
                 "integer:reference@packed_leaf")
REMOTE_ROUTES = ("integer:cuda+remote_tree_parallel:2",
                 "integer:cuda|bitvector+remote_tree_parallel:2")
REMOTE_BASELINE = "integer:cuda+tree_parallel:2"
REMOTE_GATEWAY_ROUTE = "integer:cuda|bitvector+remote_tree_parallel:2"
REMOTE_WORKERS = 2
DEPLOY_DIR = ROOT / "build" / "chip_smoke_deploy"

# the host-C phase: the emitted-C routes at full width and their row counts,
# the knob routes at HOST_C_KNOB_ROWS, the if-else C on its first
# IF_ELSE_TREES trees (gcc -O2 takes 24 s for 8 of these trees and 269 s
# for 32 on an 8-core x86 host, so the full model cannot build inside a
# run), the mixed routes beside K1 and K5, the gateway's route (its first
# shard is C, so the engine reports the C shard's ISA, as the JAX engine
# does; a plan whose first shard is on the card reports none), the
# autotuned route on the first TUNE_TREES trees, and the remote route over
# the deployment phase's workers.  A timing takes REQUEST_TIMING_REPS runs,
# or as many as fit HOST_C_TIMING_BUDGET_S.
HOST_C_ROUTES = ("integer:native_c_table", "flint:native_c_table",
                 "integer:native_c_bitvector", "flint:native_c_bitvector")
HOST_C_ROWS = (ROWS, 1000, 20, 1)
HOST_C_KNOB_ROUTES = ("integer:native_c_table?block_rows=1",
                      "integer:native_c_table?simd=false",
                      "integer:native_c_bitvector?interleave=1")
HOST_C_KNOB_ROWS = 1000
IF_ELSE_TREES = 4
IF_ELSE_ROUTES = ("integer:native_c", "float:native_c")
IF_ELSE_ROWS = (ROWS, 20)
# float32 sums of the same leaves in the same tree order, times one
# reciprocal: the C and the reference walk may differ only by rounding
IF_ELSE_FLOAT_TOL = 1e-6
HOST_C_MIXED = {"integer:cuda|native_c_table+tree_parallel:2": "leaf_major",
                "integer:bitvector|native_c_bitvector+tree_parallel:2": "bitvector"}
HOST_C_GATEWAY_ROUTE = "integer:native_c_table|cuda+tree_parallel:2"
TUNE_TREES = 16
TUNE_ROUTE = "integer:native_c_bitvector?autotune=true"
HOST_C_REMOTE_ROUTE = "integer:cuda|native_c_table+remote_tree_parallel:2"
HOST_C_TIMING_BUDGET_S = 3.0
HOST_C_DIR = ROOT / "build" / "chip_smoke_host_c"


def fail(message: str, code: int = 1):
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr)
    sys.exit(code)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names its first core (model name,
    vendor, family, model, stepping, the AVX2 and AVX-512F flags), and the
    core count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    flags = [f for f in ("avx2", "avx512f") if f in info.get("flags", "").split()]
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')} stepping "
            f"{info.get('stepping', '?')}; {'+'.join(flags) or 'no AVX2'}), "
            f"{os.cpu_count()} cores")


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
    """(forest, its ForestIR, the 65,536 rows its thresholds came from)."""
    from repro_torch.ir import ForestIR
    from repro_torch.trees import TreeArrays

    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, (ROWS, N_FEATURES)).astype(np.float32)
    sample = X[rng.choice(ROWS, THRESHOLD_SAMPLE_ROWS, replace=False)]
    forest = SimpleNamespace(
        trees_=[complete_tree(rng, sample, TreeArrays) for _ in range(N_TREES)],
        n_classes_=N_CLASSES, n_features_=N_FEATURES)
    return forest, ForestIR.from_forest(forest), X


def chain_tree(depth: int, tree_arrays_cls):
    """A right-leaning chain of ``depth`` splits on feature 0 (``depth + 1``
    leaves), thresholds ``k - depth / 2``: rows spread over that range exit
    at every leaf, the highest bits of a wide bitvector included."""
    n = 2 * depth + 1
    feature = np.full(n, -1, np.int32)
    threshold = np.zeros(n, np.float32)
    left = np.arange(n, dtype=np.int32)
    right = left.copy()
    probs = np.zeros((n, N_CLASSES), np.float64)
    for k in range(depth):
        feature[2 * k] = 0
        threshold[2 * k] = k - depth / 2.0
        left[2 * k], right[2 * k] = 2 * k + 1, 2 * k + 2
        probs[2 * k + 1, k % N_CLASSES] = 1.0
    probs[n - 1, (depth + 1) % N_CLASSES] = 1.0
    return tree_arrays_cls(feature=feature, threshold=threshold, left=left,
                           right=right, leaf_probs=probs, depth=depth)


def wide_forest(seed: int):
    """(ForestIR, WIDE_ROWS rows): the chains of WIDE_CHAINS, whose longest
    makes every bitvector 36 uint32 words (wider than a depth-10 tree's 32),
    and rows whose feature 0 spans the chains' thresholds."""
    from repro_torch.ir import ForestIR
    from repro_torch.trees import TreeArrays

    forest = SimpleNamespace(trees_=[chain_tree(d, TreeArrays) for d in WIDE_CHAINS],
                             n_classes_=N_CLASSES, n_features_=N_FEATURES)
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (WIDE_ROWS, N_FEATURES)).astype(np.float32)
    half = max(WIDE_CHAINS) / 2.0 + 4.0
    x[:, 0] = rng.uniform(-half, half, WIDE_ROWS)
    return ForestIR.from_forest(forest), x


def malformed_tables(packed):
    """The first three trees of ``packed``'s tables with reads that leave
    them: at the root, a left child >= N, a feature index >= F and a right
    child < 0.  K3 reads 0 for each: a row that leaves the table at a root
    goes back to it and out again, so a walk of an odd number of levels ends
    outside (a zero leaf row), of an even number at the root."""
    tables = [np.ascontiguousarray(a[:3]).copy() for a in
              (packed.feature, packed.threshold_key, packed.left, packed.right,
               packed.leaf_fixed.view(np.int32))]
    feature, _, left, right, _ = tables
    left[0, 0] = feature.shape[1] + 3
    feature[1, 0] = N_FEATURES + 2
    right[2, 0] = -2
    return tables


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, flush=None, lead: bool = False) -> float:
    """Median device ms of ``fn()`` over ``reps`` runs after one warm-up,
    each timed with its own CUDA events; ``flush()`` runs before each, and
    with ``lead`` a device sleep first, so the events hold only device work."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if lead:
            torch.cuda._sleep(LEAD_SLEEP_CYCLES)
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


def budget_ms(fn, first_ms: float, reps: int = REQUEST_TIMING_REPS,
              budget_s: float = HOST_C_TIMING_BUDGET_S) -> tuple:
    """``(median host ms, runs)`` of ``fn()`` over ``reps`` runs, or as many
    as fit ``budget_s`` at ``first_ms`` a run; where none fits, the first
    (checked) run's ``first_ms`` is the one sample."""
    n = min(reps, int(budget_s * 1e3 // max(first_ms, 1e-3)))
    if n < 1:
        return first_ms, 1
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), n


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


def bitvector_tables(kbv, ir, dev) -> list:
    """K5's tables of ``ir`` on the card, in the wrapper's order."""
    arrays = kbv.bitvector_device_arrays(ir.materialize("bitvector"), dev)
    return [arrays[k] for k in ("entry_feat", "entry_key", "inv_mask", "init_mask",
                                "leaf_off", "leaf_fixed")]


def kernel_cases(ops, tt, ir, keys, dev) -> dict:
    """The kernel cases of step 5: K1, K2 and K3 at ROWS rows, then each at
    its SMALL_ROWS, then K5 (where the tree has it) at ROWS and its
    SMALL_ROWS, each ``name -> (kernel call, plain call, rows, impl)``.
    The kernel calls go through ``ops.tree_predict_integer`` with the
    tables on the card, the node quads packed once (a tree whose K3 takes
    no quads ignores them), and each tree's own CTA heuristic: entry points
    that this tree and older ones share."""
    import torch

    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def on_card(packed):
        return (as_t(packed.feature), as_t(packed.threshold_key), as_t(packed.left),
                as_t(packed.right), as_t(packed.leaf_fixed.view(np.int32)))

    lm, pad = on_card(ir.materialize("leaf_major")), on_card(ir.materialize("padded"))
    nint = as_t(ir.materialize("leaf_major").internal_counts.astype(np.int32))
    quads = (lambda t: {"quads": tt.pack_node_quads(*t[:4])}) \
        if hasattr(tt, "pack_node_quads") else (lambda t: {})
    lm_kw, pad_kw = dict(internal_counts=nint, **quads(lm)), quads(pad)
    plain_blocks = dict(block_b=128, block_t=1)  # the plain versions' padding
    cases = {}

    def add(name, impl, rows, tables, kw):
        x = keys[:rows]
        kernel = lambda: ops.tree_predict_integer(x, *tables, depth=ir.max_depth,
                                                  impl=impl, device=dev, **kw)
        if impl == "leaf_major":
            plain = lambda: tt.leaf_major_plain(x, *tables[:4], nint, tables[4],
                                                **plain_blocks)
        else:
            plain = lambda: getattr(tt, f"{impl}_plain")(x, *tables, depth=ir.max_depth,
                                                         **plain_blocks)
        cases[name] = (kernel, plain, rows, impl)

    inputs = {"leaf_major": (lm, lm_kw), "gather": (pad, pad_kw), "onehot": (pad, pad_kw)}
    for impl, (tables, kw) in inputs.items():
        add(impl, impl, ROWS, tables, kw)
    for impl, (tables, kw) in inputs.items():
        for rows in SMALL_ROWS[impl]:
            add(f"{impl}@{rows}", impl, rows, tables, kw)
    if importlib.util.find_spec("repro_torch.kernels.bitvector") is not None:
        kbv = importlib.import_module("repro_torch.kernels.bitvector")
        bv_tables = bitvector_tables(kbv, ir, dev)
        # K5 reads its tables packed once where this tree packs them
        k5_tables = [kbv.pack_bitvector_tables(*bv_tables, device=dev)] \
            if hasattr(kbv, "pack_bitvector_tables") else bv_tables
        for rows in (ROWS, *SMALL_ROWS["bitvector"]):
            x = keys[:rows]
            cases["bitvector" if rows == ROWS else f"bitvector@{rows}"] = (
                lambda x=x: kbv.tree_bitvector(x, *k5_tables),
                lambda x=x: kbv.bitvector_plain(x, *bv_tables), rows, "bitvector")
    return cases


def random_span_tables(seed: int, n_trees: int, n_slots: int, w32: int, n_features: int,
                       n_leaves: int, n_classes: int, n_rows: int = 97,
                       key_range: int = 7) -> tuple:
    """(the six dense K5 tables, int32 keys of ``n_rows`` rows), CPU
    tensors, whose clear sets are no leaf range: each slot clears random
    bits of a random span of words, with zero words inside the span; a tenth
    of the slots clear nothing and a tenth are padding (key INT32_MAX); keys
    lie in [-key_range, key_range); features stray outside [0, F), a
    twentieth of them below -F; tree 0 keeps no bit (leaf 32) and tree 1
    only its top bit; leaf rows stray past the table and below 0 (tree 2's
    offset is -L / 2, tree 3's -2 L)."""
    import torch

    rng = np.random.default_rng(seed)
    t, m, f = n_trees, n_slots, n_features
    feat = rng.integers(-2, f + 2, (t, m)).astype(np.int32)
    below = rng.random((t, m)) < 0.05
    feat[below] = rng.integers(-2 * f - 2, -f, int(below.sum()))
    key = rng.integers(-key_range, key_range, (t, m)).astype(np.int32)
    key[rng.random((t, m)) < 0.1] = np.iinfo(np.int32).max
    lo = rng.integers(0, w32, (t, m))
    hi = lo + 1 + (rng.integers(0, w32, (t, m)) % (w32 - lo))
    words = rng.integers(0, 2 ** 32, (t, m, w32), dtype=np.uint64).astype(np.uint32)
    col = np.arange(w32)
    inside = (col >= lo[..., None]) & (col < hi[..., None])
    inside &= rng.random((t, m, w32)) >= 0.3          # zero words inside spans
    inside &= (rng.random((t, m)) >= 0.1)[..., None]  # empty clear sets
    inv = np.where(inside, words, np.uint32(0))
    init = rng.integers(0, 2 ** 32, (t, w32), dtype=np.uint64).astype(np.uint32)
    init[0] = 0
    if t > 1:
        init[1] = 0
        init[1, -1] = np.uint32(1 << 31)
    off = rng.integers(-3, n_leaves, t).astype(np.int32)
    off[2:4] = (-(n_leaves // 2), -2 * n_leaves)[:max(0, t - 2)]
    leaf = rng.integers(0, 2 ** 32, (n_leaves, n_classes), dtype=np.uint64).astype(np.uint32)
    keys = rng.integers(-key_range, key_range, (n_rows, f)).astype(np.int32)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    u32 = lambda a: on(a.view(np.int32)).view(torch.uint32)
    return [on(feat), on(key), u32(inv), u32(init), on(off), u32(leaf)], on(keys)


def bitvector_work(ir, keys) -> tuple:
    """(bytes, operations, false pairs, ORs) of K5 on this run's rows: each
    input byte read once and the partials written once; a compare per (row,
    entry); for each (row, entry) whose compare is false, an OR of each
    nonzero word of the entry's clear set (a clear set is one leaf range, so
    most span one word); and an add per (row, tree, class).  The false pairs
    are counted from the data, each feature's keys sorted once."""
    import torch

    bv = ir.materialize("bitvector")
    b, w32 = keys.shape[0], 2 * bv.words
    cols = torch.sort(keys.t().contiguous(), dim=1).values
    nonzero_words = torch.from_numpy(
        ((~bv.thr_mask).view(np.uint32).reshape(-1, w32) != 0).sum(1)).to(keys.device)
    applied = ors = 0
    for f in range(bv.n_features):
        lo, hi = int(bv.feat_offsets[f]), int(bv.feat_offsets[f + 1])
        if hi > lo:
            thr = torch.from_numpy(bv.thr_key[lo:hi]).to(keys.device)
            false_rows = b - torch.searchsorted(cols[f], thr, right=True)
            applied += int(false_rows.sum())
            ors += int((false_rows * nonzero_words[lo:hi]).sum())
    m = int(np.bincount(bv.thr_tree, minlength=bv.n_trees).max()) if bv.total_entries else 0
    table_bytes = 4 * (2 * bv.n_trees * m + bv.n_trees * m * w32 + bv.n_trees * w32
                       + bv.n_trees + bv.leaf_fixed.size)
    nbytes = keys.numel() * 4 + table_bytes + b * bv.n_classes * 4
    ops = b * bv.total_entries + ors + b * bv.n_trees * bv.n_classes
    return nbytes, ops, applied, ors


def bitvector_exit_work(packed, dense, keys, chunk_rows: int = 4096,
                        sub_rows: int = 256) -> tuple:
    """(bytes, operations, compares, ORs) that K5's function needs on this
    run's rows where each (row, tree) takes its tree's words lowest first
    and stops at its exit word, the first word where a bit survives (the
    last word where none does): the records of higher words cannot change
    the result.  A compare per record (one nonzero mask word of an entry) in
    words up to the exit word, an OR per such record whose compare is false,
    and an add per (row, tree, class); each byte of the keys and of the
    packed tables read once and the partials written once.  The exit words
    come from the dense grid's cleared sets, built as the plain version
    builds them, ``chunk_rows`` rows at a time; features and leaf rows are
    indexed as jnp indexes them."""
    import torch

    feat, key, inv, init, _, leaf = dense
    b, f = keys.shape
    t, w32 = init.shape
    dev = keys.device
    wrap = lambda i: torch.where(i < 0, i + f, i).clamp(0, f - 1)
    feat, inv, init = wrap(feat.long()), inv.view(torch.int32), init.view(torch.int32)
    ws = packed.word_start.long()
    rec = packed.records.long()
    rec_tree = torch.repeat_interleave(torch.arange(t, device=dev), ws[:, -1] - ws[:, 0])
    rec_feat, rec_key, rec_word = wrap(rec[:, 0]), rec[:, 1], rec[:, 2]
    trees = torch.arange(t, device=dev)
    compares = ors = 0
    for r0 in range(0, b, chunk_rows):
        x = keys[r0:r0 + chunk_rows]
        cleared = torch.zeros((x.shape[0], t, w32), dtype=torch.int32, device=dev)
        for j in range(feat.shape[1]):
            cleared |= torch.where((x[:, feat[:, j]] > key[:, j])[:, :, None], inv[:, j], 0)
        live = (init & ~cleared) != 0
        exit_word = torch.where(live.any(-1), live.int().argmax(-1), w32 - 1)  # (rows, T)
        compares += int((ws[trees, exit_word + 1] - ws[:, 0]).sum())
        for s0 in range(0, x.shape[0], sub_rows):
            xs = x[s0:s0 + sub_rows]
            needed = rec_word <= exit_word[s0:s0 + sub_rows][:, rec_tree]
            ors += int((needed & (xs[:, rec_feat] > rec_key)).sum())
    nbytes = keys.numel() * 4 + packed.nbytes() + b * leaf.shape[1] * 4
    return nbytes, compares + ors + b * t * leaf.shape[1], compares, ors


def check_and_time(cases: dict, flush, tt) -> dict:
    """Each case against its plain version (tolerance 0: integer sums), then
    its device ms L2-flushed and warm and its plain version's ms; fails on a
    mismatch.  Each case keeps the CTA shape its kernel was launched at, as
    ``tt.LAUNCH_SHAPES`` recorded it (None for a tree without the record)."""
    import torch

    out = {}
    for name, (kernel, plain, rows, impl) in cases.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        shape = getattr(tt, "LAUNCH_SHAPES", {}).get(impl)
        err = max_abs_err(got, ref)
        print(f"kernel {name}: {rows} rows, max |kernel - plain| = {err} "
              f"(tolerance 0: integer sums), launched at {shape}")
        if err != 0:
            fail(f"kernel {name} disagrees with its plain version")
        out[name] = dict(max_abs_err=err, shape=shape,
                         ms=cuda_ms(kernel, KERNEL_TIMING_REPS, flush, lead=True),
                         warm_ms=cuda_ms(kernel, KERNEL_TIMING_REPS, lead=True),
                         plain_ms=cuda_ms(plain, PLAIN_TIMING_REPS, flush, lead=True))
        print(f"kernel {name}: {out[name]['ms']:.4f} ms L2-flushed, "
              f"{out[name]['warm_ms']:.4f} ms warm, plain {out[name]['plain_ms']:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# the gateway path
# ---------------------------------------------------------------------------

def gateway_workload(seed: int, n_requests: int = GATEWAY_REQUESTS):
    """(request rows, arrival seconds): sizes drawn from GATEWAY_ROWS, a
    GATEWAY_REPEAT_SHARE of requests repeating an earlier request's rows,
    Poisson arrivals at GATEWAY_RATE_PER_S."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice(GATEWAY_ROWS, n_requests, p=GATEWAY_ROW_SHARES)
    reqs = []
    for i, n in enumerate(sizes):
        if i and rng.random() < GATEWAY_REPEAT_SHARE:
            reqs.append(reqs[int(rng.integers(i))])
        else:
            reqs.append(rng.normal(0.0, 1.0, (int(n), N_FEATURES)).astype(np.float32))
    arrivals = np.cumsum(rng.exponential(1.0 / GATEWAY_RATE_PER_S, n_requests))
    return reqs, arrivals


def gateway_phase(forest_v1, forest_v2, seed: int, dev, card: str) -> dict:
    """Serve the seeded workload through two gateways over one registry at
    once, hot-swap to ``forest_v2`` halfway, hold every response against
    the reference walk of the version that served it, print each gateway's
    metrics, and return the kernel launches of the run."""
    import asyncio

    import torch
    from repro_torch.kernels import tree_traverse as tt
    from repro_torch.serve import Gateway, ModelRegistry, TreeEngine

    reg = ModelRegistry()
    versions = {1: reg.register_forest(MODEL_ID, forest_v1)}
    routes = {"A": "integer:cuda?autotune=true", "B": "integer:cuda@padded?impl=onehot"}
    gws = {name: Gateway(reg, route, max_batch_rows=GATEWAY_MAX_BATCH_ROWS,
                         max_delay_ms=2.0, max_queue_rows=1 << 22,
                         cache_rows=1 << 20, device=dev)
           for name, route in routes.items()}
    t0 = time.perf_counter()
    for gw in gws.values():  # autotunes A's CTA shape, then warms its buckets
        versions[1].engine(gw.spec, device=dev).warm(GATEWAY_MAX_BATCH_ROWS)
    torch.cuda.synchronize()
    print(f"gateway: warmed both routes in {time.perf_counter() - t0:.2f} s")
    reqs, arrivals = gateway_workload(seed + 2)
    swap_at = GATEWAY_REQUESTS // 2

    async def run():
        loop = asyncio.get_running_loop()
        start = loop.time()
        swap = []

        async def client(i):
            await asyncio.sleep(max(0.0, start + arrivals[i] - loop.time()))
            if i == swap_at:  # quantize v2 off the loop; the repoint is atomic
                swap.append(loop.run_in_executor(
                    None, reg.register_forest, MODEL_ID, forest_v2))
            version = reg.version(MODEL_ID)
            outs = await asyncio.gather(*[gw.submit(MODEL_ID, reqs[i])
                                          for gw in gws.values()])
            return version, outs

        results = await asyncio.gather(*[client(i) for i in range(GATEWAY_REQUESTS)])
        versions[2] = await swap[0]
        for gw in gws.values():
            await gw.close()
        return results, loop.time() - start

    tt.reset_launches()
    results, seconds = asyncio.run(run())
    torch.cuda.synchronize()
    gw_launches = dict(tt.LAUNCHES)
    rows = sum(len(x) for x in reqs)
    print(f"gateway path: {GATEWAY_REQUESTS} requests ({rows} rows) to each of 2 "
          f"gateways in {seconds:.3f} s, hot swap at request {swap_at}, kernel "
          f"launches {gw_launches}")

    # every response against the reference walk of v1 or v2 on the card
    all_rows = np.concatenate(reqs)
    offsets = np.cumsum([0] + [len(x) for x in reqs])
    expect = {v: TreeEngine(mv.packed, spec="integer:reference", device=dev)
              .predict_scores(all_rows) for v, mv in versions.items()}
    served = {name: {1: 0, 2: 0} for name in gws}
    for i, (version, outs) in enumerate(results):
        lo, hi = offsets[i], offsets[i + 1]
        for name, (scores, preds) in zip(gws, outs):
            match = [v for v in (1, 2) if np.array_equal(scores, expect[v][0][lo:hi])
                     and np.array_equal(preds, expect[v][1][lo:hi])]
            if not match:
                fail(f"gateway {name} request {i} ({hi - lo} rows) matches neither "
                     "version's reference")
            if version == 2 and match != [2]:
                fail(f"gateway {name} request {i} was submitted after the swap "
                     "but not served by v2")
            served[name][match[-1]] += 1
    print(f"gateway responses bit-identical to the reference walk of the version "
          f"that served them: {served}")

    for name, gw in gws.items():
        st = gw.stats()["per_model"][MODEL_ID]
        stage_ms = {k: h["mean"] for k, h in st["stages"].items()}
        print(f"{card} | gateway {name} {routes[name]}: p50 {st['p50_ms']:.3f} ms, "
              f"p99 {st['p99_ms']:.3f} ms, {st['rows_per_s']:.0f} rows/s, cache hit "
              f"rate {st['cache_hit_rate']:.4f}, batches {st['batches']}, occupancy "
              f"{st['batch_occupancy']:.1f} rows, tuned {st['tuned']}, tune ms "
              f"{st['compile_ms_by_bucket'].get('tune', 0.0):.1f}, stage ms means "
              + json.dumps({k: round(v, 4) for k, v in sorted(stage_ms.items())}))
    return gw_launches


def plan_gateway_phase(reg, mv, route: str, seed: int, dev, card: str,
                       plan_kwargs=None, label: str = "plan gateway",
                       after_warm=None, before_close=None) -> tuple:
    """Serve PLAN_GATEWAY_REQUESTS seeded requests for ``mv``'s model through
    one gateway over ``reg`` on ``route``, hold every response against the
    reference walk, check that the stats carry one label per shard, print
    the gateway's metrics, and return this process's kernel launches of the
    run and the model's gateway stats.  The warm's shard calls stay out of
    the stats; ``after_warm(engine, the warm's shard timings)`` runs after
    the warm and
    ``before_close(engine)`` after the last response, before the gateway
    closes its engines."""
    import asyncio

    import torch
    from repro_torch.kernels import tree_traverse as tt
    from repro_torch.serve import Gateway, TreeEngine

    gw = Gateway(reg, route, max_batch_rows=GATEWAY_MAX_BATCH_ROWS,
                 max_delay_ms=2.0, max_queue_rows=1 << 22, cache_rows=1 << 20, device=dev,
                 plan_kwargs=plan_kwargs)
    t0 = time.perf_counter()
    eng = mv.engine(gw.spec, device=dev, plan_kwargs=plan_kwargs)
    eng.warm(GATEWAY_MAX_BATCH_ROWS)
    torch.cuda.synchronize()
    warm_timings = eng.drain_shard_timings()
    print(f"{label}: warmed {route} in {time.perf_counter() - t0:.2f} s")
    if after_warm is not None:
        after_warm(eng, warm_timings)
    reqs, arrivals = gateway_workload(seed + 3, PLAN_GATEWAY_REQUESTS)

    async def run():
        loop = asyncio.get_running_loop()
        start = loop.time()

        async def client(i):
            await asyncio.sleep(max(0.0, start + arrivals[i] - loop.time()))
            return await gw.submit(mv.model_id, reqs[i])

        results = await asyncio.gather(*[client(i) for i in range(len(reqs))])
        seconds = loop.time() - start
        if before_close is not None:
            before_close(eng)
        await gw.close()
        return results, seconds

    tt.reset_launches()
    results, seconds = asyncio.run(run())
    torch.cuda.synchronize()
    launches = dict(tt.LAUNCHES)
    rows = sum(len(x) for x in reqs)
    print(f"{label} path: {len(reqs)} requests ({rows} rows) in {seconds:.3f} s, "
          f"kernel launches in this process {launches}")
    all_rows = np.concatenate(reqs)
    offsets = np.cumsum([0] + [len(x) for x in reqs])
    want = TreeEngine(mv.packed, spec="integer:reference", device=dev).predict_scores(all_rows)
    for i, (scores, preds) in enumerate(results):
        lo, hi = offsets[i], offsets[i + 1]
        if not (np.array_equal(scores, want[0][lo:hi]) and np.array_equal(preds, want[1][lo:hi])):
            fail(f"{label} request {i} ({hi - lo} rows) differs from the reference walk")
    print(f"{label} responses bit-identical to the reference walk: {len(reqs)}")
    st = gw.stats()["per_model"][mv.model_id]
    if len(st["shards"]) != 2:
        fail(f"{label} stats show shard labels {sorted(st['shards'])}, not two")
    stage_ms = {k: h["mean"] for k, h in st["stages"].items()}
    shard_ms = {k: round(v["ms_per_call"], 4) for k, v in st["shards"].items()}
    print(f"{card} | {label} {route}: p50 {st['p50_ms']:.3f} ms, "
          f"p99 {st['p99_ms']:.3f} ms, {st['rows_per_s']:.0f} rows/s, cache hit rate "
          f"{st['cache_hit_rate']:.4f}, batches {st['batches']}, occupancy "
          f"{st['batch_occupancy']:.1f} rows, shard ms per call {json.dumps(shard_ms)}, "
          "stage ms means " + json.dumps({k: round(v, 4) for k, v in sorted(stage_ms.items())}))
    return launches, st


# ---------------------------------------------------------------------------
# the deployment path: artifacts, the converter, the shard workers
# ---------------------------------------------------------------------------

def run_modules(commands: list, timeout: float = 600) -> list:
    """The stdout of each ``python -m <args>`` in ``commands``, all started
    together with the checkout's ``src`` on the path; fails the run on a
    non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, "-m", *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for args in commands]
    outs = []
    try:
        for args, proc in zip(commands, procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode:
                fail(f"python -m {' '.join(args)} exited {proc.returncode}: {err[-3000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def loopback_ms(payload: bytes, reps: int) -> float:
    """Median host ms to carry one frame of ``payload`` through a loopback
    TCP connection, from the send until the reader holds the whole frame:
    the transfer alone, without encoding or the worker's work."""
    import socket
    import threading

    from repro_torch.serve import wire

    server = socket.create_server(("127.0.0.1", 0))
    sender = socket.create_connection(server.getsockname())
    reader, _ = server.accept()
    try:
        def read_one(done):
            wire.read_frame(reader)
            done.append(time.perf_counter())

        times = []
        for _ in range(reps + 1):
            done = []
            thread = threading.Thread(target=read_one, args=(done,))
            thread.start()
            t0 = time.perf_counter()
            wire.send_frame(sender, wire.MSG_PREDICT, payload)
            thread.join()
            times.append((done[0] - t0) * 1e3)
        return statistics.median(times[1:])
    finally:
        for sock in (sender, reader, server):
            sock.close()


def span_records(span_dir: Path) -> dict:
    """Each worker's span records so far: ``{worker index: [record, ...]}``
    (``spawn_local_workers`` names worker ``i``'s file ``worker_<pid>_<i>``)."""
    return {int(f.stem.rsplit("_", 1)[1]):
            [json.loads(line) for line in f.read_text().splitlines()]
            for f in span_dir.glob("worker_*.jsonl")}


def settled_span_records(span_dir: Path, want: dict, timeout_s: float = 30.0) -> dict:
    """The span records once worker ``i`` has written ``want[i]`` of them, one
    per PREDICT it served.  A worker writes a request's record after it has
    sent the partials, so the reader polls; a shortfall at the timeout or a
    record beyond the requests fails the run."""
    deadline = time.monotonic() + timeout_s
    while True:
        recs = span_records(span_dir)
        got = {i: len(recs.get(i, ())) for i in set(want) | set(recs)}
        if any(got[i] > want.get(i, 0) for i in got):
            fail(f"the workers wrote span records {got} for requests {want}")
        if all(got[i] == want.get(i, 0) for i in got):
            return recs
        if time.monotonic() > deadline:
            fail(f"the workers wrote span records {got} in {timeout_s:.0f} s, "
                 f"for requests {want}")
        time.sleep(0.02)


def count_worker_calls(calls: dict, into: dict) -> dict:
    """Add each shard label's calls (``{"w<i>:<backend>[a:b]": calls}``) to
    ``into[i]``: the PREDICTs worker ``i`` served.  A worker that served two
    shards' labels fails the run, since each of the plan's two shards has
    its own worker."""
    workers = [int(label.split(":", 1)[0][1:]) for label in calls]
    if len(set(workers)) != len(workers):
        fail(f"a worker served another worker's shard: {sorted(calls)}")
    for i, (label, n) in zip(workers, calls.items()):
        into[i] = into.get(i, 0) + n
    return into


def check_remote_plan(eng, label: str) -> None:
    """Fail unless every worker of ``eng``'s remote plan is alive and no
    shard attempt was re-dispatched."""
    plan = eng.plan
    dead = [w["addr"] for w in plan.workers() if not w["alive"]]
    if plan.redispatches or dead:
        fail(f"{label}: {plan.redispatches} shard attempts re-dispatched, "
             f"workers evicted {dead}")


def worker_launches(before: dict, after: dict) -> dict:
    """``{worker index: {kernel: launches}}`` summed over each worker's records
    written between the two readings: each record counts the launches of its
    process since the record before, so these are the launches of the
    requests in between."""
    out = {}
    for name, recs in after.items():
        counts = {}
        for rec in recs[len(before.get(name, ())):]:
            for kernel, n in rec["launches"].items():
                counts[kernel] = counts.get(kernel, 0) + n
        out[name] = counts
    return out


def summed(per_worker: dict) -> dict:
    total = {}
    for counts in per_worker.values():
        for kernel, n in counts.items():
            total[kernel] = total.get(kernel, 0) + n
    return total


def deployment_phase(forest, ir, X, want, seed: int, dev, card: str,
                     after_convert=None) -> dict:
    """Steps 8 and 9: the artifacts, the routes served from the registered
    file, the remote routes and the remote gateway; ``after_convert()`` runs
    after the converter's runs, before the first timed request.  -> the
    kernel launches by path: this process's on the artifact routes, the
    workers' on the remote routes and on the remote gateway."""
    import torch
    from repro_torch.kernels import tree_traverse as tt
    from repro_torch.serve import ModelRegistry, wire
    from repro_torch.serve.worker import spawn_local_workers
    from repro_torch.trees.convert import _partials_digest
    from repro_torch.trees.io import forest_to_json

    def same(got, label):
        scores, preds = got
        if scores.shape != want[0].shape or not np.array_equal(scores, want[0]) \
                or not np.array_equal(preds, want[1]):
            fail(f"{label} differs from the reference walk of the in-memory forest")

    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    DEPLOY_DIR.mkdir(parents=True)
    procs = []
    try:
        # the workers start first: they load torch and the card while the
        # files are written
        t0 = time.perf_counter()
        span_dir = DEPLOY_DIR / "spans"
        procs, addrs = spawn_local_workers(REMOTE_WORKERS, span_dir=str(span_dir))
        print(f"deploy: {REMOTE_WORKERS} workers on the card listening at {addrs} after "
              f"{time.perf_counter() - t0:.2f} s")

        # 8a. JSON -> ITRF twice, each checked from a fresh process
        t0 = time.perf_counter()
        json_path = DEPLOY_DIR / "model.json"
        json_path.write_text(forest_to_json(forest))
        files = {"plain": DEPLOY_DIR / "plain.itrf", "packed": DEPLOY_DIR / "packed.itrf"}
        flags = {"plain": [], "packed": ["--strip-float", "--pack-leaves"]}
        outs = run_modules([["repro_torch.trees.convert", str(json_path), str(path),
                             *flags[name]] for name, path in files.items()])
        for (name, path), out in zip(files.items(), outs):
            print(f"deploy: convert {' '.join(flags[name]) or '(plain)'}: "
                  + " / ".join(out.strip().splitlines()))
            print(f"deploy: {name} artifact {path.stat().st_size} bytes "
                  f"(model JSON {json_path.stat().st_size} bytes)")
        expect = _partials_digest(ir, device=dev)
        outs = run_modules([["repro_torch.trees.convert", "--verify", str(path)]
                            for path in files.values()])
        for (name, path), out in zip(files.items(), outs):
            got = [ln.split()[1] for ln in out.splitlines() if ln.startswith("PARTIALS_SHA256 ")]
            if got != [expect]:
                fail(f"{name} artifact: fresh-process --verify digest {got} != in-process "
                     f"{expect}")
        print(f"deploy: both files' fresh-process --verify digests equal the in-process "
              f"digest {expect}; phase 8a {time.perf_counter() - t0:.2f} s")
        if after_convert is not None:
            after_convert()

        # 8b. the plain file registered by mmap, served through K1, K5 and
        # the packed_leaf reference walk
        t0 = time.perf_counter()
        reg = ModelRegistry()
        mv = reg.register_artifact(MODEL_ID, str(files["plain"]))
        engines, load_ms = {}, None
        for spec in DEPLOY_ROUTES:
            engines[spec] = mv.engine(spec, device=dev)
        tt.reset_launches()
        for spec, eng in engines.items():
            t1 = time.perf_counter()
            got = eng.predict_scores(X)
            first_ms = (time.perf_counter() - t1) * 1e3
            ledger = eng.drain_compile_timings()
            load_ms = ledger.get("load", load_ms)
            same(got, f"{spec} on the registered artifact")
            print(f"{card} | deploy: {spec} on the mmap-registered artifact, {ROWS} rows: "
                  f"bit-identical to the reference walk; first request {first_ms:.3f} ms")
        torch.cuda.synchronize()
        deploy_launches = dict(tt.LAUNCHES)
        builds = mv._build_ms
        print(f"{card} | deploy: register_artifact load {load_ms:.3f} ms (mmap); engine "
              "builds ms " + json.dumps({k: round(v, 3) for k, v in sorted(builds.items())})
              + f"; kernel launches {deploy_launches}; phase 8b "
              f"{time.perf_counter() - t0:.2f} s")
        if not deploy_launches["leaf_major"] or not deploy_launches["bitvector"]:
            fail("the artifact routes did not launch K1 and K5")

        # 8c. the remote routes on two loopback workers on the card, over the
        # stripped file (HELLO ships its image) and the plain one (arrays)
        t0 = time.perf_counter()
        versions = {"packed": reg.register_artifact("packed", str(files["packed"])),
                    "plain": mv}
        kw = {"workers": addrs}
        served = {i: 0 for i in range(REMOTE_WORKERS)}
        before = settled_span_records(span_dir, served)
        for name, version in versions.items():
            for spec in REMOTE_ROUTES:
                t1 = time.perf_counter()
                eng = version.engine(spec, device=dev, plan_kwargs=kw)
                hello = eng.plan.hello_format
                if hello != ("itrf" if name == "packed" else "arrays"):
                    fail(f"{spec} on the {name} artifact sent a HELLO of {hello}")
                setup_ms = eng.drain_compile_timings()["remote"]
                same(eng.predict_scores(X), f"{spec} on the {name} artifact")
                warm_s = time.perf_counter() - t1
                count_worker_calls({k: v[1] for k, v in eng.drain_shard_timings().items()},
                                   served)
                ms = host_ms(lambda: eng.predict_scores(X), REQUEST_TIMING_REPS)
                timed = eng.drain_shard_timings()
                count_worker_calls({k: v[1] for k, v in timed.items()}, served)
                check_remote_plan(eng, f"{spec} on the {name} artifact")
                shard = {k: round(v[0] / v[1], 3) for k, v in timed.items()}
                print(f"{card} | request {spec} on the {name} artifact (HELLO {hello}, "
                      f"setup {setup_ms:.1f} ms, first request and setup {warm_s:.2f} s): "
                      f"{ROWS} rows {ms:.3f} ms median of {REQUEST_TIMING_REPS} after a "
                      f"warm request, host clock; shard round trips ms "
                      + json.dumps(shard))
        base = mv.engine(REMOTE_BASELINE, device=dev)
        same(base.predict_scores(X), REMOTE_BASELINE)
        ms = host_ms(lambda: base.predict_scores(X), REQUEST_TIMING_REPS)
        print(f"{card} | request {REMOTE_BASELINE} in process (beside the remote routes): "
              f"{ROWS} rows {ms:.3f} ms median of {REQUEST_TIMING_REPS}, host clock")
        after = settled_span_records(span_dir, served)
        remote = worker_launches(before, after)
        spans = {}
        for recs in after.values():
            for rec in recs[-REQUEST_TIMING_REPS:]:
                for sp in rec["spans"]:
                    spans.setdefault(sp["name"], []).append(sp["dur_us"] / 1e3)
        encode_ms = host_ms(lambda: wire.encode_predict(1, 0, X), REQUEST_TIMING_REPS)
        send_ms = loopback_ms(wire.encode_predict(1, 0, X), REQUEST_TIMING_REPS)
        print(f"deploy: remote routes, kernel launches in the workers {remote}; the "
              f"workers' spans of {REMOTE_ROUTES[-1]} on the plain artifact, ms medians: "
              + json.dumps(
                  {k: round(statistics.median(v), 3) for k, v in sorted(spans.items())})
              + f"; one PREDICT of {ROWS} x {N_FEATURES} rows: encoding {encode_ms:.3f} ms, "
              f"the frame through loopback {send_ms:.3f} ms (medians, host clock); "
              f"phase 8c {time.perf_counter() - t0:.2f} s")
        for i, counts in remote.items():
            if not any(counts.values()):
                fail(f"worker {i} launched no kernel on the remote routes")
        if not summed(remote)["leaf_major"] or not summed(remote)["bitvector"]:
            fail("the remote routes did not launch K1 and K5 in the workers")

        # 8d. the host-C remote route over the plain file: worker 0 runs K1
        # on the first half of the trees, worker 1 builds the C table walk of
        # the second half on its host at its first PREDICT and serves it
        t0 = time.perf_counter()
        before_c = settled_span_records(span_dir, served)
        eng = mv.engine(HOST_C_REMOTE_ROUTE, device=dev, plan_kwargs=kw)
        same(eng.predict_scores(X), f"{HOST_C_REMOTE_ROUTE} on the plain artifact")
        build_s = time.perf_counter() - t0
        first = eng.drain_shard_timings()
        labels = sorted(first)
        count_worker_calls({k: v[1] for k, v in first.items()}, served)
        t1 = time.perf_counter()
        same(eng.predict_scores(X), f"{HOST_C_REMOTE_ROUTE} on the plain artifact")
        ms, runs = budget_ms(lambda: eng.predict_scores(X), (time.perf_counter() - t1) * 1e3)
        timed = eng.drain_shard_timings()
        count_worker_calls({k: v[1] for k, v in timed.items()}, served)
        check_remote_plan(eng, HOST_C_REMOTE_ROUTE)
        host_c = worker_launches(before_c, settled_span_records(span_dir, served))
        half = N_TREES // 2
        if labels != [f"w0:cuda[0:{half}]", f"w1:native_c_table[{half}:{N_TREES}]"]:
            fail(f"{HOST_C_REMOTE_ROUTE}: shard labels {labels}")
        if not host_c.get(0, {}).get("leaf_major") or any(host_c.get(1, {}).values()):
            fail(f"{HOST_C_REMOTE_ROUTE}: worker launches {host_c}; worker 0 must launch "
                 "K1 and worker 1, on the host C shard, nothing")
        shard = {k: round(v[0] / v[1], 3) for k, v in timed.items()}
        print(f"{card} | request {HOST_C_REMOTE_ROUTE} on the plain artifact: {ROWS} rows "
              f"bit-identical to the reference walk (first request with worker 1's C build "
              f"{build_s:.2f} s); {ms:.3f} ms median of {runs} run(s), host clock; shard "
              f"round trips ms {json.dumps(shard)}; kernel launches in the workers "
              f"{host_c}; phase 8d {time.perf_counter() - t0:.2f} s")

        # 9. the remote gateway
        # the baseline of the workers' records is read after the warm, so
        # the warm's launches are not the gateway's
        t0 = time.perf_counter()
        marks = {}

        def after_warm(eng, warm_timings):
            count_worker_calls({k: v[1] for k, v in warm_timings.items()}, served)
            marks["before"] = settled_span_records(span_dir, served)

        local, st = plan_gateway_phase(
            reg, versions["packed"], REMOTE_GATEWAY_ROUTE, seed, dev, card,
            plan_kwargs=kw, label="remote gateway", after_warm=after_warm,
            before_close=lambda eng: check_remote_plan(eng, "the remote gateway"))
        count_worker_calls({k: v["calls"] for k, v in st["shards"].items()}, served)
        gateway = worker_launches(marks["before"], settled_span_records(span_dir, served))
        print(f"remote gateway: {st['batches']} batches, PREDICTs per shard label "
              + json.dumps({k: v["calls"] for k, v in sorted(st["shards"].items())})
              + f", kernel launches in the workers {gateway}; phase 9 "
              f"{time.perf_counter() - t0:.2f} s")
        if any(local.values()):
            fail(f"the remote gateway launched kernels in this process: {local}")
        for i, counts in gateway.items():
            if not any(counts.values()):
                fail(f"worker {i} launched no kernel on the remote gateway")
        for version in versions.values():
            version.release()
        return {"deploy": deploy_launches, "remote_workers": summed(remote),
                "remote_host_c_workers": summed(host_c),
                "remote_gateway_workers": summed(gateway)}
    finally:
        for p in procs:
            p.kill()
            p.wait()
            if p.stdout is not None:
                p.stdout.close()
        shutil.rmtree(DEPLOY_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# the host-C phase: emitted C on the host CPU, alone and beside K1 and K5
# ---------------------------------------------------------------------------

def c_backends(eng) -> list:
    """The host-C shard backends of ``eng``'s plan."""
    from repro_torch.backends import CompiledCBackend

    return [b for b in eng.plan.backends if isinstance(b, CompiledCBackend)]


def start_c_builds(engines: dict, pool) -> dict:
    """Start building every host-C library of ``engines`` on ``pool``
    (``simd_isa()`` builds on its first call; gcc runs outside the
    interpreter lock); -> ``{route: [future of each C shard's ISA]}``."""
    return {spec: [pool.submit(b.simd_isa) for b in c_backends(eng)]
            for spec, eng in engines.items()}


def finish_c_builds(futures: dict, engines: dict) -> None:
    """Wait for the builds of :func:`start_c_builds` and print each
    library's source bytes, emit and gcc seconds and dispatched ISA; a
    library that did not build fails the run."""
    for spec, futs in futures.items():
        for b, fut in zip(c_backends(engines[spec]), futs):
            isa = fut.result()
            info = b.build_info
            if isa is None or not info:
                fail(f"{spec}: the {b.name} library did not build")
            print(f"host C build {spec} [{b.name}, {b.packed.n_trees} trees]: source "
                  f"{info['source_bytes']} bytes, emit {info['emit_s']:.2f} s, gcc -O2 "
                  f"{info['compile_s']:.2f} s, simd_isa {isa}")


def check_c_request(eng, label: str, rows, want_partials, want_scores, mode: str,
                    n_trees: int, scale: int) -> tuple:
    """One checked request: ``eng``'s partials against ``want_partials`` and
    their finalize against ``want_scores`` (scores, preds), tolerance 0;
    -> (host ms of the checked partials call, partials)."""
    from repro_torch.core.ensemble import finalize_partials

    t0 = time.perf_counter()
    partials = eng.predict_partials(rows)
    first_ms = (time.perf_counter() - t0) * 1e3
    n = len(rows)
    if partials.dtype != np.uint32 or not np.array_equal(partials, want_partials[:n]):
        fail(f"{label} on {n} rows: partials differ from the reference walk's")
    scores, preds = finalize_partials(mode, partials, n_trees, scale)
    if not (np.array_equal(scores, want_scores[0][:n])
            and np.array_equal(preds, want_scores[1][:n])):
        fail(f"{label} on {n} rows: scores differ from the reference walk's")
    return first_ms, partials


def start_if_else_builds(ir, dev) -> tuple:
    """Start building the if-else C of the first IF_ELSE_TREES trees on two
    threads, at the run's beginning: they take the longest of the host-C
    builds and run outside the interpreter lock while the card phases run.
    -> (the subset, its engines, their build futures, the pool)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serve import TreeEngine

    sub = ir.subset(0, IF_ELSE_TREES)
    engines = {spec: TreeEngine(sub, spec=spec, device=dev) for spec in IF_ELSE_ROUTES}
    pool = ThreadPoolExecutor(max_workers=len(engines))
    return sub, engines, start_c_builds(engines, pool), pool


def start_host_c_builds(ir, dev) -> dict:
    """Build the engines of the host-C phase and start building their C
    libraries on one thread per core (:func:`finish_host_c_builds` waits).
    The deployment phase starts them before its converter runs and waits for
    them before its first timed request."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serve import ModelRegistry, TreeEngine

    t0 = time.perf_counter()
    reg = ModelRegistry()
    mv = reg.register_packed(MODEL_ID, ir)
    routes = (*HOST_C_ROUTES, *HOST_C_KNOB_ROUTES, *HOST_C_MIXED)
    engines = {spec: TreeEngine(ir, spec=spec, device=dev) for spec in routes}
    engines[HOST_C_GATEWAY_ROUTE] = mv.engine(HOST_C_GATEWAY_ROUTE, device=dev)
    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 4)
    return {"reg": reg, "mv": mv, "engines": engines, "pool": pool, "t0": t0,
            "futures": start_c_builds(engines, pool)}


def finish_host_c_builds(builds: dict) -> None:
    finish_c_builds(builds["futures"], builds["engines"])
    builds["pool"].shutdown(wait=True)
    print(f"host C: {sum(len(f) for f in builds['futures'].values())} libraries built on "
          f"{os.cpu_count()} threads, {time.perf_counter() - builds['t0']:.2f} s from the "
          "start of their engines")


def host_c_phase(ir, X, want: dict, ref_partials, builds: dict, if_else: tuple,
                 seed: int, dev, card: str) -> dict:
    """Step 10: the emitted-C routes at full width, the if-else C on its
    subset, the mixed routes beside K1 and K5, the gateway on a mixed route
    and the autotuned C route read back from an artifact.  ``want`` maps
    each mode to the reference walk's (scores, preds) of ``X``,
    ``ref_partials`` are its partials, ``builds`` is what
    :func:`start_host_c_builds` started and ``if_else`` what
    :func:`start_if_else_builds` started at the run's beginning.  The three
    requests that take seconds (the C bitvector scorer on 65,536 rows in
    both modes and beside K5) run at once on threads, each one checked run,
    while the autotune step runs.  -> this process's kernel launches on the
    mixed routes and the gateway."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.kernels import tree_traverse as tt
    from repro_torch.serve import TreeEngine

    t_phase = time.perf_counter()
    print(f"{card} | host CPU {host_cpu()}")
    reg, mv, engines = builds["reg"], builds["mv"], builds["engines"]
    sub, if_engines, if_futures, if_pool = if_else
    shutil.rmtree(HOST_C_DIR, ignore_errors=True)
    HOST_C_DIR.mkdir(parents=True)
    try:
        finish_c_builds(if_futures, if_engines)
        if_pool.shutdown(wait=True)

        def timed(spec, eng, n, first_ms, what="bit-identical to the reference walk"):
            ms, runs = budget_ms(lambda: eng.predict_scores(X[:n]), first_ms)
            print(f"{card} | host C request {spec} ({eng.simd_isa()}): {n} rows {what}; "
                  f"{ms:.3f} ms median of {runs} run(s), host clock")

        # 10a. the table walk and bitvector C at full width, and their knobs,
        # each request checked and timed alone
        heavy = [(spec, ROWS) for spec in HOST_C_ROUTES if "bitvector" in spec]
        rows_by_route = {spec: HOST_C_ROWS for spec in HOST_C_ROUTES}
        rows_by_route.update({spec: (HOST_C_KNOB_ROWS,) for spec in HOST_C_KNOB_ROUTES})
        for spec, counts in rows_by_route.items():
            eng, mode = engines[spec], spec.split(":")[0]
            for n in counts:
                if (spec, n) in heavy:
                    continue
                first_ms, _ = check_c_request(eng, spec, X[:n], ref_partials, want[mode],
                                              mode, ir.n_trees, ir.scale)
                timed(spec, eng, n, first_ms)

        # 10b. the if-else C on its subset: integer exact, float within
        # IF_ELSE_FLOAT_TOL with equal predictions
        print(f"host C: {'/'.join(IF_ELSE_ROUTES)} run on the first {sub.n_trees} of "
              f"{ir.n_trees} trees: gcc -O2 on the if-else C of the full model would not "
              "finish inside a run (24 s for 8 of these trees, 269 s for 32, on an 8-core "
              "x86 host)")
        sub_int = TreeEngine(sub, spec="integer:reference", device=dev)
        sub_want = {"integer": sub_int.predict_scores(X),
                    "float": TreeEngine(sub, spec="float:reference", device=dev)
                    .predict_scores(X)}
        sub_partials = sub_int.predict_partials(X)
        for spec in IF_ELSE_ROUTES:
            eng, mode = if_engines[spec], spec.split(":")[0]
            for n in IF_ELSE_ROWS:
                if mode == "integer":
                    first_ms, _ = check_c_request(eng, spec, X[:n], sub_partials,
                                                  sub_want[mode], mode, sub.n_trees,
                                                  sub.scale)
                    what = (f"of {sub.n_trees} trees bit-identical to the reference walk "
                            "of that subset")
                else:
                    t0 = time.perf_counter()
                    scores, preds = eng.predict_scores(X[:n])
                    first_ms = (time.perf_counter() - t0) * 1e3
                    want_s, want_p = sub_want[mode]
                    err = float(np.abs(scores - want_s[:n]).max())
                    if scores.dtype != np.float32 or err > IF_ELSE_FLOAT_TOL \
                            or not np.array_equal(preds, want_p[:n]):
                        fail(f"{spec} on {n} rows: scores {err} from the float reference "
                             f"walk (tolerance {IF_ELSE_FLOAT_TOL}) or predictions differ")
                    what = (f"of {sub.n_trees} trees: predictions equal the float "
                            f"reference walk's, max |scores - reference| {err!r} "
                            f"(tolerance {IF_ELSE_FLOAT_TOL})")
                timed(spec, eng, n, first_ms, what)

        # 10c. cuda|native_c_table beside K1, checked and timed alone, with
        # the launch counters read around its checked request
        mixed_launches = {}

        def mixed_check(spec):
            eng = engines[spec]
            first_ms, _ = check_c_request(eng, spec, X, ref_partials, want["integer"],
                                          "integer", ir.n_trees, ir.scale)
            return first_ms

        def read_launches(spec):
            torch.cuda.synchronize()
            launches = dict(tt.LAUNCHES)
            if not launches[HOST_C_MIXED[spec]]:
                fail(f"{spec} did not launch kernel {HOST_C_MIXED[spec]}")
            for k, v in launches.items():
                mixed_launches[k] = mixed_launches.get(k, 0) + v
            return launches

        def shard_ms(eng):
            return json.dumps({k: round(v[0] / v[1], 3)
                               for k, v in eng.drain_shard_timings().items()})

        table_mixed = next(spec for spec in HOST_C_MIXED if "native_c_table" in spec)
        eng = engines[table_mixed]
        tt.reset_launches()
        first_ms = mixed_check(table_mixed)
        launches = read_launches(table_mixed)
        ms, runs = budget_ms(lambda: eng.predict_scores(X), first_ms)
        print(f"{card} | host C request {table_mixed}: {ROWS} rows bit-identical to the "
              f"reference walk, kernel launches {launches}; {ms:.3f} ms median of {runs} "
              f"run(s), host clock; shard ms per call {shard_ms(eng)}")

        # 10d. the three requests that take seconds, at once on threads (one
        # checked run each), beside the autotune step
        bv_mixed = next(spec for spec in HOST_C_MIXED if "native_c_bitvector" in spec)
        tt.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(heavy) + 1) as pool:
            futs = {spec: pool.submit(check_c_request, engines[spec], spec, X, ref_partials,
                                      want[spec.split(":")[0]], spec.split(":")[0],
                                      ir.n_trees, ir.scale)
                    for spec, _ in heavy}
            futs[bv_mixed] = pool.submit(mixed_check, bv_mixed)
            tuned = autotune_step(ir, X, dev, card)
            results = {spec: fut.result() for spec, fut in futs.items()}
        launches = read_launches(bv_mixed)
        note = (f", one checked run at once with {len(results) - 1} others and the autotune "
                "step")
        for spec, _ in heavy:
            first_ms = results[spec][0]
            print(f"{card} | host C request {spec} ({engines[spec].simd_isa()}): {ROWS} rows "
                  f"bit-identical to the reference walk; {first_ms:.3f} ms{note}, host clock")
        print(f"{card} | host C request {bv_mixed}: {ROWS} rows bit-identical to the "
              f"reference walk, kernel launches {launches}; {results[bv_mixed]:.3f} ms{note}, "
              f"host clock; shard ms per call {shard_ms(engines[bv_mixed])}; step "
              f"{time.perf_counter() - t0:.2f} s")

        # 10e. the plan gateway on a mixed route: the isa column names the
        # C shard's ISA
        gw_launches, st = plan_gateway_phase(reg, mv, HOST_C_GATEWAY_ROUTE, seed, dev, card,
                                             label="host C gateway")
        if st["isa"] in (None, "-") or st["isa"] != engines[HOST_C_GATEWAY_ROUTE].simd_isa():
            fail(f"the host C gateway's isa column reads {st['isa']!r}")
        if gw_launches["leaf_major"] + gw_launches["gather"] == 0:
            fail("the host C gateway did not launch K1 or K2 for its card shard")
        print(f"host C gateway: isa column {st['isa']}, kernel launches {gw_launches}")
        for eng in (*engines.values(), *if_engines.values(), *tuned):
            eng.close()
        mv.release()
        print(f"host C phase: {time.perf_counter() - t_phase:.2f} s")
        return {"mixed": mixed_launches, "gateway": gw_launches}
    finally:
        shutil.rmtree(HOST_C_DIR, ignore_errors=True)


def autotune_step(ir, X, dev, card: str) -> tuple:
    """The autotuned C route on the first TUNE_TREES trees: tuned at warm,
    its winner exported to an ITRF file under the CPU's host key and read
    back from it by a fresh registry, which serves without measuring.
    -> the two engines."""
    from repro_torch.ir.artifact import host_isa_key, inspect_itrf
    from repro_torch.serve import ModelRegistry, TreeEngine

    t0 = time.perf_counter()
    path = str(HOST_C_DIR / "tune.itrf")
    ir.subset(0, TUNE_TREES).to_itrf(path)
    reg = ModelRegistry()
    mv = reg.register_artifact("tune", path)
    eng = mv.engine(TUNE_ROUTE, device=dev)
    eng.warm(256)
    tune_ms = eng.drain_compile_timings().get("tune")
    reg.export_tuned("tune", path)
    host = f"torch-cpu:{host_isa_key()}"
    hosts = inspect_itrf(path)["tuned_hosts"]
    back = ModelRegistry().register_artifact("tune", path)
    beng = back.engine(TUNE_ROUTE, device=dev)
    beng.warm(256)
    if eng.tuned_config is None or hosts != [host] or back._tuned != mv._tuned \
            or [k[4] for k in back._tuned] != ["cpu"] \
            or beng.tuned_config != eng.tuned_config \
            or "tune" in beng.drain_compile_timings():
        fail(f"{TUNE_ROUTE}: winner {eng.tuned_config} under {hosts}, read back "
             f"{back._tuned} as {beng.tuned_config}")
    want = TreeEngine(back.packed, spec="integer:reference", device=dev).predict_scores(X)
    got = beng.predict_scores(X)
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        fail(f"{TUNE_ROUTE} read back from the artifact differs from the reference walk")
    print(f"{card} | host C autotune {TUNE_ROUTE} on {TUNE_TREES} trees: winner "
          f"{eng.tuned_config} ({eng.simd_isa()}) measured in {tune_ms:.1f} ms, written "
          f"under {hosts[0]} and read back without measuring; {ROWS} rows bit-identical; "
          f"step {time.perf_counter() - t0:.2f} s")
    return eng, beng


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernels-only", action="store_true",
                        help="only check and time the kernel cases of step 5")
    parser.add_argument("--src", type=Path, default=SRC,
                        help="the src directory to take repro_torch from "
                             "(with --kernels-only)")
    args = parser.parse_args()

    src = args.src.resolve()
    if src != SRC and not args.kernels_only:
        fail("--src takes another tree's kernels only with --kernels-only", code=2)
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"no repro_torch under {src}; run {Path(__file__).name} from the root "
             "of a checkout", code=2)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, str(src))
    from repro_torch.core.ensemble import finalize_partials
    from repro_torch.core.flint import float_to_key
    from repro_torch.kernels import _build, ops, tree_traverse as tt
    from repro_torch.kernels.ref import tree_predict_integer_ref
    from repro_torch.serve import ModelRegistry, TreeEngine

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; "
          f"repro_torch from {src}")

    # 1. build the kernels
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.2f} s)")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line
                                     or "Function properties" in line
                                     or "Compiling entry" in line):
            print("  " + line.strip())
        elif "bytes stack frame" in line:
            print("  " + line.strip())

    # 2. the model
    t0 = time.perf_counter()
    forest, ir, X = build_model(args.seed)
    print(f"model: {ir.n_trees} trees, depth {ir.max_depth}, {ir.n_features} "
          f"features, {ir.n_classes} classes, {ir.total_nodes} nodes; built and "
          f"quantized in {time.perf_counter() - t0:.2f} s")
    keys = float_to_key(torch.from_numpy(X).to(dev))
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.fill_(1)

    if args.kernels_only:
        times = check_and_time(kernel_cases(ops, tt, ir, keys, dev), flush, tt)
        print(card)
        print(json.dumps({"kernel_times": times, "src": str(src)}))
        return
    if_else = start_if_else_builds(ir, dev)

    # 3. the main path, with the launch counters read around it
    routes = ("integer:cuda@leaf_major", "flint:cuda@leaf_major",
              "integer:cuda@padded", "integer:bitvector", "flint:bitvector",
              *PLAN_ROUTES)
    t0 = time.perf_counter()
    engines = {spec: TreeEngine(ir, spec=spec) for spec in routes}
    print(f"engines of {len(routes)} routes built in {time.perf_counter() - t0:.2f} s "
          "(the bitvector tables materialized from the IR)")
    requests = [("integer:cuda@leaf_major", X)]
    requests += [("integer:cuda@leaf_major", X[:n]) for n in SMALL_REQUESTS]
    requests += [("flint:cuda@leaf_major", X), ("integer:cuda@padded", X)]
    requests += [("integer:bitvector", X[:n]) for n in BITVECTOR_REQUESTS]
    requests += [("flint:bitvector", X)] + [(spec, X) for spec in PLAN_ROUTES]
    tt.reset_launches()
    results = [engines[spec].predict_scores(rows) for spec, rows in requests]
    torch.cuda.synchronize()
    launches = dict(tt.LAUNCHES)
    print(f"main path: {len(requests)} requests, kernel launches {launches}")
    for name in ("leaf_major", "gather", "bitvector"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
    for spec in PLAN_ROUTES:
        plan = engines[spec].plan
        print(f"  {spec}: plan {plan.name}, shards "
              f"{[b.name for b in plan.backends]} over {plan.describe()['shards']}")

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
        print(f"  {spec:<40} {len(rows):>6} rows: bit-identical to {mode}:reference")

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

    # 4c and 5. each kernel against its plain version at the main path's
    # shapes, its times, and the CTA shape it was launched at
    cases = kernel_cases(ops, tt, ir, keys, dev)
    measured = check_and_time(cases, flush, tt)
    # K3's own function: every read outside its table reads 0, on the
    # walk's every variant (walks per thread, staged or not)
    bad = [torch.from_numpy(a).to(dev) for a in malformed_tables(ir.materialize("padded"))]
    bad_quads = tt.pack_node_quads(*bad[:4])
    errs = {}
    for depth in (ir.max_depth + 1, ir.max_depth + 2):
        for bb, bt in ((128, 1), (64, 3)):
            ref = tt.onehot_plain(keys[:300], *bad, depth=depth, block_b=bb, block_t=bt)
            for walks in (1, 2, 4):
                for stage_x in (True, False):
                    out = tt.tree_traverse_onehot(keys[:300], bad_quads, bad[4], depth=depth,
                                                  block_b=bb, block_t=bt, _walks=walks,
                                                  _stage_x=stage_x)
                    torch.cuda.synchronize()
                    errs[(depth, bb, bt, walks, stage_x)] = max_abs_err(out, ref)
    print(f"kernel onehot on malformed tables (child >= N, child < 0, feature >= F), "
          f"{len(errs)} launches over depths, CTA shapes, walks 1/2/4, staged and not: "
          f"max |kernel - plain| = {max(errs.values())}")
    if any(errs.values()):
        fail("kernel onehot disagrees with its plain version on a malformed table: "
             + str({k: v for k, v in errs.items() if v}))
    # K5 on a forest whose bitvectors are wider than the model's 32 words
    kbv = importlib.import_module("repro_torch.kernels.bitvector")
    wide_ir, wide_x = wide_forest(args.seed + 4)
    wide_keys = float_to_key(torch.from_numpy(wide_x).to(dev))
    wide_tables = bitvector_tables(kbv, wide_ir, dev)
    wide_out = kbv.tree_bitvector(wide_keys, kbv.pack_bitvector_tables(*wide_tables,
                                                                       device=dev))
    torch.cuda.synchronize()
    wide_shape = tt.LAUNCH_SHAPES["bitvector"]
    wide_err = max_abs_err(wide_out, kbv.bitvector_plain(wide_keys, *wide_tables))
    print(f"kernel bitvector on a multi-word forest (chains of {WIDE_CHAINS} splits, "
          f"W32 = {2 * wide_ir.materialize('bitvector').words}), {WIDE_ROWS} rows: "
          f"max |kernel - plain| = {wide_err}, launched at {wide_shape}")
    if wide_err:
        fail("kernel bitvector disagrees with its plain version on the multi-word forest")
    # K5 on random clear sets that are no leaf range, at its own CTA shape
    # and pinned ones
    span_errs = {}
    for w32 in SPAN_WIDTHS:
        dense, span_keys = random_span_tables(
            args.seed + 5 + w32, SPAN_TREES, SPAN_SLOTS, w32, SPAN_FEATURES, 64 * w32,
            N_CLASSES, SPAN_ROWS, SPAN_KEYS)
        dense, span_keys = [a.to(dev) for a in dense], span_keys.to(dev)
        ref = kbv.bitvector_plain(span_keys, *dense)
        packed = kbv.pack_bitvector_tables(*dense, device=dev)
        for shape in SPAN_SHAPES:
            out = kbv.tree_bitvector(span_keys, packed, **shape)
            torch.cuda.synchronize()
            launched = tt.LAUNCH_SHAPES["bitvector"]
            span_errs[(w32, launched["block_b"], launched["block_t"], launched["splits"],
                       launched["staged_records"])] = max_abs_err(out, ref)
    print(f"kernel bitvector on random clear sets (multi-word spans with zero words "
          f"inside, W32 = {SPAN_WIDTHS}), {len(span_errs)} launches over CTA shapes "
          f"(W32, rows, trees, splits, staged records) {sorted(span_errs)}: "
          f"max |kernel - plain| = {max(span_errs.values())}")
    if any(span_errs.values()):
        fail("kernel bitvector disagrees with its plain version on random clear sets: "
             + str({k: v for k, v in span_errs.items() if v}))

    # the bounds at the main path's shape
    lm_tables = [lm.feature, lm.threshold_key, lm.left, lm.right, lm.leaf_fixed]
    table_bytes = sum(a.size * 4 for a in lm_tables)
    io_bytes = keys.numel() * 4 + ROWS * N_CLASSES * 4
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    steps = {
        "leaf_major": leaf_major_steps(keys, *(on(a) for a in lm_tables[:4]),
                                       on(lm.internal_counts.astype(np.int32))),
        "gather": ROWS * N_TREES * ir.max_depth,
        "onehot": ROWS * N_TREES * ir.max_depth,
    }
    rows_out = {}
    for name in ("leaf_major", "gather", "onehot"):
        nbytes = table_bytes + io_bytes + (N_TREES * 4 if name == "leaf_major" else 0)
        # per walk step: the key compare, the child select and the loop's
        # own compare (K3 adds its node and feature range checks); per
        # (row, tree): one add per class
        n_ops = (5 if name == "onehot" else 3) * steps[name] + ROWS * N_TREES * N_CLASSES
        bound_ms, bound_by = bound(nbytes, n_ops)
        small = {f"{name}@{r}": measured[f"{name}@{r}"] for r in SMALL_ROWS[name]}
        print(f"kernel {name}: bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, "
              f"{n_ops} ops, {steps[name]} walk steps); no single PyTorch call computes "
              "this function, so there is no library time")
        rows_out[name] = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], max_abs_err=measured[name]["max_abs_err"],
            ms=measured[name]["ms"], warm_ms=measured[name]["warm_ms"],
            plain_ms=measured[name]["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, shape=measured[name]["shape"], small_batches=small)
    dense = bitvector_tables(kbv, ir, dev)
    dense_bytes = sum(a.numel() * 4 for a in dense)
    packed = kbv.pack_bitvector_tables(*dense, device=dev)
    print(f"kernel bitvector tables: {packed.records.shape[0]} records, {packed.nbytes()} "
          f"bytes packed, against {dense_bytes} bytes of the dense slot grid")
    # the bound: what this run's data needs with the scan stopping at each
    # (row, tree)'s exit word; beside it the count over every entry
    nbytes, n_ops, compares, ors = bitvector_exit_work(packed, dense, keys)
    bound_ms, bound_by = bound(nbytes, n_ops)
    all_bytes, all_ops, applied, all_ors = bitvector_work(ir, keys)
    all_ms, all_by = bound(all_bytes, all_ops)
    print(f"kernel bitvector: bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, "
          f"{n_ops} ops: {compares} compares and {ors} ORs of the records up to each "
          f"(row, tree)'s exit word); over every entry {all_ms:.4f} ms by {all_by} "
          f"({all_bytes} bytes, {all_ops} ops: {all_ors} ORs of nonzero mask words over "
          f"{applied} false (row, entry) pairs of "
          f"{ROWS * ir.materialize('bitvector').total_entries}); no single PyTorch call "
          "computes this function, so there is no library time")
    rows_out["bitvector"] = dict(
        name="bitvector", route="cuda", source=SOURCES["bitvector"],
        replaces=REPLACES["bitvector"], max_abs_err=measured["bitvector"]["max_abs_err"],
        ms=measured["bitvector"]["ms"], warm_ms=measured["bitvector"]["warm_ms"],
        plain_ms=measured["bitvector"]["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=measured["bitvector"]["shape"],
        small_batches={f"bitvector@{r}": measured[f"bitvector@{r}"]
                       for r in SMALL_ROWS["bitvector"]},
        multi_word=dict(max_abs_err=wide_err, shape=wide_shape),
        random_spans=dict(max_abs_err=max(span_errs.values()), launches=len(span_errs)),
        table_bytes=dict(packed=packed.nbytes(), dense=dense_bytes),
        bound_every_entry=dict(ms=all_ms, by=all_by, bytes=all_bytes, ops=all_ops))

    for spec in routes:
        eng = engines[spec]
        ms = host_ms(lambda: eng.predict_scores(X), REQUEST_TIMING_REPS)
        print(f"{card} | request {spec}: {ROWS} rows end to end (H2D, keys, kernels, "
              f"D2H, merge, finalize) {ms:.3f} ms median, host clock")

    # the integer:cuda@leaf_major request's steps, each timed on its own
    x_dev = torch.from_numpy(X).to(dev)
    k1 = cases["leaf_major"][0]
    acc = k1()
    acc_host = acc.view(torch.int32).cpu().numpy().view(np.uint32)
    steps_ms = {
        "h2d": cuda_ms(lambda: torch.from_numpy(X).to(dev), REQUEST_TIMING_REPS),
        "keys": cuda_ms(lambda: float_to_key(x_dev), REQUEST_TIMING_REPS),
        "kernel": cuda_ms(k1, REQUEST_TIMING_REPS, lead=True),
        "d2h": cuda_ms(lambda: acc.view(torch.int32).cpu(), REQUEST_TIMING_REPS),
        "finalize": host_ms(lambda: finalize_partials("integer", acc_host, ir.n_trees,
                                                      ir.scale), REQUEST_TIMING_REPS),
    }
    print("request integer:cuda@leaf_major steps, ms median: " + ", ".join(
        f"{k} {v:.4f}" for k, v in steps_ms.items()))
    # for the deployment and host-C phases
    want = {mode: refs[mode].predict_scores(X) for mode in ("integer", "flint")}
    ref_partials = refs["integer"].predict_partials(X)
    for eng in (*engines.values(), *refs.values()):  # the plans' shard pools too
        eng.close()

    # 6. the gateway path, with the launch counters read around it
    t0 = time.perf_counter()
    forest_v2 = build_model(args.seed + 1)[0]
    print(f"gateway: v2 forest built from seed {args.seed + 1} in "
          f"{time.perf_counter() - t0:.2f} s")
    gw_launches = gateway_phase(forest, forest_v2, args.seed, dev, card)
    for name in ("leaf_major", "gather", "onehot"):
        if gw_launches[name] == 0:
            fail(f"kernel {name} was not launched on the gateway path")

    # 7. the plan gateway, with the launch counters read around it
    reg = ModelRegistry()
    plan_launches, _ = plan_gateway_phase(reg, reg.register_forest(MODEL_ID, forest),
                                       PLAN_GATEWAY_ROUTE, args.seed, dev, card)
    if plan_launches["bitvector"] == 0 or \
            plan_launches["leaf_major"] + plan_launches["gather"] == 0:
        fail("the plan gateway did not launch both of its shards' kernels")

    # 8 and 9. the deployment path and the remote gateway, the workers'
    # launches read from their span records
    t0 = time.perf_counter()
    # the host-C libraries build while the converter runs in its processes
    builds = start_host_c_builds(ir, dev)
    deploy = deployment_phase(forest, ir, X, want["integer"], args.seed, dev, card,
                              after_convert=lambda: finish_host_c_builds(builds))
    print(f"deployment phases: {time.perf_counter() - t0:.2f} s")

    # 10. the host-C phase, with the launch counters read around its mixed
    # routes and its gateway
    host_c = host_c_phase(ir, X, want, ref_partials, builds, if_else, args.seed, dev, card)

    paths = {"engine": launches, "gateway": gw_launches, "plan_gateway": plan_launches,
             **deploy, "host_c": host_c["mixed"], "host_c_gateway": host_c["gateway"]}
    kernels_out = [dict(rows_out[name], launches=sum(p.get(name, 0) for p in paths.values()),
                        launches_by_path={k: p.get(name, 0) for k, p in paths.items()})
                   for name in REPLACES]
    print(card)
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
