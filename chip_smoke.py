#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA card.

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
     shape and shared memory as its wrapper launched it; then serves four
     threads at once through ``integer:cuda@leaf_major`` and
     ``integer:bitvector`` at 65,536 and 20 rows, every answer held bit for
     bit against the reference walk, every rows copy pinned on its thread's
     own stream and counted in ``backends.staging.STAGED`` (printed), each
     route's rows copy in device ms beside a pageable copy of the same rows
     and the pinned host memory torch's caching host allocator held at most,
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
     once each, at once on threads, beside the autotune step,
 11. drives the serving drivers and the LM serving path: granite-3-2b at
     full width (40 layers, d_model 2048, 2.53 B parameters drawn on the
     card from the seed) through ``LMEngine``: two greedy generations of
     16 tokens at batch 4 and prompt 32 that must agree, ``decode_step``
     against ``forward_logits`` at full width, prefill ms and decode ms per
     token beside their byte bounds, tok/s and peak memory; then, while
     ``python -m repro_torch.launch.serve --trees``, ``--trees --gateway
     --gw-spec integer:cuda`` and ``python -m repro_torch.examples.
     quickstart`` run as processes at their default sizes (their integer
     rows must agree at 1.000000, the gateway be bit-identical to the
     direct engine, the drivers' K1 and K2 launches counted in their
     processes), granite-3-2b's widths cut to 2 layers on the card against
     the host's CPU from the same weights, and every LM family's smoke
     model on the card (prefill/decode consistency; a finite forward for
     the encoder); last, alone, ``python -m repro_torch.launch.serve --arch
     granite-3-2b --batch 4 --prompt 32 --tokens 16`` at full width, whose
     tokens at seed 0 must equal the in-process run's,
 12. trains the LM (the kernels' launch counters set to 0 just before and
     read just after, in this process and in every process it starts: the
     training path launches no hand-written kernel, and they must all read
     0): granite-3-2b at full width, drawn on the card from the seed, takes
     3 steps of ``make_train_step`` on 8 x 512 tokens in 4 microbatches
     (finite losses and grad norms, the first loss within 2.0 of ln V, the
     optimizer's step at 3; the median step beside its bound, the peak
     memory); its 2-layer cut takes one step on the card and on the host's
     CPU from the same weights (loss within 2e-3, each gradient leaf within
     a relative L2 difference of 3e-2, the card's AdamW from the CPU's
     gradients equal to the CPU's update within 1% of a step, and at most
     0.1% of the parameters whose |g| is above 1e-3 of their leaf's largest
     stepping over half a step apart); the cut's training state is saved
     asynchronously and restored to the card bit for bit, and a
     ``RestartableLoop`` with a crash injected at step 3 of 6 resumes from
     its checkpoint (files under ``build/chip_smoke_train/``, removed at the
     end); while two processes train the cut with
     ``make_integer_dp_train_step`` over gloo on CUDA tensors (their
     parameters bit-identical after every step, their ``integer_psum`` of a
     fixed random tensor equal bit for bit on the card and on the CPU and
     within ``quantization_error_bound``; the losses printed beside one
     process's ``make_train_step``), and ``python -m
     repro_torch.launch.train`` (granite-3-2b smoke, 30 steps; its loss must
     descend by over 0.2), the same with ``--integer-allreduce``, ``python
     -m repro_torch.examples.train_lm --steps 100`` and ``python -m
     repro_torch.examples.integer_allreduce_demo`` run as processes on the
     card; the full-width steps run under ``use_mesh(make_host_mesh())``,
     their parameters placed by ``params_shardings``, as the reference
     launcher runs, and ``launch.train`` runs under its host mesh too,
 13. runs the mesh branches (the kernels' launch counters set to 0 just
     before and read just after, in this process and in every rank: the
     mesh branches launch no hand-written kernel, and they must all read
     0): the paper's ``tree_serve_step`` on serve_1m's 1,048,576 rows of
     the full-width forest in 4 processes on the card as a (data 2, model
     2) mesh over gloo, each rank's rows bit-identical to one process's
     step and no collective inside the step, its device time per rank and
     end to end; then two processes on the card: granite-3-2b at full width
     as (data 1, model 2), the heads split over ``model``, its prefill and
     16 decode steps against the same engine without a mesh, and its
     2-layer cut at batch 1 as (data 2, model 1), the decode's KV sequence
     split over ``data`` (flash decode); one olmoe-1b-7b block at full
     width under expert parallelism over ``model`` against ``moe_block``
     without a mesh, and its 2-layer cut's prefill; one train step of the
     granite cut as (data 2, model 1) against the step in one process;
     meanwhile, in this process, the granite cut's train step under a 1 x 1
     NCCL mesh, bit for bit against the step without a mesh.  The
     collectives the ranks staged through the host (CUDA tensors on gloo)
     are printed,
 14. repairs fault D on the card and runs the dry run (the kernels' launch
     counters set to 0 just before and read just after, in this process and
     in every rank: none is launched): granite-3-2b at full width, cut to 12
     layers, takes one step of 8 x 512 tokens in one process (microbatches
     of one row) and then as (data 2, model 1) in two processes on the card
     over gloo, each rank holding only its blocks of the parameters and
     moments, gathering a layer at a time and reducing the gradients into
     its blocks; each rank's loss, gradient norm and every leaf's update
     held to step 13e's gates against the one-process step, and each rank's
     peak memory below 0.8 of the one-process step's; three cells of
     ``python -m repro_torch.launch.dryrun`` (granite-3-2b and gemma3-27b
     ``train_4k`` on 16 x 16, intreeger-rf ``serve_1m`` on 2 x 16 x 16),
     started on the host CPU when the run starts (no card), each of which
     must be ``ok``, with their per-rank argument and peak bytes, dominant
     roofline term and useful ratio printed; then (14c) granite-3-2b at full
     width and depth takes the same step in one process twice, plainly and
     as the split control (each matmul that the ranks split computed as
     their shares, summed in float32 and rounded once), and then as (data 1,
     model 2) in the same two processes, the model tensor-parallel over
     ``model`` (each rank computing its heads, FFN columns and its share of
     every matmul from its ``model`` blocks, joined by all-reduces over
     ``model``), in microbatches of one row, held to the same gates against
     the control and within 4e-2 of the plain step; no parameter is gathered
     (``data`` is 1 and no block is gathered over ``model``), and each rank's
     held and peak GiB, its collectives staged through the host over
     ``model`` and over the batch axes, and its step time are printed; then
     (14d) mamba2-370m at full width and depth (48 layers, d_model 1,024,
     32 SSM heads of 64, state 128, vocabulary 50,280) takes the same step
     the same three ways, each rank computing its SSM heads and its half of
     B and C (its pieces of the in-projection and conv, exchanged from the
     ranks' blocks; B and C gathered after the conv; the gated norm's sum
     of squares summed over ``model``, the out-projection row-parallel) and
     its half of the vocabulary, held bit for bit to the split control
     (which splits the SSM and the vocabulary as the ranks do) and within
     0.11 of the plain step (beside the plain step's own spread in 2-row
     microbatches), with each layer's collectives over ``model`` a
     microbatch counted (the pieces' all-to-alls, the B and C gathers and
     their gradients' reduce-scatter; no parameter gathered whole), each
     rank's in-projection columns and the bytes a layer printed; then
     its prefill of 4 x 32 tokens and 8 decode steps at full depth, with
     the parameters and the cache as blocks under the same mesh: every
     logits the split control's bits and within 0.33 of whole weights
     without a mesh, and the prefill and 2 decode steps in float32 within
     1e-3 of whole weights in float32, the bytes a layer of the prefill and
     of a decode step printed; then (14e) granite-3-2b at full width
     and depth, its matmul weights in bf16, as blocks of (data 2, model 1)
     in the same processes, serves 4 rows of 32 tokens and 8 greedy decode
     steps on each rank's rows (its 2 rows of every layer and of the cache;
     the logits gathered over ``data``): each rank's logits the bits of one
     process serving its 2 rows alone with whole weights, within 0.2 of one
     process serving the whole batch fed the same tokens, each rank's peak
     memory below that process's, with every greedy token that differs from
     that process's (not gated), the prefill and decode times and the
     collectives staged through the host printed.

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
import atexit
import contextlib
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

# the repo's serving configuration, read by use_model_config() from this
# checkout's repro_torch.configs (never from --src); and the serve_64k
# request shape (src/repro/launch/shapes.py)
MODEL_ID = "intreeger-rf"
N_TREES = DEPTH = N_FEATURES = N_CLASSES = None
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

# the staging gate: four threads at once through each route, each thread's
# requests seeded permutations of the main path's rows at each row count
STAGING_ROUTES = ("integer:cuda@leaf_major", "integer:bitvector")
STAGING_ROWS = (ROWS, 20)
STAGING_THREADS, STAGING_ROUNDS = 4, 6
# the gateway phase: request sizes and their shares, the share of requests
# that repeat an earlier request's rows, the open-loop arrival rate
GATEWAY_REQUESTS = 240
GATEWAY_ROWS = (1, 20, 256, 4096)
GATEWAY_ROW_SHARES = (0.35, 0.35, 0.2, 0.1)
GATEWAY_REPEAT_SHARE = 0.25
GATEWAY_RATE_PER_S = 100.0
GATEWAY_MAX_BATCH_ROWS = 4096

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

# the drivers-and-LM phase: granite-3-2b at full width, the request the
# launcher serves by default (batch 4, prompt 32, 16 greedy tokens); the
# cut to 2 layers that runs on the card and on the host's CPU; the H100's
# bf16 tensor-core peak (NVIDIA data sheet, SXM, dense)
LM_ARCH = "granite-3-2b"
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 32, 16
LM_CUT_LAYERS = 2
LM_TIMING_REPS = 5
BF16_FLOPS_PER_S = 989e12
# tolerances on logits (float32 outputs of bf16 compute): the reference's own
# for its smoke models (tests/test_arch_smoke.py); at full width, decode_step
# against forward_logits on the card (measured 0.0791 at seed 0 on an NVIDIA
# H100 80GB HBM3 at 700 W), and for the 2-layer cut the card against the
# host's CPU (measured 0.0469): each about 2.5 times what was measured
LM_SMOKE_TOL = 0.08
LM_CONSISTENCY_TOL = 0.2
LM_HOST_TOL = 0.12
# the drivers run as ``python -m``, their kernels' launch counters printed
# as they exit
DRIVER_WRAPPER = (
    "import json, runpy, sys\n"
    "module = sys.argv[1]\n"
    "sys.argv = [module] + sys.argv[2:]\n"
    "from repro_torch.kernels import tree_traverse as tt\n"
    "tt.reset_launches()\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
    "print('DRIVER_LAUNCHES ' + json.dumps(dict(tt.LAUNCHES)))\n")
DRIVER_ROWS = ("integer", "integer-leafmajor", "integer-cuda", "integer-c-table")

# the training phase: granite-3-2b at full width trains TRAIN_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ tokens (its configuration's 4 microbatches); its
# 2-layer cut trains one step of TRAIN_CUT_BATCH x TRAIN_CUT_SEQ on the card
# and on the host's CPU, is checkpointed and restarted (TRAIN_LOOP_* steps,
# a crash injected at TRAIN_LOOP_CRASH), and trains TRAIN_DP_STEPS steps in
# TRAIN_DP_RANKS processes on the card with the integer all-reduce over gloo
TRAIN_BATCH, TRAIN_SEQ = 8, 512
# the full-width steps in order: the first under the host mesh (its warm-up),
# then the same step without a mesh and under it, interleaved, so the two are
# timed in one run on one card; then one step of each mode, untimed, with
# its torch operations counted
TRAIN_MODES = ("mesh",) + ("plain", "mesh", "mesh", "plain") * 2
TRAIN_COUNTED = ("mesh", "plain")
TRAIN_STEPS = len(TRAIN_MODES) + len(TRAIN_COUNTED)
TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 4, 128
TRAIN_LOOP_STEPS, TRAIN_LOOP_CRASH, TRAIN_LOOP_EVERY = 6, 3, 2
TRAIN_LOOP_BATCH, TRAIN_LOOP_SEQ = 2, 64
TRAIN_DP_RANKS, TRAIN_DP_BATCH, TRAIN_DP_SEQ, TRAIN_DP_STEPS = 2, 8, 128, 3
TRAIN_PSUM_SIZE = 1 << 20
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
# a first loss within TRAIN_FIRST_LOSS_TOL of ln(vocab) (random weights
# predict about uniformly); the cut's loss and gradients, card against CPU,
# within the tolerances the CPU tests hold the port to against the JAX
# package (tests/test_torch_train.py); AdamW on the card from the CPU's
# gradients within TRAIN_UPDATE_TOL of a step of the CPU's update; of the
# parameters whose |g| is above TRAIN_UPDATE_MASK of their leaf's largest, at
# most TRAIN_STEP_SHARE stepped over half a step apart from their own
# gradients (those whose gradients differ in sign or sit near AdamW's eps)
TRAIN_FIRST_LOSS_TOL = 2.0
TRAIN_LOSS_TOL = 2e-3
TRAIN_GRAD_REL_L2 = 3e-2
TRAIN_UPDATE_MASK = 1e-3
TRAIN_UPDATE_TOL = 1e-2
TRAIN_STEP_SHARE = 1e-3
# the drivers as a user runs them: the launcher's loss must descend by more
# than TRAIN_DRIVER_DESCENT over its 30 steps (tests/test_launchers.py)
TRAIN_DRIVER_DESCENT = 0.2
TRAIN_DRIVERS = (
    ["repro_torch.launch.train", "--arch", LM_ARCH, "--smoke", "--steps", "30", "--batch", "8",
     "--seq", "64", "--lr", "5e-3", "--device", "cuda"],
    ["repro_torch.launch.train", "--arch", LM_ARCH, "--smoke", "--steps", "30", "--batch", "8",
     "--seq", "64", "--lr", "5e-3", "--device", "cuda", "--integer-allreduce"],
    ["repro_torch.examples.train_lm", "--steps", "100", "--device", "cuda"],
    ["repro_torch.examples.integer_allreduce_demo", "--device", "cuda"],
)
# each rank of step 12d runs this script's ``train_dp_rank`` in its own
# process
TRAIN_DP_PROGRAM = (
    "import sys\n"
    f"sys.path.insert(0, {str(ROOT)!r})\n"
    "import chip_smoke\n"
    "chip_smoke.train_dp_rank(*sys.argv[1:])\n")

# the mesh phase: the paper's serving step on serve_1m's rows
# (launch/shapes.py) over a (data 2, model 2) mesh of 4 processes on the
# card over gloo, timed over MESH_TREE_REPS runs; 2 processes for
# granite-3-2b at full width over (data 1, model 2), its cut at batch 1 over
# (data 2, model 1), one olmoe-1b-7b block at full width on MESH_MOE_TOKENS
# under expert parallelism (and its cut's prefill and MESH_MOE_DECODE
# steps), and the cut's train step over (data 2, model 1).  Tolerances: the
# logits within the reference's own bf16 tolerance for its smoke models
# (LM_SMOKE_TOL) where the heads split (each head's arithmetic unchanged),
# and within LM_HOST_TOL where the decode's softmax is combined from
# sequence shards (another order of float32 sums, as the card against the
# host's CPU is); the MoE block within 4 bf16 ulps of its largest output
# (the port sums a token's expert rows in float32 and rounds once, the
# sum over ranks adds them in another order); the train step's loss within
# the reference's 5e-2 (tests/test_distributed.py).  The train step runs
# with MESH_TRAIN_OPT, whose first step moves each parameter by g / (|g| + 1)
# of its clipped gradient g (the default AdamW's first step, about
# lr * sign(g), hides the gradient's scale): the sharded step's update to
# every leaf within MESH_TRAIN_UPDATE_TOL (relative L2) of one process's, and
# its global gradient norm within MESH_TRAIN_NORM_TOL (relative), as
# tests/test_torch_mesh.py holds it on the CPU, where a step that drops rows,
# skips the gradients' mean or takes it over the wrong axis misses both
MESH_TREE_ROWS = 1 << 20
MESH_TREE_SHAPE = (2, 2)
MESH_TREE_REPS = 5
MESH_TABLES = ("feature", "threshold_key", "left", "right", "leaf_fixed")
MESH_LM_RANKS = 2
MESH_MOE_ARCH = "olmoe-1b-7b"
MESH_MOE_TOKENS = (4, 128)
MESH_MOE_DECODE = 4
MESH_REPS = 5
MESH_LOGITS_TOL = LM_SMOKE_TOL
MESH_SEQ_TOL = LM_HOST_TOL
MESH_MOE_REL_TOL = 2.0 ** -6
MESH_TRAIN_TOL = 5e-2
MESH_TRAIN_OPT = dict(lr=1.0, eps=1.0, weight_decay=0.0, warmup_steps=1)
MESH_TRAIN_UPDATE_TOL = 2e-2
MESH_TRAIN_NORM_TOL = 1e-3
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_PROGRAM = (
    "import sys\n"
    f"sys.path.insert(0, {str(ROOT)!r})\n"
    "import chip_smoke\n"
    "chip_smoke.mesh_rank(*sys.argv[1:])\n")

# the sharded-step phase (14a): granite-3-2b at full width cut to
# FSDP_LAYERS layers takes one step of TRAIN_BATCH x TRAIN_SEQ tokens (12a's
# seed and batch) with MESH_TRAIN_OPT in one process, then as (data
# FSDP_RANKS, model 1) in FSDP_RANKS processes on the card over gloo, each
# rank holding only its blocks and gathering a layer at a time; 13e's gates
# (MESH_TRAIN_TOL, MESH_TRAIN_UPDATE_TOL, MESH_TRAIN_NORM_TOL) against the
# one-process step, and every rank's peak memory below FSDP_PEAK_SHARE of
# the one-process step's (at FSDP_LAYERS layers the blocks are most of it).
# 14c: granite-3-2b at full width and depth takes the same step as (data 1,
# model FSDP_RANKS), tensor-parallel over ``model``, in microbatches of one
# row, in the same processes, held to the same gates against the split
# control: the one-process step with each split matmul computed as the
# ranks' column or row shares of it, summed in float32 and rounded once
# (``split_control``), so that it rounds where the ranks do.  The plain
# one-process step rounds each whole product at once instead, and the
# tensor-parallel step's distance from it is held to MESH_TP_PLAIN_TOL, set
# from a reading on an NVIDIA H100 80GB HBM3: the tensor-parallel step gave
# the control's bits, and both sat 2.59e-2 from the plain step (worst
# ``blocks/attn/wq``, whose gradient comes through the softmax's backward).
FSDP_LAYERS = 12
FSDP_PEAK_SHARE = 0.8
FSDP_RANKS = 2
FSDP_DIR = ROOT / "build" / "chip_smoke_fsdp"
FSDP_PROGRAM = (
    "import sys\n"
    f"sys.path.insert(0, {str(ROOT)!r})\n"
    "import chip_smoke\n"
    "chip_smoke.fsdp_rank(*sys.argv[1:])\n")
MESH_TP_PLAIN_TOL = 4e-2
# 14d: mamba2-370m (state-spaces/mamba2-370m: 48 layers, d_model 1,024, 32
# SSM heads of 64, state 128, vocabulary 50,280) at full width and depth
# takes 14c's step as (data 1, model FSDP_RANKS), its SSM heads split over
# ``model``, in the same processes: the split control's bits exactly
# (loss, norm and every leaf), and its updates within SSM_TP_PLAIN_TOL of
# the plain one-process step's.  Then, at full depth too, ``prefill`` of
# SSM_SERVE_PROMPT tokens and SSM_SERVE_STEPS ``decode_step``s under the
# same mesh, the parameters as blocks and the cache as blocks after the
# prefill: every logits equal to the split control's (``split_control``,
# one process), within SSM_SERVE_TOL of whole weights without a mesh, and,
# run again with float32 activations and caches for the prefill and
# SSM_SERVE_F32_STEPS decode steps, within SSM_SERVE_F32_TOL of whole
# weights in float32.  The float32 run separates the split's algebra
# (which float32 holds to its own rounding) from bf16 rounding: with random
# weights each of the 48 layers carries the rounding of a split matmul or
# norm sum into the next, and the bf16 logits (magnitude about 5) drift.
SSM_ARCH = "mamba2-370m"
# SSM_TP_PLAIN_TOL is set from a reading on an NVIDIA H100 80GB HBM3: the
# tensor-parallel step gave the split control's bits, and both sat 7.42e-2
# from the plain one-process step (worst ``blocks/ssm/d_skip``, whose
# gradient sums dy * x over every token and channel of a head); the plain
# step's own spread between 1-row and 2-row microbatches is printed beside
# it
SSM_TP_PLAIN_TOL = 0.11
SSM_SERVE_PROMPT = (4, 32)
SSM_SERVE_STEPS = 8
SSM_SERVE_F32_STEPS = 2
# SSM_SERVE_TOL is set from a reading on an NVIDIA H100 80GB HBM3: the
# tensor-parallel prefill at all 48 layers sat 0.22 from whole weights in
# bf16 (the decode steps 0.18 to 0.21), while whole weights in bf16 sat
# 0.28 to 0.31 from whole weights in float32.  SSM_SERVE_F32_TOL was set
# before any float32 reading (float32 rounds 2^15 times finer than bf16);
# the card then read 2.64e-5
SSM_SERVE_TOL = 0.33
SSM_SERVE_F32_TOL = 1e-3
# 14e: fault E's repair at full width.  granite-3-2b whole (40 layers), its
# matmul weights in bf16 as ``LMEngine`` keeps them, placed as blocks of a
# (data FSDP_RANKS, model 1) mesh in phase 14's processes, serves
# ROWS_SERVE_BATCH rows of ROWS_SERVE_PROMPT tokens and ROWS_SERVE_STEPS
# greedy decode steps, each rank computing its rows only (its share of the
# cache, its rows of the logits, gathered over ``data`` at the end).  Gates:
# each rank's logits the bits of its row control (one process serving that
# rank's rows alone with whole weights, fed the same tokens: cuBLAS picks its
# product by shape), within ROWS_SERVE_TOL (``PERF.md`` section 2's decode
# tolerance) of the one-process whole-batch call's rows fed the same tokens,
# and each rank's peak memory below that call's.  Every greedy token that
# differs from that call's is printed with its two candidates' gap in the
# one-process logits, and not gated: the 2-row against 4-row products alone
# flip near-ties (1 of 36 on an NVIDIA H100 80GB HBM3 at seed 0, 0.0625
# apart), and any flip the logits gate lets through is one of those
ROWS_SERVE_BATCH = 4
ROWS_SERVE_PROMPT = 32
ROWS_SERVE_STEPS = 8
ROWS_SERVE_TOL = LM_CONSISTENCY_TOL
# the dry-run phase (14b): these cells (architecture, shape, the 2 x 16 x 16
# mesh or the 16 x 16 one) in processes on the host CPU, started with the run
# and read at its end, when they have DRYRUN_TIMEOUT_S more to finish
DRYRUN_CELLS = (("granite-3-2b", "train_4k", False), ("gemma3-27b", "train_4k", False),
                ("intreeger-rf", "serve_1m", True))
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT_S = 300


def fail(message: str, code: int = 1):
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr)
    sys.exit(code)


def use_model_config() -> None:
    """The served forest's shape (trees, depth, features, classes) from the
    configuration registry of this script's own checkout, read before
    ``--src`` puts another tree's ``repro_torch`` on the path: both sides of
    a before/after run serve one shape, and a tree without the registry
    still runs."""
    global N_TREES, DEPTH, N_FEATURES, N_CLASSES
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.configs import get_config

        cfg = get_config(MODEL_ID)
    finally:
        sys.path.remove(str(SRC))
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
    N_TREES, DEPTH, N_FEATURES, N_CLASSES = (cfg.n_trees, cfg.tree_depth,
                                             cfg.n_tab_features, cfg.n_classes)


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

def staging_gate(engines: dict, want: tuple, X, seed: int, dev, card: str) -> dict:
    """Four threads at once through each of ``STAGING_ROUTES`` at each of
    ``STAGING_ROWS``, every request a seeded permutation of ``X``'s rows,
    every answer held bit for bit against ``want`` (the reference walk's
    scores and predictions on ``X``) taken alike; ``STAGED`` must count every
    rows copy as pinned, with its padded rows' bytes.  Prints, a route and
    row count, ``STAGED``, the rows copies' device ms a request in the
    profiler's trace beside a pageable copy of the same rows on one thread,
    and the host ms a request over the four threads."""
    import threading

    import torch
    from portbench.devtrace import Profiled
    from repro_torch.backends import staging

    def h2d_ms(prof) -> tuple:
        copies = [e for e in prof.events()[0] if e[0] == "gpu_memcpy" and "HtoD" in e[1]]
        return sum(e[3] for e in copies) * 1e-3, sorted({e[1] for e in copies})

    rng = np.random.default_rng(seed + 33)
    out = {}
    for spec in STAGING_ROUTES:
        eng = engines[spec]
        for n in STAGING_ROWS:
            picks = [[rng.permutation(len(X))[:n] for _ in range(STAGING_ROUNDS)]
                     for _ in range(STAGING_THREADS)]
            rows = [[X[p] for p in per] for per in picks]
            got = [None] * STAGING_THREADS
            errors = []
            go = threading.Barrier(STAGING_THREADS)

            def client(i):
                try:
                    go.wait()
                    got[i] = [eng.predict_scores(x) for x in rows[i]]
                except Exception as e:  # reported below, with the route
                    errors.append(repr(e))

            staging.reset_staged()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(STAGING_THREADS)]
            with Profiled() as prof:
                t0 = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=600)
                host_s = time.perf_counter() - t0
            if errors or any(th.is_alive() for th in threads):
                fail(f"staging gate {spec} at {n} rows: {errors or 'a thread did not finish'}")
            for per_pick, per_got in zip(picks, got):
                for p, (scores, preds) in zip(per_pick, per_got):
                    if not (np.array_equal(scores, want[0][p])
                            and np.array_equal(preds, want[1][p])):
                        fail(f"staging gate {spec} at {n} rows: an answer of four "
                             "threads differs from integer:reference")
            requests = STAGING_THREADS * STAGING_ROUNDS
            padded = eng.padded_rows(n)
            staged = dict(staging.STAGED)
            expect = {"pinned": requests, "plain": 0,
                      "pinned_bytes": requests * padded * X.shape[1] * 4}
            if staged != expect:
                fail(f"staging gate {spec} at {n} rows: STAGED {staged}, expected {expect}")
            pinned_ms, names = h2d_ms(prof)
            same = torch.from_numpy(np.ascontiguousarray(X[:padded]))
            with Profiled() as prof:
                for _ in range(requests):
                    same.to(dev)
            pageable_ms, pageable_names = h2d_ms(prof)
            out[f"{spec}@{n}"] = row = dict(
                staged=staged, copy_ms=pinned_ms / requests, copies=names,
                pageable_ms=pageable_ms / requests, pageable=pageable_names,
                host_ms=host_s * 1e3 / requests)
            print(f"{card} | staging gate {spec} at {n} rows ({padded} padded), "
                  f"{STAGING_THREADS} threads x {STAGING_ROUNDS}: bit-identical to "
                  f"integer:reference; STAGED {staged}; rows copy {row['copy_ms']:.4f} ms "
                  f"device a request {names} against a pageable copy of the same rows "
                  f"{row['pageable_ms']:.4f} ms {pageable_names}; {row['host_ms']:.3f} ms "
                  "host a request over the threads")
    # torch's caching host allocator: the pinned blocks it holds, at most
    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    out["pinned_host"] = {k: v for k, v in stats.items()
                          if ("bytes" in k and k.endswith(".peak")) or k == "num_host_alloc"}
    print(f"{card} | staging gate: pinned host memory {out['pinned_host']}")
    return out


def fused_plan_phase(ir, X, refs: dict, baseline: str, baseline_ms: float, dev,
                     card: str) -> dict:
    """Step 4d: the fused ``tree_parallel`` strategy on the card, its device
    list patched to the card twice (one card stands in for a card a
    shard): ``integer:reference+tree_parallel:2`` and its ``flint`` twin
    on the full rows and on one row, bit-identical to the single reference
    plan on the card, their partials too; the full rows' request timed
    beside ``baseline`` (the threaded plan over K1 shards)."""
    from repro_torch.plan import tree_parallel
    from repro_torch.serve import TreeEngine

    real = tree_parallel.fused_devices
    tree_parallel.fused_devices = lambda device: [dev] * 2
    out = {}
    try:
        for mode in ("integer", "flint"):
            spec = f"{mode}:reference+tree_parallel:2"
            eng = TreeEngine(ir, spec=spec, device=dev)
            plan = eng.plan
            if not plan.fused or plan.backends or plan.backend_name != "reference":
                fail(f"{spec} with a card a shard did not build the fused strategy: "
                     f"{plan.describe()}")
            for rows in (X, X[:1]):
                got, want = eng.predict_scores(rows), refs[mode].predict_scores(rows)
                if not all(np.array_equal(a, b) and a.dtype == b.dtype
                           for a, b in zip(got, want)):
                    fail(f"the fused strategy {spec} on {len(rows)} rows differs from "
                         f"{mode}:reference")
            if not np.array_equal(eng.predict_partials(X), refs[mode].predict_partials(X)):
                fail(f"the fused strategy's partials ({spec}) differ from {mode}:reference's")
            plan.drain_timings()
            ms = host_ms(lambda: eng.predict_scores(X), REQUEST_TIMING_REPS)
            span = plan.drain_timings()
            out[mode] = dict(ms=ms, spans={k: v[0] / v[1] for k, v in span.items()})
            eng.close()
    finally:
        tree_parallel.fused_devices = real
    for mode, r in out.items():
        print(f"{card} | fused 4d: {mode}:reference+tree_parallel:2, the fused strategy with "
              f"both shards' tables on the one card (the reference walk queued for each "
              f"shard, merged on the card), {ROWS} rows: bit-identical to {mode}:reference "
              f"(partials, scores, and on one row); {r['ms']:.3f} ms median end to end, "
              f"host clock ({', '.join(f'{k} {v:.3f} ms' for k, v in r['spans'].items())} a "
              f"request); {baseline} {baseline_ms:.3f} ms")
    return out


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

def start_modules(commands: list, wrapper: str | None = None) -> list:
    """Start each ``python -m <args>`` of ``commands`` at once, with the
    checkout's ``src`` on the path; with ``wrapper``, as ``python -c wrapper
    <args>``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    prefix = ["-c", wrapper] if wrapper else ["-m"]
    return [(args, subprocess.Popen([sys.executable, *prefix, *args], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=env))
            for args in commands]


def finish_modules(started: list, timeout: float = 600) -> list:
    """The stdout of each process of ``start_modules``; fails the run on a
    non-zero exit, and kills whatever still runs."""
    outs = []
    try:
        for args, proc in started:
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode:
                fail(f"python -m {' '.join(args)} exited {proc.returncode}: {err[-3000:]}")
            outs.append(out)
    finally:
        for _, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def run_modules(commands: list, timeout: float = 600) -> list:
    """The stdout of each ``python -m <args>`` in ``commands``, all run at
    once."""
    return finish_modules(start_modules(commands), timeout)


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

# ---------------------------------------------------------------------------
# the drivers-and-LM phase: the launcher and examples as a user runs them,
# granite-3-2b at full width, every LM family's smoke model
# ---------------------------------------------------------------------------

def driver_launches(out: str, args: list) -> dict:
    """The kernel launch counts a driver run through DRIVER_WRAPPER printed
    as it exited."""
    lines = [ln for ln in out.splitlines() if ln.startswith("DRIVER_LAUNCHES ")]
    if not lines:
        fail(f"python -m {' '.join(args)} printed no launch counts")
    return json.loads(lines[-1].split(" ", 1)[1])


def check_logits(got, want, tol: float, what: str) -> tuple:
    """``(max |got - want|, share of rows whose argmax agrees)``; fails above
    ``tol``, or where the argmax differs on a row whose top-2 margin in
    ``want`` exceeds twice ``tol``."""
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{what}: shape {got.shape} against {want.shape}, or values not finite")
    err = float(np.abs(got - want).max())
    agree = got.argmax(-1) == want.argmax(-1)
    srt = np.sort(want, axis=-1)
    sure = (srt[..., -1] - srt[..., -2]) > 2 * tol
    if err > tol or not agree[sure].all():
        fail(f"{what}: max |difference| {err} (tolerance {tol}), argmax agrees on "
             f"{agree.mean():.4f} of rows, {int((~agree & sure).sum())} of them beyond "
             "twice the tolerance's margin")
    return err, float(agree.mean())


def smoke_batch(cfg, rng, b: int = 2, s: int = 32) -> dict:
    """Inputs as ``tests/test_arch_smoke.py`` draws them, as numpy."""
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s - cfg.vision_patches)
                                       ).astype(np.int32),
                "patches": rng.normal(size=(b, cfg.vision_patches, cfg.frontend_dim)
                                      ).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def lm_consistency(engine, batch: dict, tol: float, what: str) -> tuple:
    """``decode_step`` on the last token after a prefill of the others,
    against ``forward_logits``'s last position (``tests/test_arch_smoke.py``'s
    check)."""
    import torch

    from repro_torch.models import transformer as tfm

    on = {k: torch.from_numpy(v).to(engine.device) for k, v in batch.items()}
    with torch.inference_mode():
        full = tfm.forward_logits(engine.cfg, engine.params, on)[:, -1]
    _, cache = engine.prefill(dict(batch, tokens=batch["tokens"][:, :-1]))
    decoded, _ = engine.decode(cache, on["tokens"][:, -1:])
    return check_logits(decoded, full, tol, what)


def lm_full_width(seed: int, dev, card: str) -> dict:
    """granite-3-2b at full width on the card: built from the seed, two
    greedy generations that must agree, the prefill/decode consistency, and
    the prefill and per-token decode times beside their bounds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import LMEngine

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = LMEngine(cfg, tfm.init_params(cfg, seed, device=dev),
                      max_seq=LM_PROMPT + LM_TOKENS, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated(dev)
    leaves = []
    tfm.tree_map(leaves.append, engine.params)
    weight_bytes = sum(a.numel() * a.element_size() for a in leaves)
    n_params = sum(a.numel() for a in leaves)
    if n_params != cfg.param_count() + cfg.d_model * (2 * cfg.n_layers + 1):
        fail(f"{LM_ARCH}: {n_params} parameters drawn, param_count() says "
             f"{cfg.param_count()} besides the norms")
    batch = {k: v for k, v in pipeline_for(cfg, LM_BATCH, LM_PROMPT, seed=seed)
             .batch_at(0).items() if k != "labels"}
    print(f"LM {LM_ARCH} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params} parameters drawn on the card from seed {seed} and "
          f"cast ({weight_bytes} bytes, bf16 matmul weights) in {build_s:.2f} s, peak "
          f"{build_peak / 2**30:.3f} GiB while building")

    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        toks = engine.generate(batch, LM_TOKENS).cpu()
        runs.append((toks, time.perf_counter() - t0))
    if tuple(runs[0][0].shape) != (LM_BATCH, LM_TOKENS) or \
            not torch.equal(runs[0][0], runs[1][0]):
        fail(f"{LM_ARCH}: two greedy generations differ, or shape {tuple(runs[0][0].shape)}")
    if int(runs[0][0].min()) < 0 or int(runs[0][0].max()) >= cfg.vocab_size:
        fail(f"{LM_ARCH}: generated tokens outside the vocabulary")
    err, agree = lm_consistency(engine, batch, LM_CONSISTENCY_TOL,
                                f"{LM_ARCH} decode_step against forward_logits")

    def prefill():
        out = engine.prefill(batch)
        torch.cuda.synchronize()
        return out

    prefill_ms = []
    for _ in range(LM_TIMING_REPS):
        t0 = time.perf_counter()
        prefill()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = []
    for _ in range(LM_TIMING_REPS):
        logits, cache = prefill()
        t0 = time.perf_counter()
        for _ in range(LM_TOKENS):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).reshape(-1, 1)
            logits, cache = engine.decode(cache, nxt)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3 / LM_TOKENS)
    serve_peak = torch.cuda.max_memory_allocated(dev)

    # bounds: each weight read once and the KV cache (a step reads up to all
    # of it) over the HBM rate; the matmul flops over the bf16 peak
    dims = cfg.resolved_head_dim * cfg.n_kv_heads
    cache_bytes = 2 * cfg.n_layers * LM_BATCH * (LM_PROMPT + LM_TOKENS) * dims * 2
    decode_bound_ms = max((weight_bytes + cache_bytes) / HBM_BYTES_PER_S,
                          2 * n_params * LM_BATCH / BF16_FLOPS_PER_S) * 1e3
    prefill_bound_ms = max((weight_bytes + cache_bytes) / HBM_BYTES_PER_S,
                           2 * n_params * LM_BATCH * LM_PROMPT / BF16_FLOPS_PER_S) * 1e3
    out = dict(
        arch=LM_ARCH, params=n_params, weight_bytes=weight_bytes, build_s=build_s,
        prefill_ms=statistics.median(prefill_ms), prefill_bound_ms=prefill_bound_ms,
        decode_ms_per_token=statistics.median(decode_ms), decode_bound_ms=decode_bound_ms,
        generate_s=[r[1] for r in runs],
        tok_per_s=LM_BATCH * LM_TOKENS / runs[1][1],
        peak_gib_build=build_peak / 2**30, peak_gib_serve=serve_peak / 2**30,
        consistency_max_abs=err, consistency_argmax_agree=agree,
        tokens=runs[0][0][0].tolist())
    print(f"{card} | LM {LM_ARCH} full width, batch {LM_BATCH}, prompt {LM_PROMPT}, "
          f"{LM_TOKENS} greedy tokens: prefill {out['prefill_ms']:.3f} ms median of "
          f"{LM_TIMING_REPS} (bound {prefill_bound_ms:.3f} ms by bytes); decode "
          f"{out['decode_ms_per_token']:.3f} ms per token (bound {decode_bound_ms:.3f} ms: "
          f"{weight_bytes + cache_bytes} bytes over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"generate {runs[0][1]:.3f} s then {runs[1][1]:.3f} s, {out['tok_per_s']:.1f} "
          f"tok/s; peak memory {out['peak_gib_serve']:.3f} GiB serving, "
          f"{out['peak_gib_build']:.3f} GiB building; host clock")
    print(f"  the two generations agree; tokens of row 0: {out['tokens']}; decode_step "
          f"against forward_logits: max |difference| {err:.5f} (tolerance "
          f"{LM_CONSISTENCY_TOL}), argmax agrees on {agree:.4f} of rows")
    del engine
    return out


def lm_cut_on_card_and_host(seed: int, dev) -> dict:
    """granite-3-2b's full widths cut to LM_CUT_LAYERS layers, the same
    weights on the card and on the host's CPU: the logits agree."""
    import torch

    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import LMEngine

    cfg = cut_config()
    params = tfm.init_params(cfg, seed, device=dev)
    batch = {k: torch.from_numpy(v) for k, v in pipeline_for(cfg, LM_BATCH, LM_PROMPT,
                                                               seed=seed).batch_at(0).items()
             if k != "labels"}
    logits = {}
    seconds = {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        engine = LMEngine(cfg, tfm.tree_map(lambda a: a.to(where), params), device=where)
        with torch.inference_mode():
            logits[where.type] = tfm.forward_logits(
                cfg, engine.params, {k: v.to(where) for k, v in batch.items()}).cpu()
        seconds[where.type] = time.perf_counter() - t0
    err, agree = check_logits(logits["cuda"], logits["cpu"], LM_HOST_TOL,
                              f"{LM_ARCH} cut to {LM_CUT_LAYERS} layers, card against CPU")
    print(f"LM {LM_ARCH} cut to {LM_CUT_LAYERS} layers (full widths), forward_logits of "
          f"{LM_BATCH} x {LM_PROMPT} tokens on the card and on the host's CPU from the same "
          f"weights: max |difference| {err:.5f} (tolerance {LM_HOST_TOL}), argmax agrees on "
          f"{agree:.4f} of positions; {seconds['cuda']:.2f} s on the card, "
          f"{seconds['cpu']:.2f} s on the CPU")
    return dict(max_abs=err, argmax_agree=agree)


def lm_smoke_models(seed: int, dev) -> dict:
    """Every LM family's SMOKE model on the card: the prefill/decode
    consistency of the decoders, a finite forward of the encoder."""
    import torch

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import LMEngine

    out = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        if cfg.family == "trees":
            continue
        engine = LMEngine(cfg, tfm.init_params(cfg, seed + 1, device=dev), max_seq=32,
                          device=dev)
        batch = smoke_batch(cfg, np.random.default_rng(seed + 1))
        if cfg.has_decode:
            out[arch] = lm_consistency(engine, batch, LM_SMOKE_TOL,
                                       f"{arch} smoke decode_step against forward_logits")[0]
        else:
            with torch.inference_mode():
                got = tfm.forward_logits(cfg, engine.params, {
                    k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            if tuple(got.shape) != (2, 32, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
                fail(f"{arch} smoke forward: shape {tuple(got.shape)} or values not finite")
            out[arch] = None
    print("LM smoke models on the card, decode_step against forward_logits, max "
          "|difference|: " + ", ".join(f"{a} {v:.5f}" if v is not None else
                                       f"{a} (encoder: forward finite)"
                                       for a, v in out.items()))
    return out


def drivers_and_lm_phase(seed: int, dev, card: str) -> dict:
    """Phase 11.  The LM at full width runs first and alone, so its times
    are the card's and this process's only; then the three tree drivers run
    as processes while the cut model and the smoke models run here; the
    LM launcher runs last, alone.  Returns the drivers' summed launches."""
    import torch

    t_phase = time.perf_counter()
    lm = lm_full_width(seed, dev, card)
    torch.cuda.empty_cache()

    commands = [
        ["repro_torch.launch.serve", "--trees"],
        ["repro_torch.launch.serve", "--trees", "--gateway", "--gw-spec", "integer:cuda"],
        ["repro_torch.examples.quickstart", "--out",
         str(ROOT / "build" / "chip_smoke_quickstart.c")],
    ]
    drivers = start_modules(commands, wrapper=DRIVER_WRAPPER)
    cut = lm_cut_on_card_and_host(seed, dev)
    smoke = lm_smoke_models(seed, dev)
    trees_out, gw_out, qs_out = finish_modules(drivers)
    trees_n, gw_n, qs_n = (driver_launches(out, args)
                           for out, args in zip((trees_out, gw_out, qs_out), commands))
    (ROOT / "build" / "chip_smoke_quickstart.c").unlink(missing_ok=True)

    rows = {ln.split()[0]: ln for ln in trees_out.splitlines() if "agree_with_float=" in ln}
    want = [r for r in DRIVER_ROWS if r != "integer-c-table" or "integer-native-c" in rows]
    bad = [r for r in want if "agree_with_float=1.000000" not in rows.get(r, "")]
    if bad or "integer-cuda" not in rows:
        fail(f"launch.serve --trees: rows {bad} do not agree at 1.000000:\n{trees_out}")
    # the drivers ran at once, beside the cut and smoke models in this
    # process, so the gateway's latencies are contended and not comparable
    # across runs; their seconds are not printed, as they are collected
    # only once this process's own work is done
    print(f"{card} | launch.serve --trees (defaults: 20,000 rows, 50 trees of depth 7, 3 "
          f"reps), kernel launches {trees_n}:")
    for line in rows.values():
        print("  " + line)
    if "gateway == direct engine (bit-identical): True" not in gw_out:
        fail(f"launch.serve --trees --gateway --gw-spec integer:cuda:\n{gw_out[-3000:]}")
    print(f"{card} | launch.serve --trees --gateway --gw-spec integer:cuda (defaults: 400 "
          f"requests at 400/s), kernel launches {gw_n}: "
          "bit-identical to the direct engine; its latencies below are contended")
    for line in gw_out.splitlines():
        if line.startswith(("workload:", "esa-rf", "shuttle-", "model ")):
            print("  " + line)
    for line in ("float == flint == integer predictions", "bit-identical uint32 scores"):
        if line not in qs_out:
            fail(f"examples.quickstart printed no '{line}':\n{qs_out[-3000:]}")
    print(f"{card} | examples.quickstart, kernel launches {qs_n}: "
          + "; ".join(ln for ln in qs_out.splitlines() if ln.startswith(
              ("forest accuracy", "float == flint", "bit-identical"))))

    t0 = time.perf_counter()
    lm_out = run_modules([["repro_torch.launch.serve", "--arch", LM_ARCH, "--batch",
                           str(LM_BATCH), "--prompt", str(LM_PROMPT), "--tokens",
                           str(LM_TOKENS)]])[0]
    lm_s = time.perf_counter() - t0
    if f"generated ({LM_BATCH}, {LM_TOKENS}) tokens" not in lm_out or \
            "peak device memory:" not in lm_out:
        fail(f"launch.serve --arch {LM_ARCH}:\n{lm_out[-3000:]}")
    # the launcher draws from seed 0 and serves the pipeline's step 0 of
    # seed 0: at that seed its first row is the in-process run's
    sample = [int(t) for t in lm_out.split("sample: [", 1)[1].split("]", 1)[0].split()]
    if seed == 0 and sample != lm["tokens"]:
        fail(f"launch.serve --arch {LM_ARCH} generated {sample}, the engine in this "
             f"process {lm['tokens']} from the same seed")
    print(f"{card} | launch.serve --arch {LM_ARCH} --batch {LM_BATCH} --prompt {LM_PROMPT} "
          f"--tokens {LM_TOKENS}, full width, {lm_s:.2f} s in all: "
          + "; ".join(ln.strip() for ln in lm_out.splitlines() if ln.strip()))

    launches = {}
    for counts in (trees_n, gw_n, qs_n):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    seconds = time.perf_counter() - t_phase
    print(f"{card} | drivers and LM phase: {seconds:.2f} s; the drivers' kernel launches "
          f"{launches}")
    print(json.dumps({"lm": dict(lm, cut=cut, smoke=smoke, phase_s=seconds,
                                 serve_lm_s=lm_s)}))
    if launches.get("leaf_major", 0) == 0 or launches.get("gather", 0) == 0:
        fail(f"the drivers launched K1 and K2 {launches}: one of them never ran")
    return launches


# ---------------------------------------------------------------------------
# the training phase: granite-3-2b trained at full width, its 2-layer cut on
# card and CPU, checkpoints and restarts, integer data parallelism over gloo,
# the training driver and examples
# ---------------------------------------------------------------------------

def bits(t) -> np.ndarray:
    """A tensor's bytes as a flat uint8 array, for comparing bit for bit."""
    return t.detach().cpu().contiguous().numpy().reshape(-1).view(np.uint8)


def params_digest(params) -> str:
    import hashlib

    from repro_torch.train.tree import tree_leaves

    h = hashlib.sha256()
    for p in tree_leaves(params):
        h.update(bits(p).tobytes())
    return h.hexdigest()


def cut_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), n_layers=LM_CUT_LAYERS)


def train_full_width(seed: int, dev, card: str) -> dict:
    """Step 12a: granite-3-2b at full width, drawn on the card from the
    seed, takes TRAIN_STEPS steps of ``make_train_step``, each under the host
    mesh or without a mesh as TRAIN_MODES and TRAIN_COUNTED say (step 13a's
    first half): the two modes' median step times beside the bound, the
    torch operations a step of each mode dispatches, and the peak memory."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import use_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step, n_microbatches
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    # as the reference launcher runs: under the host mesh (1 x 1, an NCCL
    # group of this process alone), the parameters placed by the rules; a
    # "plain" step runs without a mesh on the same storage, the DTensors'
    # local tensors, as the launcher ran before it had a mesh
    with make_host_mesh(device=dev) as mesh:
        params = tfm.init_params(cfg, seed, device=dev)
        params = rules.place(params, rules.params_shardings(params, mesh))
        ostate = opt.init_opt_state(params)
        with torch.no_grad():
            plain = tree_map(lambda t: t.to_local(), params)
            plain_moments = {k: tree_map(lambda t: t.to_local(), ostate[k]) for k in ("m", "v")}
        n_params = sum(p.numel() for p in tree_leaves(params))
        step = make_train_step(cfg, opt.AdamWConfig())
        pipe = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
        losses, gnorms, step_ms, ops = [], [], [], {}

        def run(mode, s):
            nonlocal ostate
            batch = pipe.batch_at(s)
            if mode == "mesh":
                with use_mesh(mesh):
                    _, ostate, m = step(params, ostate, batch)
            else:
                _, o, m = step(plain, {**plain_moments, "step": ostate["step"]}, batch)
                ostate = {**ostate, "step": o["step"]}
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))

        for s, mode in enumerate(TRAIN_MODES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(mode, s)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        for s, mode in enumerate(TRAIN_COUNTED, len(TRAIN_MODES)):
            ops[mode] = count_ops(lambda: run(mode, s))
    peak = torch.cuda.max_memory_allocated(dev)
    ln_v = math.log(cfg.vocab_size)
    if not all(math.isfinite(v) for v in losses + gnorms) or min(gnorms) <= 0:
        fail(f"{LM_ARCH} training: losses {losses}, grad norms {gnorms}")
    if abs(losses[0] - ln_v) > TRAIN_FIRST_LOSS_TOL:
        fail(f"{LM_ARCH} training: first loss {losses[0]}, not within "
             f"{TRAIN_FIRST_LOSS_TOL} of ln({cfg.vocab_size}) = {ln_v:.4f}")
    if int(ostate["step"]) != TRAIN_STEPS:
        fail(f"{LM_ARCH} training: the optimizer's step reads {int(ostate['step'])}")
    # bounds: 6 N flops a token over the bf16 peak, or the optimizer's bytes
    # (params, grads, m and v, float32, each read and written once)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop_ms = 6 * n_params * tokens / BF16_FLOPS_PER_S * 1e3
    byte_ms = 8 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (flop_ms, "flops") if flop_ms >= byte_ms else (byte_ms, "bytes")
    # the modes' medians leave out the first step (the warm-up)
    by_mode = {mode: statistics.median(t for t, m in zip(step_ms[1:], TRAIN_MODES[1:])
                                       if m == mode) for mode in ("mesh", "plain")}
    out = dict(arch=LM_ARCH, params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               microbatches=n_microbatches(TRAIN_BATCH, cfg.microbatches), losses=losses,
               grad_norms=gnorms, modes=list(TRAIN_MODES), step_ms=step_ms,
               median_step_ms=by_mode["mesh"], plain_median_step_ms=by_mode["plain"],
               ops_a_step=ops,
               bound_ms=bound_ms, bound_by=bound_by, flop_bound_ms=flop_ms,
               byte_bound_ms=byte_ms, peak_gib=peak / 2**30)
    print(f"{card} | train {LM_ARCH} full width ({n_params} parameters), {TRAIN_STEPS} steps "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {out['microbatches']} microbatches: "
          f"losses {[round(v, 4) for v in losses]} (ln V = {ln_v:.4f}), grad norms "
          f"{[round(v, 4) for v in gnorms]}; step under the 1 x 1 mesh "
          f"{out['median_step_ms']:.1f} ms median, without a mesh "
          f"{out['plain_median_step_ms']:.1f} (after the first; each "
          f"{[(m, round(v, 1)) for m, v in zip(TRAIN_MODES, step_ms)]}); torch operations a "
          f"step {ops}; bound "
          f"{bound_ms:.3f} ms by {bound_by} "
          f"(6 N tokens over {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s: {flop_ms:.3f} ms; "
          f"{8 * 4 * n_params} optimizer bytes over {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
          f"{byte_ms:.3f} ms); peak memory {out['peak_gib']:.3f} GiB; host clock")
    return out


def count_ops(fn) -> int:
    """The torch operations ``fn()`` dispatches (forward and backward),
    counted by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def train_cut_on_card_and_host(seed: int, dev) -> tuple:
    """Step 12b: the 2-layer cut, the same weights and batch, one step on
    the card and on the host's CPU.  Returns (numbers, the card's params and
    optimizer state after the step)."""
    import torch

    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import accumulate_grads, n_microbatches
    from repro_torch.train.tree import (flatten_with_paths, path_key, tree_leaves, tree_map,
                                        unflatten_like)

    cfg = cut_config()
    params = tfm.init_params(cfg, seed, device=dev)
    batch = pipeline_for(cfg, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, seed=seed).batch_at(0)
    n_micro = n_microbatches(TRAIN_CUT_BATCH, cfg.microbatches)
    runs = []
    for where in (dev, torch.device("cpu")):
        p = tree_map(lambda a: a.detach().to(where, copy=True), params)
        t0 = time.perf_counter()
        loss, _ = accumulate_grads(cfg, p, {k: torch.from_numpy(v).to(where)
                                            for k, v in batch.items()}, n_micro)
        grads = {path_key(k): q.grad.detach().cpu().clone() for k, q in flatten_with_paths(p)}
        ostate = opt.init_opt_state(p)
        p, ostate, m = opt.adamw_update(opt.AdamWConfig(), tree_map(lambda q: q.grad, p),
                                        ostate, p)
        if where.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs.append(dict(loss=float(loss), grads=grads, params=p, opt=ostate,
                         lr=float(m["lr"]), seconds=seconds))
    card_run, cpu_run = runs
    loss_err = abs(card_run["loss"] - cpu_run["loss"])
    rel = {}
    for key, want in cpu_run["grads"].items():
        got = card_run["grads"][key].double()
        want = want.double()
        rel[key] = float((got - want).norm() / want.norm())
    worst = max(rel, key=rel.get)
    # AdamW's arithmetic: the card's update from the CPU's gradients equals
    # the CPU's within TRAIN_UPDATE_TOL of a step, on every parameter
    lr = cpu_run["lr"]
    p_same = tree_map(lambda a: a.detach().to(dev, copy=True), params)
    grads_same = unflatten_like(p_same, {k: g.to(dev) for k, g in cpu_run["grads"].items()})
    opt.adamw_update(opt.AdamWConfig(), grads_same, opt.init_opt_state(p_same), p_same)
    same_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(tree_leaves(p_same), tree_leaves(cpu_run["params"])))
    del p_same, grads_same
    # each device's own step: one AdamW step moves a parameter by about
    # lr * g / (|g| + eps), so where the two gradients differ in sign, or sit
    # near eps, the steps differ by up to 2 lr; counted where |g| is above
    # TRAIN_UPDATE_MASK of its leaf's largest
    card_params = {path_key(k): v for k, v in flatten_with_paths(card_run["params"])}
    compared = moved = opposite = 0
    for key, p_cpu in flatten_with_paths(cpu_run["params"]):
        key = path_key(key)
        g, g_card = cpu_run["grads"][key], card_run["grads"][key]
        mask = g.abs() > TRAIN_UPDATE_MASK * g.abs().max()
        diff = (card_params[key].detach().cpu() - p_cpu.detach()).abs()
        compared += int(mask.sum())
        moved += int((mask & (diff > lr / 2)).sum())
        opposite += int((mask & (torch.sign(g_card) != torch.sign(g))).sum())
    moved_share = moved / max(compared, 1)
    out = dict(loss_card=card_run["loss"], loss_cpu=cpu_run["loss"], loss_abs_diff=loss_err,
               grad_rel_l2=rel, worst_leaf=worst, lr=lr, same_grads_max_diff=same_diff,
               compared=compared, moved=moved, moved_share=moved_share, opposite=opposite,
               card_s=card_run["seconds"], cpu_s=cpu_run["seconds"])
    print(f"train {LM_ARCH} cut to {LM_CUT_LAYERS} layers (full widths), one step of "
          f"{TRAIN_CUT_BATCH} x {TRAIN_CUT_SEQ} tokens ({n_micro} microbatches) on the card and "
          f"on the host's CPU from the same weights: loss {card_run['loss']:.6f} against "
          f"{cpu_run['loss']:.6f} (|difference| {loss_err:.2e}, tolerance {TRAIN_LOSS_TOL}); "
          f"gradient relative L2 difference worst {rel[worst]:.4e} ({worst}; tolerance "
          f"{TRAIN_GRAD_REL_L2}); AdamW on the card from the CPU's gradients: max |difference| "
          f"{same_diff:.3e} (tolerance {TRAIN_UPDATE_TOL} x lr {lr:.3e}); each device's own "
          f"step where |g| > {TRAIN_UPDATE_MASK} of the leaf's max: {compared} compared, "
          f"{moved} ({moved_share:.2e}; limit {TRAIN_STEP_SHARE}) apart by over half a step, "
          f"{opposite} with gradients of opposite sign; {card_run['seconds']:.2f} s on the "
          f"card, {cpu_run['seconds']:.2f} s on the CPU")
    if loss_err > TRAIN_LOSS_TOL or rel[worst] > TRAIN_GRAD_REL_L2 or \
            same_diff > TRAIN_UPDATE_TOL * lr or moved_share > TRAIN_STEP_SHARE:
        fail(f"{LM_ARCH} cut: the card's training step differs from the CPU's: {out}")
    return out, card_run["params"], card_run["opt"]


def train_checkpoints(params, ostate, seed: int, dev) -> dict:
    """Step 12c: an async save of the cut's training state and its restore
    to the card, bit for bit; a ``RestartableLoop`` with a crash injected at
    step TRAIN_LOOP_CRASH resumes from its checkpoint."""
    import torch

    from repro_torch.checkpoint.fault_tolerance import RestartableLoop, StepWatchdog
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = cut_config()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    state = {"params": params, "opt": ostate}
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    mgr = CheckpointManager(TRAIN_DIR / "save")
    t0 = time.perf_counter()
    mgr.save(1, state, blocking=False)
    handed_s = time.perf_counter() - t0
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = mgr.restore(1, tree_map(lambda t: torch.empty(0), state), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(r.device.type == dev.type and r.dtype == t.dtype and
               np.array_equal(bits(r), bits(t))
               for r, t in zip(tree_leaves(restored), tree_leaves(state)))
    if not same:
        fail("the cut's training state restored from its checkpoint differs from what was saved")
    del restored

    train_step = make_train_step(cfg, opt.AdamWConfig())
    pipe = pipeline_for(cfg, TRAIN_LOOP_BATCH, TRAIN_LOOP_SEQ, seed=seed)
    crash = {"armed": True}

    def step_fn(st, step):
        if step == TRAIN_LOOP_CRASH and crash["armed"]:
            crash["armed"] = False
            raise RuntimeError("injected failure")
        p, o, _ = train_step(st["params"], st["opt"], pipe.batch_at(step))
        return {"params": p, "opt": o}

    t0 = time.perf_counter()
    loop = RestartableLoop(CheckpointManager(TRAIN_DIR / "loop"), ckpt_every=TRAIN_LOOP_EVERY)
    state, info = loop.run(state, step_fn, TRAIN_LOOP_STEPS, watchdog=StepWatchdog())
    loop_s = time.perf_counter() - t0
    # the state came in after one step (12b), so the optimizer has taken
    # one step more than the loop
    if info != {"restarts": 1, "steps": TRAIN_LOOP_STEPS} or \
            int(state["opt"]["step"]) != TRAIN_LOOP_STEPS + 1:
        fail(f"the restartable loop ended with {info}, optimizer step "
             f"{int(state['opt']['step'])}")
    latest = loop.manager.latest_step()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out = dict(state_bytes=state_bytes, save_handed_s=handed_s, save_s=save_s,
               restore_s=restore_s, loop=info, loop_s=loop_s, latest=latest)
    print(f"train checkpoint of the cut's state ({state_bytes} bytes): async save handed "
          f"back in {handed_s:.2f} s, written in {save_s:.2f} s, restored to the card in "
          f"{restore_s:.2f} s, bit-identical; RestartableLoop of {TRAIN_LOOP_STEPS} steps of "
          f"{TRAIN_LOOP_BATCH} x {TRAIN_LOOP_SEQ} tokens, checkpoint every {TRAIN_LOOP_EVERY}, "
          f"crash injected at step {TRAIN_LOOP_CRASH}: {info}, latest checkpoint {latest}, "
          f"{loop_s:.2f} s")
    return out


def psum_inputs(seed: int) -> np.ndarray:
    """Step 12d's fixed random tensor of each rank, (ranks, TRAIN_PSUM_SIZE)
    float32."""
    return np.random.default_rng(seed + 12).normal(
        size=(TRAIN_DP_RANKS, TRAIN_PSUM_SIZE)).astype(np.float32)


def train_dp_rank(rank: str, store: str, seed: str, device: str = "cuda") -> None:
    """One rank of step 12d, in its own process: TRAIN_DP_STEPS steps of
    ``make_integer_dp_train_step`` on the cut over a gloo group with CUDA
    tensors, then ``integer_psum`` of its row of ``psum_inputs`` on the card
    and on the CPU; prints one ``DP_RANK`` JSON line."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.tokens import pipeline_for
    from repro_torch.kernels import tree_traverse as tt
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.intreeger_allreduce import integer_psum, quantization_error_bound
    from repro_torch.train.step import make_integer_dp_train_step

    rank, seed = int(rank), int(seed)
    dist.init_process_group("gloo", store=dist.FileStore(store, TRAIN_DP_RANKS), rank=rank,
                            world_size=TRAIN_DP_RANKS)
    try:
        tt.reset_launches()
        dev = torch.device(device)
        cfg = cut_config()
        params = tfm.init_params(cfg, seed, device=dev)
        ostate = opt.init_opt_state(params)
        step = make_integer_dp_train_step(cfg, opt_cfg=opt.AdamWConfig())
        pipe = pipeline_for(cfg, TRAIN_DP_BATCH, TRAIN_DP_SEQ, seed=seed)
        losses, digests, step_ms = [], [], []
        for s in range(TRAIN_DP_STEPS):
            t0 = time.perf_counter()
            params, ostate, m = step(params, ostate, pipe.batch_at(s))
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            digests.append(params_digest(params))
        xs = psum_inputs(seed)
        on_card = integer_psum(torch.from_numpy(xs[rank]).to(dev)).cpu().numpy()
        on_cpu = integer_psum(torch.from_numpy(xs[rank])).numpy()
        exact = xs.astype(np.float64).sum(axis=0)
        print("DP_RANK " + json.dumps(dict(
            rank=rank, losses=losses, digests=digests, step_ms=step_ms,
            psum_card_equals_cpu=bool(np.array_equal(on_card.view(np.uint32),
                                                     on_cpu.view(np.uint32))),
            psum_digest=params_digest({"x": torch.from_numpy(on_card)}),
            psum_err=float(np.abs(on_card - exact).max()),
            psum_bound=quantization_error_bound(TRAIN_DP_RANKS, float(np.abs(xs).max())),
            launches=dict(tt.LAUNCHES))), flush=True)
    finally:
        dist.destroy_process_group()


def train_dp_result(outs: list, single: list, card: str) -> tuple:
    """Step 12d's checks on the ranks' lines, beside the single-process
    losses of the same batches.  Returns (numbers, each rank's kernel
    launches)."""
    ranks = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("DP_RANK ")]
        if not lines:
            fail(f"a rank of the integer data-parallel run printed no result:\n{out[-3000:]}")
        ranks.append(json.loads(lines[-1].split(" ", 1)[1]))
    first = ranks[0]
    if any(r["digests"] != first["digests"] for r in ranks[1:]):
        fail("the integer data-parallel ranks' parameters differ after a step: "
             + str([r["digests"] for r in ranks]))
    if not all(r["psum_card_equals_cpu"] for r in ranks) or \
            len({r["psum_digest"] for r in ranks}) != 1:
        fail("integer_psum on the card ranks differs from the same on the CPU, or across ranks")
    if any(r["psum_err"] > r["psum_bound"] for r in ranks):
        fail(f"integer_psum error {first['psum_err']} above the bound {first['psum_bound']}")
    if not all(np.isfinite(r["losses"]).all() for r in ranks):
        fail(f"integer data-parallel losses {first['losses']}")
    out = dict(losses=first["losses"], single_process_losses=single,
               step_ms=[r["step_ms"] for r in ranks], psum_err=first["psum_err"],
               psum_bound=first["psum_bound"])
    print(f"{card} | train integer data parallel on the cut: {TRAIN_DP_RANKS} processes on the "
          f"card over gloo (CUDA tensors), {TRAIN_DP_STEPS} steps of {TRAIN_DP_BATCH} x "
          f"{TRAIN_DP_SEQ} tokens: losses {[round(v, 6) for v in first['losses']]} beside "
          f"{[round(v, 6) for v in single]} in one process (make_train_step); the ranks' "
          f"parameters bit-identical after every step; step ms per rank {out['step_ms']}; "
          f"integer_psum of {TRAIN_PSUM_SIZE} floats a rank: the card ranks' result equals "
          f"the CPU ranks' bit for bit, max error {first['psum_err']:.3e} (bound "
          f"{first['psum_bound']:.3e})")
    return out, [r["launches"] for r in ranks]


def train_single_process(seed: int, dev) -> list:
    """The losses of TRAIN_DP_STEPS steps of ``make_train_step`` on step
    12d's batches, in this process."""
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    cfg = cut_config()
    params = tfm.init_params(cfg, seed, device=dev)
    ostate = opt.init_opt_state(params)
    step = make_train_step(cfg, opt.AdamWConfig())
    pipe = pipeline_for(cfg, TRAIN_DP_BATCH, TRAIN_DP_SEQ, seed=seed)
    losses = []
    for s in range(TRAIN_DP_STEPS):
        params, ostate, m = step(params, ostate, pipe.batch_at(s))
        losses.append(float(m["loss"]))
    return losses


def train_drivers_result(outs: list, card: str) -> list:
    """Step 12e's checks on the drivers' output; their launch counts."""
    launches = []
    for args, out in zip(TRAIN_DRIVERS, outs):
        launches.append(driver_launches(out, args))
        name = args[0].rsplit(".", 1)[1]
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("done:", "integer psum", "float32"))]
        if name == "train":
            done = [ln for ln in out.splitlines() if ln.startswith("done:")]
            first, last = (float(v) for v in done[-1].split("loss ", 1)[1].split(";")[0]
                           .split(" -> ")) if done else (0.0, 0.0)
            if not done or not last < first - TRAIN_DRIVER_DESCENT:
                fail(f"python -m {' '.join(args)}: the loss did not descend by "
                     f"{TRAIN_DRIVER_DESCENT}:\n{out[-3000:]}")
        elif name == "train_lm":
            if "with 1 recovered crash(es)" not in out:
                fail(f"python -m {' '.join(args)}:\n{out[-3000:]}")
        elif "bit-identical True" not in out:
            fail(f"python -m {' '.join(args)}:\n{out[-3000:]}")
        print(f"{card} | python -m {' '.join(args)}: " + "; ".join(lines)
              + f"; kernel launches {launches[-1]}")
    return launches


def train_phase(seed: int, dev, card: str) -> dict:
    """Phase 12.  The full-width model trains first and alone (its memory
    and times are the card's and this process's only), then the cut's card
    and CPU step; then the drivers and the two data-parallel ranks run as
    processes while this process checkpoints and restarts the cut and runs
    the single-process comparison.  Returns the kernel launches of the
    whole phase, which must all be 0: the training path runs no hand-written
    kernel."""
    import torch

    from repro_torch.kernels import tree_traverse as tt

    t_phase = time.perf_counter()
    tt.reset_launches()
    full = train_full_width(seed, dev, card)
    torch.cuda.empty_cache()
    cut, params, ostate = train_cut_on_card_and_host(seed, dev)

    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    store = TRAIN_DIR / "dp_store"
    store.unlink(missing_ok=True)
    drivers = start_modules([list(a) for a in TRAIN_DRIVERS], wrapper=DRIVER_WRAPPER)
    ranks = start_modules([[str(r), str(store), str(seed)] for r in range(TRAIN_DP_RANKS)],
                          wrapper=TRAIN_DP_PROGRAM)
    ckpt = train_checkpoints(params, ostate, seed, dev)
    del params, ostate
    torch.cuda.empty_cache()
    single = train_single_process(seed, dev)
    here = dict(tt.LAUNCHES)
    dp, dp_launches = train_dp_result(finish_modules(ranks), single, card)
    driver_counts = train_drivers_result(finish_modules(drivers), card)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    launches = dict(here)
    for counts in (*dp_launches, *driver_counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    seconds = time.perf_counter() - t_phase
    print(f"{card} | training phase: {seconds:.2f} s; kernel launches {launches}")
    print(json.dumps({"train": dict(full=full, cut={k: v for k, v in cut.items()
                                                    if k != "grad_rel_l2"},
                                    checkpoint=ckpt, dp=dp, phase_s=seconds)}))
    if any(launches.values()):
        fail(f"the training path launched a hand-written kernel: {launches}")
    return launches


# ---------------------------------------------------------------------------
# the mesh phase: the sharding slice's mesh branches on the card
# ---------------------------------------------------------------------------

def mesh_tree_keys(seed: int, n_features: int, dev):
    """Step 13b's rows: MESH_TREE_ROWS x ``n_features`` normal(0, 1) floats
    drawn on the card from the seed (the same bits in every process on the
    card), as FlInt keys."""
    import torch

    from repro_torch.core.flint import float_to_key

    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    return float_to_key(torch.randn((MESH_TREE_ROWS, n_features), generator=gen, device=dev))


def mesh_rank(role: str, rank: str, world: str, store: str, seed: str, out_dir: str,
              device: str = "cuda") -> None:
    """One rank of step 13b (``role`` "tree") or of steps 13c to 13e ("lm"),
    in its own process of a gloo group of ``world`` processes with CUDA
    tensors; prints one ``MESH_RANK`` JSON line with its numbers, its
    kernel launches and its host-staged collectives."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import tree_traverse as tt
    from repro_torch.sharding.ops import STAGED

    rank, world, seed = int(rank), int(world), int(seed)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        tt.reset_launches()
        run = mesh_tree_rank if role == "tree" else mesh_lm_rank
        out = run(rank, seed, Path(out_dir), torch.device(device))
        print("MESH_RANK " + json.dumps(dict(out, role=role, rank=rank,
                                             launches=dict(tt.LAUNCHES),
                                             staged=dict(STAGED))), flush=True)
    finally:
        dist.destroy_process_group()


def mesh_tree_rank(rank: int, seed: int, out_dir: Path, dev) -> dict:
    """Step 13b in one rank: ``tree_serve_step`` under the (data 2, model
    2) mesh on the full rows; its rows' scores and predictions saved for the
    main process; the collectives inside the step counted; the step's
    device time on this rank and its time end to end (from a barrier until
    every rank is done)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.serving import tree_serve_step
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.sharding.ops import use_mesh

    mesh = compat_make_mesh(MESH_TREE_SHAPE, ("data", "model"), device=dev)
    t = np.load(out_dir / "tables.npz")
    tables = {k: torch.from_numpy(t[k]).to(dev) for k in MESH_TABLES}
    depth = int(t["depth"])
    keys = mesh_tree_keys(seed, int(t["n_features"]), dev)
    step = lambda: tree_serve_step(tables, keys, depth, device=dev)
    with use_mesh(mesh):
        step()
        torch.cuda.synchronize()
        with CommDebugMode() as cm:
            acc, preds = step()
            torch.cuda.synchronize()
        rank_ms = cuda_ms(step, MESH_TREE_REPS)
        e2e = []
        for _ in range(MESH_TREE_REPS):
            dist.barrier()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            dist.barrier()
            e2e.append((time.perf_counter() - t0) * 1e3)
    acc, preds = acc.to_local(), preds.to_local()
    np.save(out_dir / f"acc_{rank}.npy", acc.view(torch.int32).cpu().numpy())
    np.save(out_dir / f"preds_{rank}.npy", preds.cpu().numpy())
    return dict(coords=[mesh.axis_index(a) for a in mesh.axis_names], rows=acc.shape[0],
                comms=cm.get_total_counts(), rank_ms=rank_ms, e2e_ms=statistics.median(e2e))


def mesh_logits_run(engine, batch: dict, mesh, n_tokens: int) -> dict:
    """A prefill and ``n_tokens`` greedy decode steps without a mesh (after
    one warm-up run), then the same prefill and steps under ``mesh`` fed the
    same tokens: the
    largest |logits difference| over the prefill and every step, the
    argmax agreement, the collectives of the prefill and of one step under
    the mesh, and both runs' host-clock times."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.sharding.ops import use_mesh

    def run(feed):
        out, times = [], []
        t0 = time.perf_counter()
        logits, cache = engine.prefill(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out.append(logits)
        for i in range(n_tokens):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None] if feed is None \
                else feed[i]
            t0 = time.perf_counter()
            logits, cache = engine.decode(cache, nxt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            out.append(logits)
        return out, times

    run(None)  # warm-up: the first call pays for the allocator and cuBLAS handles
    ref, ref_times = run(None)
    feed = [torch.argmax(lg, dim=-1).to(torch.int32)[:, None] for lg in ref[:-1]]
    with use_mesh(mesh):
        with CommDebugMode() as cm:
            _, cache = engine.prefill(batch)
        prefill_comms = cm.get_total_counts()
        with CommDebugMode() as cm:
            engine.decode(cache, feed[0])
        decode_comms = cm.get_total_counts()
        del cache
        got, times = run(feed)
    errs = [float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)]
    agree = float(np.mean([torch.equal(g.argmax(-1), r.argmax(-1)) for g, r in zip(got, ref)]))
    return dict(max_err=max(errs), errs=errs, argmax_agree=agree, prefill_comms=prefill_comms,
                decode_comms=decode_comms, prefill_ms=times[0] * 1e3,
                decode_ms=statistics.median(times[1:]) * 1e3, ref_prefill_ms=ref_times[0] * 1e3,
                ref_decode_ms=statistics.median(ref_times[1:]) * 1e3)


def mesh_lm_rank(rank: int, seed: int, out_dir: Path, dev) -> dict:
    """Steps 13c to 13e in one of two ranks: granite-3-2b at full width over
    (data 1, model 2) against the same engine without a mesh; its 2-layer
    cut at batch 1 over (data 2, model 1), the decode sequence-sharded; one
    olmoe-1b-7b block at full width under expert parallelism over model 2
    against ``moe_block`` without a mesh, and the olmoe 2-layer cut's
    prefill; one train step of the granite cut over (data 2, model 1)
    against the step without a mesh."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import Init
    from repro_torch.models.moe import moe_block, moe_params
    from repro_torch.serve.engine import LMEngine
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import gather, use_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import flatten_with_paths, path_key, tree_leaves
    from torch.distributed.tensor.debug import CommDebugMode

    tp = compat_make_mesh((1, MESH_LM_RANKS), ("data", "model"), device=dev)
    dp = compat_make_mesh((MESH_LM_RANKS, 1), ("data", "model"), device=dev)
    out = {}
    t_step = time.perf_counter()

    # 13c: granite-3-2b at full width, heads over model; its cut's decode
    # at batch 1 with the cache's sequence over data
    cfg = get_config(LM_ARCH)
    batch = {k: v for k, v in pipeline_for(cfg, LM_BATCH, LM_PROMPT, seed=seed)
             .batch_at(0).items() if k != "labels"}
    engine = LMEngine(cfg, tfm.init_params(cfg, seed, device=dev),
                      max_seq=LM_PROMPT + LM_TOKENS, device=dev)
    out["granite"] = mesh_logits_run(engine, batch, tp, LM_TOKENS)
    del engine
    torch.cuda.empty_cache()
    cut = cut_config()
    engine = LMEngine(cut, tfm.init_params(cut, seed, device=dev),
                      max_seq=LM_PROMPT + LM_TOKENS, device=dev)
    out["granite_cut_batch1"] = mesh_logits_run(engine, {"tokens": batch["tokens"][:1]}, dp,
                                                LM_TOKENS)
    del engine
    out["granite_s"] = time.perf_counter() - t_step

    # 13d: one olmoe-1b-7b block at full width, experts over model, and
    # its 2-layer cut's prefill
    t_step = time.perf_counter()
    moe_cfg = dataclasses.replace(get_config(MESH_MOE_ARCH), n_layers=LM_CUT_LAYERS)
    init = Init(torch.Generator(device=dev).manual_seed(seed + 7), dev)
    params = tfm.cast_matmul_weights(moe_params(init, moe_cfg.d_model, moe_cfg.n_experts,
                                                moe_cfg.d_ff))
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    x = torch.randn(MESH_MOE_TOKENS + (moe_cfg.d_model,), generator=gen,
                    device=dev).to(torch.bfloat16)
    kw = dict(n_experts=moe_cfg.n_experts, k=moe_cfg.experts_per_token, act=moe_cfg.act,
              capacity_factor=moe_cfg.moe_capacity_factor)
    with torch.inference_mode():
        y_ref, aux_ref = moe_block(params, x, **kw)
        ref_ms = cuda_ms(lambda: moe_block(params, x, **kw), MESH_REPS)
        with use_mesh(tp):
            with CommDebugMode() as cm:
                y, aux = moe_block(params, x, **kw)
            mesh_ms = cuda_ms(lambda: moe_block(params, x, **kw), MESH_REPS)
    out["moe"] = dict(max_err=float((y.float() - y_ref.float()).abs().max()),
                      max_abs=float(y_ref.float().abs().max()),
                      aux_err=float((aux - aux_ref).abs()), comms=cm.get_total_counts(),
                      ms=mesh_ms, ref_ms=ref_ms, tokens=list(MESH_MOE_TOKENS))
    del params, x, y, y_ref
    engine = LMEngine(moe_cfg, tfm.init_params(moe_cfg, seed, device=dev),
                      max_seq=LM_PROMPT + MESH_MOE_DECODE, device=dev)
    out["moe_cut"] = mesh_logits_run(
        engine, {"tokens": batch["tokens"] % moe_cfg.vocab_size}, tp, MESH_MOE_DECODE)
    del engine
    torch.cuda.empty_cache()
    out["moe_s"] = time.perf_counter() - t_step

    # 13e: one train step of the granite cut, the batch over data, with
    # MESH_TRAIN_OPT, whose first step shows the gradients in the parameters
    t_step = time.perf_counter()
    tbatch = pipeline_for(cut, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, seed=seed).batch_at(0)
    step = make_train_step(cut, opt.AdamWConfig(**MESH_TRAIN_OPT))
    before = tfm.init_params(cut, seed, device=dev)
    single = tfm.init_params(cut, seed, device=dev)
    _, _, m1 = step(single, opt.init_opt_state(single), tbatch)
    placed = tfm.init_params(cut, seed, device=dev)
    placed = rules.place(placed, rules.params_shardings(placed, dp))
    ostate = opt.init_opt_state(placed)
    local_bytes = sum(p.to_local().numel() * 4 for p in tree_leaves(placed))
    with use_mesh(dp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed, ostate, m2 = step(placed, ostate, tbatch)
        torch.cuda.synchronize()
        mesh_step_ms = (time.perf_counter() - t0) * 1e3
    # each leaf's update against one process's, relative L2
    gaps = {}
    for (path, p), q, p0 in zip(flatten_with_paths(placed), tree_leaves(single),
                                tree_leaves(before)):
        want = q.detach().double()
        gaps[path_key(path)] = float((gather(p).detach().double() - want).norm()
                                     / (want - p0.double()).norm())
    worst = max(gaps, key=gaps.get)
    del before
    gn, single_gn = float(m2["grad_norm"]), float(m1["grad_norm"])
    out["train"] = dict(loss=float(m2["loss"]), single_loss=float(m1["loss"]),
                        step=int(ostate["step"]), step_ms=mesh_step_ms,
                        update_gap=gaps[worst], worst_leaf=worst, grad_norm=gn,
                        single_grad_norm=single_gn, norm_gap=abs(gn - single_gn) / single_gn,
                        lr=float(m2["lr"]),
                        local_param_bytes=local_bytes,
                        param_bytes=sum(p.numel() * 4 for p in tree_leaves(single)))
    out["train_s"] = time.perf_counter() - t_step
    return out


def mesh_one_card(seed: int, dev, card: str) -> dict:
    """Step 13a: one train step of the granite cut under a (1, 1) mesh on
    the card (an NCCL group of this process alone), its parameters placed
    by ``params_shardings``, against the same step without a mesh: the loss
    and every parameter bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import gather, use_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import tree_map

    cfg = cut_config()
    batch = pipeline_for(cfg, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, seed=seed).batch_at(0)
    step = make_train_step(cfg, opt.AdamWConfig())
    plain = tfm.init_params(cfg, seed, device=dev)
    plain, _, m1 = step(plain, opt.init_opt_state(plain), batch)
    want = (bits(m1["loss"]).tobytes(), params_digest(plain))
    del plain
    with make_host_mesh(device=dev) as mesh, use_mesh(mesh):
        backend = dist.get_backend()
        placed = tfm.init_params(cfg, seed, device=dev)
        placed = rules.place(placed, rules.params_shardings(placed, mesh))
        placed, _, m2 = step(placed, opt.init_opt_state(placed), batch)
        got = (bits(m2["loss"]).tobytes(), params_digest(tree_map(gather, placed)))
    del placed
    torch.cuda.empty_cache()
    if got != want:
        fail(f"the cut's train step under the 1 x 1 mesh differs from the step without a "
             f"mesh: loss {float(m2['loss'])!r} against {float(m1['loss'])!r}, parameters "
             f"{got[1][:16]} against {want[1][:16]}")
    print(f"{card} | mesh 13a: {LM_ARCH} cut to {LM_CUT_LAYERS} layers, one train step of "
          f"{TRAIN_CUT_BATCH} x {TRAIN_CUT_SEQ} tokens under a 1 x 1 mesh ({backend} group of "
          f"this process alone, parameters placed by params_shardings): loss "
          f"{float(m2['loss']):.6f} and every parameter bit-identical to the step without a "
          f"mesh")
    return dict(loss=float(m2["loss"]), backend=backend, bit_identical=True)


def mesh_tree_check(outs: list, ref: tuple, ref_ms: float, card: str) -> dict:
    """Step 13b's checks on the tree ranks' lines and files against the
    one-process step's result."""
    acc_ref, preds_ref = (t.cpu().numpy() for t in ref)
    acc_ref = acc_ref.view(np.int32)
    ranks = mesh_rank_lines(outs, "tree")
    per = MESH_TREE_ROWS // len(ranks)
    for r in ranks:
        i = r["rank"]
        acc = np.load(MESH_DIR / f"acc_{i}.npy")
        preds = np.load(MESH_DIR / f"preds_{i}.npy")
        lo, hi = i * per, (i + 1) * per
        if r["rows"] != per or not np.array_equal(acc, acc_ref[lo:hi]) or \
                not np.array_equal(preds, preds_ref[lo:hi]):
            fail(f"tree_serve_step on the mesh: rank {i} (coordinates {r['coords']}) differs "
                 f"from the one-process step on rows [{lo}, {hi})")
        if r["comms"]:
            fail(f"tree_serve_step on the mesh ran {r['comms']} collectives on rank {i}")
    out = dict(rows=MESH_TREE_ROWS, mesh=list(MESH_TREE_SHAPE),
               rank_ms=[r["rank_ms"] for r in ranks], e2e_ms=max(r["e2e_ms"] for r in ranks),
               one_process_ms=ref_ms, comms=[r["comms"] for r in ranks])
    print(f"{card} | mesh 13b: tree_serve_step of the full-width forest on {MESH_TREE_ROWS} "
          f"rows ({MESH_TREE_ROWS * N_FEATURES * 4} bytes of keys), {len(ranks)} processes on "
          f"the card as (data {MESH_TREE_SHAPE[0]}, model {MESH_TREE_SHAPE[1]}) over gloo: "
          f"every rank's {per} rows bit-identical to the "
          f"one-process step, collectives inside the step {out['comms']}; device ms per rank "
          f"{[round(v, 3) for v in out['rank_ms']]} (median of {MESH_TREE_REPS}), end to end "
          f"{out['e2e_ms']:.3f} ms (barrier to barrier, host clock); one process on all rows "
          f"{ref_ms:.3f} ms (device)")
    return out


def mesh_rank_lines(outs: list, role: str) -> list:
    ranks = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("MESH_RANK ")]
        if not lines:
            fail(f"a {role} rank of the mesh phase printed no result:\n{out[-3000:]}")
        ranks.append(json.loads(lines[-1].split(" ", 1)[1]))
    return sorted(ranks, key=lambda r: r["rank"])


def mesh_lm_check(outs: list, card: str) -> dict:
    """Steps 13c to 13e's checks on the two LM ranks' lines."""
    ranks = mesh_rank_lines(outs, "lm")
    r = ranks[0]
    for name, tol in (("granite", MESH_LOGITS_TOL), ("granite_cut_batch1", MESH_SEQ_TOL),
                      ("moe_cut", MESH_LOGITS_TOL)):
        for rk in ranks:
            run = rk[name]
            if not run["max_err"] <= tol or run["decode_comms"] == 0 and name != "moe_cut" \
                    or run["prefill_comms"] == 0 and name != "granite_cut_batch1":
                fail(f"mesh {name} on rank {rk['rank']}: {run} (logits tolerance {tol})")
    moe = [rk["moe"] for rk in ranks]
    if any(not m["max_err"] <= MESH_MOE_REL_TOL * m["max_abs"] or m["aux_err"] > 1e-4
           or m["comms"] == 0 for m in moe):
        fail(f"olmoe block under expert parallelism: {moe} (tolerance {MESH_MOE_REL_TOL} of "
             "the largest |output|)")
    tr = [rk["train"] for rk in ranks]
    if any(abs(t["loss"] - t["single_loss"]) > MESH_TRAIN_TOL or t["step"] != 1
           or not t["update_gap"] <= MESH_TRAIN_UPDATE_TOL
           or not t["norm_gap"] <= MESH_TRAIN_NORM_TOL for t in tr):
        fail(f"the sharded train step: {tr} (loss tolerance {MESH_TRAIN_TOL}, update "
             f"{MESH_TRAIN_UPDATE_TOL}, gradient norm {MESH_TRAIN_NORM_TOL})")
    g, c, m, mc, t = r["granite"], r["granite_cut_batch1"], r["moe"], r["moe_cut"], r["train"]
    print(f"{card} | mesh 13c: {LM_ARCH} at full width, 2 processes on the card as (data 1, "
          f"model 2) over gloo, batch {LM_BATCH} x prompt {LM_PROMPT} then {LM_TOKENS} greedy "
          f"tokens fed alike: logits max |mesh - no mesh| {g['max_err']:.4g} (tolerance "
          f"{MESH_LOGITS_TOL}), argmax agreement {g['argmax_agree']:.3f}, collectives "
          f"{g['prefill_comms']} in the prefill and {g['decode_comms']} in a decode step; "
          f"prefill {g['prefill_ms']:.1f} ms against {g['ref_prefill_ms']:.1f} without the mesh, "
          f"decode {g['decode_ms']:.1f} ms a token against {g['ref_decode_ms']:.1f} (host clock, "
          f"rank 0)")
    print(f"{card} | mesh 13c: {LM_ARCH} cut to {LM_CUT_LAYERS} layers at batch 1 as (data 2, "
          f"model 1), the decode's cache sequence over data (flash decode, pmax + psum): "
          f"logits max |mesh - no mesh| {c['max_err']:.4g} (tolerance {MESH_SEQ_TOL}), "
          f"collectives in a decode step "
          f"{c['decode_comms']}; decode {c['decode_ms']:.1f} ms a token against "
          f"{c['ref_decode_ms']:.1f}")
    print(f"{card} | mesh 13d: {MESH_MOE_ARCH} block at full width ({MESH_MOE_TOKENS[0]} x "
          f"{MESH_MOE_TOKENS[1]} tokens, capacity factor from its config) under expert "
          f"parallelism over model 2: max |mesh - no mesh| {m['max_err']:.4g} of outputs up to "
          f"{m['max_abs']:.4g} (tolerance {MESH_MOE_REL_TOL} of that), aux {m['aux_err']:.2e} "
          f"apart, {m['comms']} collectives; {m['ms']:.3f} ms against {m['ref_ms']:.3f} ms "
          f"(device); its {LM_CUT_LAYERS}-layer cut's prefill and {MESH_MOE_DECODE} decode "
          f"steps: logits max |difference| {mc['max_err']:.4g}")
    print(f"{card} | mesh 13e: {LM_ARCH} cut, one train step of {TRAIN_CUT_BATCH} x "
          f"{TRAIN_CUT_SEQ} tokens as (data 2, model 1): loss {t['loss']:.6f} against "
          f"{t['single_loss']:.6f} in one process (tolerance {MESH_TRAIN_TOL}); with AdamW "
          f"{MESH_TRAIN_OPT}: the update to every leaf within {t['update_gap']:.3e} (relative "
          f"L2, worst {t['worst_leaf']}; tolerance {MESH_TRAIN_UPDATE_TOL}) of the one-process "
          f"step's, gradient norm {t['grad_norm']:.6f} against {t['single_grad_norm']:.6f} "
          f"({t['norm_gap']:.2e} apart; tolerance {MESH_TRAIN_NORM_TOL}); "
          f"{t['local_param_bytes']} of {t['param_bytes']} parameter bytes on each rank; step "
          f"{t['step_ms']:.1f} ms (host clock)")
    print(f"{card} | mesh ranks' seconds: granite {[rk['granite_s'] for rk in ranks]}, olmoe "
          f"{[rk['moe_s'] for rk in ranks]}, train {[rk['train_s'] for rk in ranks]}; "
          f"collectives staged through the host {[rk['staged'] for rk in ranks]}")
    return dict(granite=g, granite_cut_batch1=c, moe=m, moe_cut=mc, train=t,
                staged=[rk["staged"] for rk in ranks])


def mesh_phase(ir, seed: int, dev, card: str) -> dict:
    """Phase 13.  The tree ranks run first (this process computes the
    one-process step meanwhile), then the two LM ranks while this process
    runs step 13a.  Returns the kernel launches of the whole phase, which
    must all be 0: the mesh branches run no hand-written kernel."""
    import torch

    from repro_torch.core.serving import tree_serve_step
    from repro_torch.kernels import tree_traverse as tt

    t_phase = time.perf_counter()
    tt.reset_launches()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    lm = ir.materialize("leaf_major")
    np.savez(MESH_DIR / "tables.npz", depth=lm.max_depth, n_features=N_FEATURES,
             **{k: getattr(lm, k) for k in MESH_TABLES})
    n = MESH_TREE_SHAPE[0] * MESH_TREE_SHAPE[1]
    trees = start_modules([["tree", str(r), str(n), str(MESH_DIR / "tree_store"), str(seed),
                            str(MESH_DIR)] for r in range(n)], wrapper=MESH_PROGRAM)
    keys = mesh_tree_keys(seed, N_FEATURES, dev)
    tables = {k: torch.from_numpy(getattr(lm, k)).to(dev) for k in MESH_TABLES}
    ref = tree_serve_step(tables, keys, lm.max_depth, device=dev)
    ref_ms = cuda_ms(lambda: tree_serve_step(tables, keys, lm.max_depth, device=dev),
                     MESH_TREE_REPS)
    del keys, tables
    tree_outs = finish_modules(trees)
    tree = mesh_tree_check(tree_outs, ref, ref_ms, card)
    del ref
    torch.cuda.empty_cache()

    lms = start_modules([["lm", str(r), str(MESH_LM_RANKS), str(MESH_DIR / "lm_store"),
                          str(seed), str(MESH_DIR)] for r in range(MESH_LM_RANKS)],
                        wrapper=MESH_PROGRAM)
    one_card = mesh_one_card(seed, dev, card)
    here = dict(tt.LAUNCHES)
    lm_outs = finish_modules(lms)
    lm_out = mesh_lm_check(lm_outs, card)
    shutil.rmtree(MESH_DIR, ignore_errors=True)

    launches = dict(here)
    for r in mesh_rank_lines(tree_outs, "tree") + mesh_rank_lines(lm_outs, "lm"):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    seconds = time.perf_counter() - t_phase
    print(f"{card} | mesh phase: {seconds:.2f} s; kernel launches {launches}")
    print(json.dumps({"mesh": dict(one_card=one_card, tree=tree, lm=lm_out, phase_s=seconds)}))
    if any(launches.values()):
        fail(f"the mesh branches launched a hand-written kernel: {launches}")
    return launches


# ---------------------------------------------------------------------------
# the sharded-step and dry-run phase: fault D's repair on the card, and the
# dry run of the production meshes on the host
# ---------------------------------------------------------------------------

def split_control(n: int):
    """A context in which the model computes each layer that 14c and 14d
    split over a ``model`` axis of ``n`` as the ranks would, in one process,
    in training, ``prefill`` and ``decode_step``: every column-parallel
    matmul (``wq``/``wk``/``wv``/``w_gate``/``w_up``, the SSM's
    in-projection) as ``n`` products of a rank's columns, its input
    gradient as their float32 partials summed in rank order and rounded
    once; attention on each share's heads; the SSM on each share's heads,
    each share's parameters taken here by head (each head's channels of z
    and x in ``w_in``, ``conv_w`` and ``norm_gamma``, its dt column and its
    leaves) and its r-th ``state / n`` columns and conv rows of B and of C,
    its conv history's channels and state alike, B and C joined from the
    shares after the conv (their gradients the shares' float32 gradients
    summed in rank order, rounded once), the gated norm's float32 sums of
    squares summed in rank order; every row-parallel one (``wo``/
    ``w_down``/the SSM's ``w_out``) as the float32 partials of the shares
    summed and rounded once.  A parameter the shares read in parts
    (``w_in``, ``conv_w``, the per-head leaves) gets their float32
    gradients summed, as the ranks' are over ``model``.  A vocabulary that
    divides ``n`` is split as the ranks split it: each share's embedding
    rows summed, the logits as each share's columns of the head, and the
    cross-entropy from those columns, their maxima, sums of exponentials
    and picked logits joined in rank order.  The global gradient norm is
    taken as the ranks take it (``optimizer.sharded_global_norm``): a leaf
    that the rules split over ``model`` as each rank's block's sum of
    squares, summed in rank order.  Each share has a rank's shape and
    layout, so each product and sum does too.  The per-head algebra is the
    layer's own (``ssm._causal_conv``, ``_ssd_scan``, ``_ssd_decode_heads``);
    which heads, channels and columns make a share, and how the shares are
    joined, are written here.  No collective and no mesh code runs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers, ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    from repro_torch.train import optimizer as opt
    from repro_torch.train.tree import flatten_with_paths

    class Columns(torch.autograd.Function):
        """``x`` times each share's weight (one per rank)."""

        @staticmethod
        def forward(ctx, x, *ws):
            ctx.save_for_backward(x, *ws)
            return tuple(x @ c for c in ws)

        @staticmethod
        def backward(ctx, *gs):
            x, *ws = ctx.saved_tensors
            gx = sum(g.float() @ c.float().t() for g, c in zip(gs, ws)).to(x.dtype)
            return (gx, *(x.reshape(-1, c.shape[0]).t() @ g.reshape(-1, c.shape[1])
                          for g, c in zip(gs, ws)))

    def columns(x, w):
        return Columns.apply(x, *(c.contiguous() for c in w.to(x.dtype).chunk(n, 1)))

    class Rows(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, *ys):
            ws = [c.contiguous() for c in w.chunk(n, 0)]
            ctx.save_for_backward(*ys, *ws)
            return sum(y.float() @ c.float() for y, c in zip(ys, ws))

        @staticmethod
        def backward(ctx, g):
            saved = ctx.saved_tensors
            ys, ws = saved[:n], saved[n:]
            g = g.to(ws[0].dtype)
            gw = torch.cat([y.reshape(-1, c.shape[0]).t() @ g.reshape(-1, c.shape[1])
                            for y, c in zip(ys, ws)], 0)
            return (gw, *(g @ c.t() for c in ws))

    def attention(params, x, dims, *, positions, causal=True, window=0, rope_theta=10000.0,
                  q_chunk=512, kv_cache=None, cache_pos=None):
        b, s, _ = x.shape
        h, kh, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
        if kv_cache is not None or h % n or kh % n:
            raise ValueError("the split control takes a training layer whose heads divide")
        q, k, v = (columns(x, params[w]) for w in ("wq", "wk", "wv"))
        outs = []
        for r in range(n):
            xq = layers.apply_rope(q[r].reshape(b, s, h // n, dh), positions, rope_theta)
            xk = layers.apply_rope(k[r].reshape(b, s, kh // n, dh), positions, rope_theta)
            out = layers._chunked_softmax_attn(
                xq.reshape(b, s, kh // n, h // kh, dh), xk, v[r].reshape(b, s, kh // n, dh),
                causal=causal, window=window, q_chunk=q_chunk)
            outs.append(out.reshape(b, s, h // n * dh))
        return Rows.apply(params["wo"].to(x.dtype), *outs).to(x.dtype), None

    def mlp(params, x, act="silu", d_ff=None):
        a = layers.act_fn(act)
        gate = columns(x, params["w_gate"])
        up = columns(x, params["w_up"])
        return Rows.apply(params["w_down"].to(x.dtype),
                          *(a(gt) * u for gt, u in zip(gate, up))).to(x.dtype)

    def heads(t, dim, r, h):
        """``t``'s entries of share ``r``'s heads along ``dim``, which holds
        ``h`` heads' entries, each head's together and in head order."""
        hl = h // n
        return t.unflatten(dim, (h, -1)).narrow(dim, r * hl, hl).flatten(dim, dim + 1)

    def ssm_share(params, r, d_inner, h, state):
        # share r's heads: each head's channels of z and x (w_in's columns,
        # conv_w's rows, norm_gamma), its dt column and its leaves; and the
        # r-th state / n of B's and of C's columns and conv rows
        sl = state // n
        z, xw, b, c, dt = params["w_in"].split([d_inner, d_inner, state, state, h], 1)
        conv_x, conv_b, conv_c = params["conv_w"].split([d_inner, state, state], 0)
        share = {"w_in": torch.cat([heads(z, 1, r, h), heads(xw, 1, r, h), b.narrow(1, r * sl, sl),
                                    c.narrow(1, r * sl, sl), heads(dt, 1, r, h)], 1),
                 "conv_w": torch.cat([heads(conv_x, 0, r, h), conv_b.narrow(0, r * sl, sl),
                                      conv_c.narrow(0, r * sl, sl)], 0),
                 "norm_gamma": heads(params["norm_gamma"], 0, r, h)}
        share.update({k: heads(params[k], 0, r, h) for k in ("a_log", "dt_bias", "d_skip")})
        return share

    def ssm_shares(params, d_model, expand, state):
        d_inner, h, _ = ssm.ssm_dims(d_model, expand, state)
        if h % n or state % n:
            raise ValueError("the split control takes an SSM layer whose heads and state divide")
        return d_inner, h, [ssm_share(params, r, d_inner, h, state) for r in range(n)]

    class Joined(torch.autograd.Function):
        """The shares' [B_r | C_r] channels after the conv, joined in rank
        order along the last dimension: one copy a share, each share's
        gradient its own; backward their float32 sum in rank order,
        rounded once, cut back into the shares' channels."""

        @staticmethod
        def forward(ctx, *bcs):
            ctx.width = bcs[0].shape[-1]
            joined = torch.cat(bcs, -1)
            return tuple(joined.clone() for _ in bcs)

        @staticmethod
        def backward(ctx, *gs):
            total = sum(g.float() for g in gs).to(gs[0].dtype)
            return tuple(total.split(ctx.width, -1))

    def b_and_c(joined, state):
        # B and C whole from the joined [B_0 | C_0 | B_1 | C_1 | ...]
        parts = joined.unflatten(-1, (n, 2, state // n))
        return parts[..., 0, :].flatten(-2), parts[..., 1, :].flatten(-2)

    def history(ins, cl, sl):
        # the whole conv history's channels: every share's x, then its B,
        # then its C
        return torch.cat([t[..., a:a + w] for a, w in ((0, cl), (cl, sl), (cl + sl, sl))
                          for t in ins], -1)

    def normed(gs, shares, d_inner, dtype):
        # the gated norm: each share's channels over the root mean square of
        # all d_inner, its float32 sums of squares added in rank order
        total = sum((g * g).sum(dim=-1, keepdim=True) for g in gs)
        return [((g * torch.rsqrt(total / d_inner + 1e-6)) * (1.0 + sh["norm_gamma"].float())
                 ).to(dtype) for g, sh in zip(gs, shares)]

    def ssd_forward(params, x, *, d_model, expand, state, chunk=128, return_final_state=False):
        d_inner, h, shares = ssm_shares(params, d_model, expand, state)
        cl, hl = d_inner // n, h // n
        s_real = x.shape[1]
        if s_real % chunk:
            x = F.pad(x, (0, 0, 0, (-s_real) % chunk))
        sl = state // n
        projs = Columns.apply(x, *(sh["w_in"].to(x.dtype) for sh in shares))
        split = [proj.split([cl, cl + 2 * sl, hl], -1) for proj in projs]
        ins = [conv_in for _, conv_in, _ in split]
        convs = [ssm._causal_conv(t, sh["conv_w"]).split([cl, 2 * sl], -1)
                 for t, sh in zip(ins, shares)]
        joined = Joined.apply(*(bc for _, bc in convs))
        gs, finals = [], []
        for sh, (z, _, dt), (xs, _), whole in zip(shares, split, convs, joined):
            b, c = b_and_c(whole, state)
            y, s_run = ssm._ssd_scan(sh, xs, b, c, dt, chunk=chunk, s_real=s_real)
            gs.append(y.float() * layers.silu(z).float())
            finals.append(s_run)
        ys = normed(gs, shares, d_inner, x.dtype)
        out = Rows.apply(params["w_out"].to(x.dtype), *ys).to(x.dtype)[:, :s_real]
        if not return_final_state:
            return out
        conv = history([t[:, s_real - (ssm.CONV_K - 1):s_real] for t in ins], cl, sl)
        return out, {"conv": conv, "ssm": torch.cat(finals, 1)}

    def ssd_decode_step(params, x, cache, *, d_model, expand, state):
        d_inner, h, shares = ssm_shares(params, d_model, expand, state)
        cl, hl = d_inner // n, h // n
        sl = state // n
        projs = Columns.apply(x[:, 0], *(sh["w_in"].to(x.dtype) for sh in shares))
        old = cache["conv"]
        old_x, old_b, old_c = old.split([d_inner, state, state], -1)
        split = [proj.split([cl, cl + 2 * sl, hl], -1) for proj in projs]
        ins = [conv_in for _, conv_in, _ in split]
        convs = []
        for r, (sh, t) in enumerate(zip(shares, ins)):
            mine = torch.cat([heads(old_x, 2, r, h), old_b.narrow(2, r * sl, sl),
                              old_c.narrow(2, r * sl, sl)], -1)
            hist = torch.cat([mine, t[:, None]], 1)
            conv = layers.silu(torch.einsum("bkc,ck->bc", hist, sh["conv_w"].to(x.dtype)))
            convs.append(conv.split([cl, 2 * sl], -1))
        joined = Joined.apply(*(bc for _, bc in convs))
        gs, states = [], []
        for r, (sh, (z, _, dt), (xs, _), whole) in enumerate(zip(shares, split, convs, joined)):
            b, c = b_and_c(whole, state)
            y, s_new = ssm._ssd_decode_heads(sh, xs, b, c, dt, heads(cache["ssm"], 1, r, h))
            gs.append(y.float() * layers.silu(z).float())
            states.append(s_new)
        ys = normed(gs, shares, d_inner, x.dtype)
        out = Rows.apply(params["w_out"].to(x.dtype), *ys).to(x.dtype)
        new_in = history(ins, cl, sl)
        return out[:, None], {"conv": torch.cat([old, new_in[:, None]], 1)[:, 1:],
                              "ssm": torch.cat(states, 1)}

    whole_embed_rows, whole_logits = tfm._embed_rows, tfm._logits
    whole_ce = tfm.chunked_cross_entropy

    def embed_rows(cfg, embed, tokens):
        if embed.shape[0] % n:
            return whole_embed_rows(cfg, embed, tokens)
        tokens, nv = tokens.long(), embed.shape[0] // n
        parts = []
        for r in range(n):
            local = tokens - r * nv
            rows = embed.narrow(0, r * nv, nv)[local.clamp(0, nv - 1)]
            parts.append(torch.where(((local >= 0) & (local < nv))[..., None], rows, 0.0))
        return sum(parts)

    def head_shares(w, dtype):
        # a rank's head block is its embedding rows transposed: each share
        # keeps that layout, as the rank's operand has it
        return [c.to(dtype) for c in w.chunk(n, 1)]

    def logits_of(cfg, params, x):
        w = tfm.head_weights(cfg, params)
        if w.shape[1] % n:
            return whole_logits(cfg, params, x)
        return torch.cat([t.float() for t in Columns.apply(x, *head_shares(w, x.dtype))], -1)

    def vocab_ce(xi, li, w):
        logits = [t.float() for t in Columns.apply(xi, *head_shares(w, xi.dtype))]
        nv = logits[0].shape[-1]
        m = logits[0].detach().amax(dim=-1)
        for t in logits[1:]:
            m = torch.maximum(m, t.detach().amax(dim=-1))
        logz = m + torch.log(sum(torch.exp(t - m[..., None]).sum(dim=-1) for t in logits))
        picked = []
        for r, t in enumerate(logits):
            local = li - r * nv
            got = torch.gather(t, -1, local.clamp(0, nv - 1)[..., None])[..., 0]
            picked.append(torch.where((local >= 0) & (local < nv), got, 0.0))
        return logz - sum(picked)

    def chunked_cross_entropy(cfg, params, x, labels, *, chunk=512, label_offset=0):
        # ``transformer.chunked_cross_entropy``'s chunks, each one's
        # log-softmax from the shares' columns of the head
        w = tfm.head_weights(cfg, params)
        if w.shape[1] % n:
            return whole_ce(cfg, params, x, labels, chunk=chunk, label_offset=label_offset)
        if label_offset:
            x = x[:, label_offset:]
        w, chunk = w.to(tfm.COMPUTE_DTYPE), min(chunk, x.shape[1])
        pad = (-x.shape[1]) % chunk
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        labels = labels.long()
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int32, device=x.device)
        for start in range(0, x.shape[1], chunk):
            li = labels[:, start:start + chunk]
            valid = li >= 0
            nll = vocab_ce(x[:, start:start + chunk], li, w)
            tot, cnt = tot + torch.where(valid, nll, 0.0).sum(), cnt + valid.sum(dtype=torch.int32)
        return tot / torch.clamp(cnt, min=1)

    ranks_mesh = SimpleNamespace(shape={"data": 1, "model": n})  # as the rules read a mesh

    def global_norm(tree):
        sq = []
        for path, g in flatten_with_paths(tree):
            spec = rules.spec_for(path, g.shape, ranks_mesh)
            dims = [d for d, e in enumerate(spec) if e == "model"]
            blocks = [c.contiguous() for c in g.chunk(n, dims[0])] if dims else [g]
            sq.append(sum(torch.sum(torch.square(c.float())) for c in blocks))
        return torch.sqrt(sum(sq))

    swaps = ((tfm, "attention", attention), (tfm, "mlp", mlp), (tfm, "_embed_rows", embed_rows),
             (tfm, "_logits", logits_of), (tfm, "chunked_cross_entropy", chunked_cross_entropy),
             (ssm, "ssd_forward", ssd_forward), (ssm, "ssd_decode_step", ssd_decode_step),
             (opt, "global_norm", global_norm))

    @contextlib.contextmanager
    def patched():
        saved = [getattr(mod, name) for mod, name, _ in swaps]
        for mod, name, f in swaps:
            setattr(mod, name, f)
        try:
            yield
        finally:
            for (mod, name, _), f in zip(swaps, saved):
                setattr(mod, name, f)

    return patched()


def fsdp_rank(rank: str, world: str, store: str, seed: str, device: str = "cuda") -> None:
    """One rank of steps 14a and 14c, in its own process of a gloo group
    with CUDA tensors.  For each step rank 0 first takes the step in one
    process (no mesh, in microbatches of one row, as each rank's), keeping
    the weights before and after it on the host, and for 14c also the split
    control (``split_control``); then every rank places the same weights as
    blocks, (data ``world``, model 1) for 14a and (data 1, model ``world``)
    for 14c, and takes the sharded step; after it the parameters are
    gathered a leaf at a time and rank 0 holds each leaf's update against
    the one-process steps'.  14d does as 14c on mamba2-370m, then serves it
    (``ssm_serving``).  Prints one ``FSDP_RANK`` JSON line."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.kernels import tree_traverse as tt
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import STAGED, STAGED_BYTES, gather, use_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import flatten_with_paths, path_key, tree_leaves

    rank, world, seed = int(rank), int(world), int(seed)
    dev = torch.device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    adamw = opt.AdamWConfig(**MESH_TRAIN_OPT)

    def one_process(cfg, batch, control=False, rows=1):
        # microbatches of one row, as each rank's are: cuBLAS picks its
        # algorithm by shape, and 2-row products moved the updates 1.6e-2
        one = dataclasses.replace(cfg, microbatches=TRAIN_BATCH // rows)
        params = tfm.init_params(cfg, seed, device=dev)
        before = {path_key(path): p.detach().to("cpu", copy=True)
                  for path, p in flatten_with_paths(params)}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with split_control(world) if control else contextlib.nullcontext():
            params, ostate, m = make_train_step(one, adamw)(
                params, opt.init_opt_state(params), batch)
        torch.cuda.synchronize()
        stats = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                     step_ms=(time.perf_counter() - t0) * 1e3,
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        after = {path_key(path): p.detach().to("cpu", copy=True)
                 for path, p in flatten_with_paths(params)}
        del params, ostate, m
        torch.cuda.empty_cache()
        return before, after, stats

    def worst(gaps):
        leaf = max(gaps, key=gaps.get)
        return dict(update_gap=gaps[leaf], worst_leaf=leaf)

    def sharded(cfg, batch, shape, wants, microbatches):
        # the sharded step on (data, model) = ``shape`` blocks; after it each
        # leaf is gathered and rank 0 holds its update against each of
        # ``wants`` ((after, before) pairs on the host)
        t_mesh = time.perf_counter()
        mesh = compat_make_mesh(shape, ("data", "model"), device=dev)
        params = tfm.init_params(cfg, seed, device=dev)
        params = rules.place(params, rules.params_shardings(params, mesh))
        torch.cuda.empty_cache()
        ostate = opt.init_opt_state(params)
        held = sum(t.to_local().numel() * 4 for tree in (params, ostate["m"], ostate["v"])
                   for t in tree_leaves(tree))
        STAGED.clear()
        STAGED_BYTES.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_mesh(mesh):
            params, ostate, m = make_train_step(
                dataclasses.replace(cfg, microbatches=microbatches), adamw)(params, ostate, batch)
        torch.cuda.synchronize()
        res = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   step=int(ostate["step"]), step_ms=(time.perf_counter() - t0) * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   held_gib=held / 2**30,
                   staged_model={k: v for k, v in STAGED.items() if k.startswith("model_")},
                   staged_batch={k: v for k, v in STAGED.items() if not k.startswith("model_")},
                   staged_bytes=sum(STAGED_BYTES.values()))
        t0 = time.perf_counter()
        gaps = {name: {} for name in wants}
        with torch.no_grad():
            for path, p in flatten_with_paths(params):
                whole, key = gather(p), path_key(path)
                for name, (after, before) in wants.items():
                    gaps[name][key] = update_gap(whole, after[key], before[key])
                del whole
        res.update(compare_s=time.perf_counter() - t0, mesh_s=time.perf_counter() - t_mesh)
        if rank == 0:
            res.update({name: worst(g) for name, g in gaps.items()})
        del params, ostate, m
        torch.cuda.empty_cache()
        return res

    try:
        tt.reset_launches()
        out = {}
        # 14a: fault D's repair, at FSDP_LAYERS layers
        cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=FSDP_LAYERS)
        batch = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed).batch_at(0)
        wants = {}
        if rank == 0:
            before, after, out["single"] = one_process(cfg, batch)
            wants = {"plain": (after, before)}
        dist.barrier()
        out["fsdp"] = sharded(cfg, batch, (world, 1), wants, cfg.microbatches)
        del wants
        if rank == 0:
            del before, after

        # 14c: the tensor-parallel step at full depth, held against the
        # split control and the plain one-process step
        cfg = get_config(LM_ARCH)
        batch = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed).batch_at(0)
        wants = {}
        if rank == 0:
            before, after, out["tp_single"] = one_process(cfg, batch)
            _, control, out["control"] = one_process(cfg, batch, control=True)
            out["control"].update(worst({k: update_gap(c.to(dev), after[k], before[k])
                                         for k, c in control.items()}))
            wants = {"control": (control, before), "plain": (after, before)}
        dist.barrier()
        out["tp"] = sharded(cfg, batch, (1, world), wants, TRAIN_BATCH)
        del wants
        if rank == 0:
            del before, after, control

        # 14d: mamba2-370m at full width and depth, its SSM heads split over
        # ``model``, against the split control and the plain step; then
        # serving under the same mesh
        cfg = get_config(SSM_ARCH)
        batch = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed).batch_at(0)
        wants = {}
        if rank == 0:
            before, after, out["ssm_single"] = one_process(cfg, batch)
            _, control, out["ssm_control"] = one_process(cfg, batch, control=True)
            out["ssm_control"].update(worst({k: update_gap(c.to(dev), after[k], before[k])
                                             for k, c in control.items()}))
            # the plain step's own spread: the same step in 2-row microbatches
            _, rows2, out["ssm_rows2"] = one_process(cfg, batch, rows=2)
            out["ssm_rows2"].update(worst({k: update_gap(c.to(dev), after[k], before[k])
                                           for k, c in rows2.items()}))
            del rows2
            wants = {"control": (control, before), "plain": (after, before)}
        dist.barrier()
        out["ssm_tp"] = sharded(cfg, batch, (1, world), wants, TRAIN_BATCH)
        del wants
        if rank == 0:
            del before, after, control
        out["ssm_serve"] = ssm_serving(cfg, rank, world, seed, dev, Path(store).parent)
        # 14e: granite-3-2b served on each rank's rows
        out["rows_serve"] = rows_serving(rank, world, seed, dev, Path(store).parent)
        print("FSDP_RANK " + json.dumps(dict(out, rank=rank, launches=dict(tt.LAUNCHES))),
              flush=True)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def float32_activations():
    """The LM's activations and its serving caches in float32
    (``transformer.COMPUTE_DTYPE``, ``init_cache``; each weight is cast to
    the activations' dtype where it is used): a run free of bf16
    rounding, to tell rounding from algebra."""
    import functools

    import torch

    from repro_torch.models import transformer as tfm

    saved = tfm.COMPUTE_DTYPE, tfm.init_cache
    tfm.COMPUTE_DTYPE = torch.float32
    tfm.init_cache = functools.partial(saved[1], dtype=torch.float32)
    try:
        yield
    finally:
        tfm.COMPUTE_DTYPE, tfm.init_cache = saved


def ssm_serving(cfg, rank: int, world: int, seed: int, dev, out_dir: Path) -> dict:
    """Step 14d's serving at full depth: ``prefill`` of SSM_SERVE_PROMPT
    tokens and SSM_SERVE_STEPS ``decode_step``s with the parameters as
    blocks of a (data 1, model ``world``) mesh (the SSM layers on each
    rank's heads), decoding over the prefill's cache placed as blocks
    (``rules.cache_shardings``: each rank holds its heads' state and half
    the conv history's channels); then the prefill and SSM_SERVE_F32_STEPS
    decode steps again in float32 (``float32_activations``).  Rank 0 then
    runs them with whole weights and no mesh, in bf16 and in float32, and
    under the split control in bf16, and saves every logits as
    ``ssm_serve.npz`` in ``out_dir``.  Returns the rank's times and staged
    collectives."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import ops, rules

    mesh = compat_make_mesh((1, world), ("data", "model"), device=dev)
    params = tfm.init_params(cfg, seed, device=dev)
    rng = np.random.default_rng(seed)
    b, s = SSM_SERVE_PROMPT
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1))).to(dev)
             for _ in range(SSM_SERVE_STEPS)]

    def run(p, place, n_steps=SSM_SERVE_STEPS):
        # the staged collectives' bytes (all over ``model``: data is 1) of
        # the prefill and of a decode step
        t0, b0 = time.perf_counter(), sum(ops.STAGED_BYTES.values())
        logits, cache = tfm.prefill(cfg, p, {"tokens": prompt}, max_seq=s + len(steps))
        got = [logits.float().cpu()]
        t1, b1 = time.perf_counter(), sum(ops.STAGED_BYTES.values())
        cache = place(cache)
        b2 = sum(ops.STAGED_BYTES.values())
        for t in steps[:n_steps]:
            got.append(tfm.decode_step(cfg, p, cache, t)[0].float().cpu())
        t2, b3 = time.perf_counter(), sum(ops.STAGED_BYTES.values())
        return got, dict(prefill_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3 / n_steps,
                         prefill_bytes=b1 - b0, decode_bytes=(b3 - b2) / n_steps)

    def as_blocks(cache):
        pos = cache.pop("pos")
        sh = rules.cache_shardings(mesh, cache)
        return {**ops.blocks(rules.place(cache, sh), sh), "pos": pos}

    def same(cache):
        return cache

    sh = rules.params_shardings(params, mesh)
    blocks = ops.blocks(rules.place(params, sh), sh)
    ops.STAGED.clear()
    dist.barrier()
    with torch.no_grad(), ops.use_mesh(mesh):
        got, res = run(blocks, as_blocks)
        res.update(staged=dict(ops.STAGED))
        with float32_activations():
            got32, res["float32"] = run(blocks, as_blocks, SSM_SERVE_F32_STEPS)
    del blocks
    if rank == 0:
        with torch.no_grad():
            want, res["single"] = run(params, same)
            with split_control(world):
                control, res["control"] = run(params, same)
            with float32_activations():
                want32, _ = run(params, same, SSM_SERVE_F32_STEPS)
        runs = dict(got=got, want=want, control=control, got32=got32, want32=want32)
        np.savez(out_dir / "ssm_serve.npz",
                 **{f"{k}_{i}": t.numpy() for k, ts in runs.items() for i, t in enumerate(ts)})
    del params
    torch.cuda.empty_cache()
    return res


def rows_serving(rank: int, world: int, seed: int, dev, out_dir: Path) -> dict:
    """Step 14e in one rank: granite-3-2b at full width and depth, its
    matmul weights in bf16, as blocks of a (data ``world``, model 1) mesh,
    serving ROWS_SERVE_BATCH rows: ``prefill`` and ROWS_SERVE_STEPS greedy
    ``decode_step``s on plain whole tokens, each rank computing its rows (the
    logits gathered over ``data`` after each call).  Rank 0 then serves the
    whole batch in one process and each rank's rows alone (the row
    controls), each fed the mesh's greedy tokens, so every call sees the
    mesh run's context.  Each rank saves
    its rows of every logits and the greedy tokens as ``rows_serve_<r>.npz``
    in ``out_dir``, rank 0 the one-process runs as
    ``rows_serve_single.npz``.  Returns the rank's times, held and peak
    memory and staged collectives, and rank 0's of the one-process calls."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import ops, rules
    from repro_torch.train.tree import tree_leaves

    cfg = get_config(LM_ARCH)
    b, s, n = ROWS_SERVE_BATCH, ROWS_SERVE_PROMPT, ROWS_SERVE_STEPS
    tokens = torch.as_tensor(pipeline_for(cfg, b, s, seed=seed).batch_at(0)["tokens"]).to(dev)
    per = b // world
    weights = lambda: tfm.cast_matmul_weights(tfm.init_params(cfg, seed, device=dev))

    def serve(params, prompt, feed=None):
        # the prefill and n decode steps, each fed the argmax of the logits
        # before it (or ``feed``'s tokens): (logits on the host, the fed
        # tokens, each call's host-clock ms)
        got, fed, ms = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tfm.prefill(cfg, params, {"tokens": prompt}, max_seq=s + n)
        for i in range(n + 1):
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append(logits.float().cpu())
            if i == n:
                break
            fed.append(torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                       if feed is None else feed[i])
            t0 = time.perf_counter()
            logits, cache = tfm.decode_step(cfg, params, cache, fed[-1])
        return got, fed, ms

    def timing(ms, peak):
        return dict(prefill_ms=ms[0], decode_ms=statistics.median(ms[1:]),
                    peak_gib=peak / 2**30)

    t_setup = time.perf_counter()
    mesh = compat_make_mesh((world, 1), ("data", "model"), device=dev)
    params = weights()
    sh = rules.params_shardings(params, mesh)
    blocks = ops.blocks(rules.place(params, sh), sh)
    del params
    torch.cuda.empty_cache()
    held = sum(t.local.numel() * t.local.element_size() for t in tree_leaves(blocks))
    ops.STAGED.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    with torch.no_grad(), ops.use_mesh(mesh):
        got, fed, ms = serve(blocks, tokens)
    res = dict(timing(ms, torch.cuda.max_memory_allocated(dev)), held_gib=held / 2**30,
               staged=dict(ops.STAGED), mesh_s=time.perf_counter() - t_setup)
    del blocks
    torch.cuda.empty_cache()
    mine = slice(rank * per, (rank + 1) * per)
    np.savez(out_dir / f"rows_serve_{rank}.npz",
             tokens=np.stack([g.argmax(-1).numpy() for g in got]),
             **{f"got_{i}": g[mine].numpy() for i, g in enumerate(got)})
    dist.barrier()
    if rank == 0:
        params = weights()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            want, _, ms = serve(params, tokens, fed)
            res["single"] = timing(ms, torch.cuda.max_memory_allocated(dev))
            runs = {f"want_{i}": g.numpy() for i, g in enumerate(want)}
            for r in range(world):
                rows = slice(r * per, (r + 1) * per)
                control, _, ms = serve(params, tokens[rows], [t[rows] for t in fed])
                res[f"control_{r}"] = timing(ms, 0)
                runs.update({f"control_{r}_{i}": g.numpy() for i, g in enumerate(control)})
        np.savez(out_dir / "rows_serve_single.npz", **runs)
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def rows_serve_check(ranks: list, card: str) -> dict:
    """Step 14e's gates: each rank's logits the bits of its row control,
    within ROWS_SERVE_TOL of the one-process whole-batch call's rows (both
    fed the mesh's greedy tokens), and each rank's peak below that call's.
    Every greedy token that differs from that call's is listed with its
    candidates' gap, ungated.  The readings are printed before any gate is
    applied."""
    single = np.load(FSDP_DIR / "rows_serve_single.npz")
    per = ROWS_SERVE_BATCH // len(ranks)
    calls = ["prefill"] + [f"decode step {i}" for i in range(1, ROWS_SERVE_STEPS + 1)]
    faults, errs, flips = [], [], []
    for r in ranks:
        rank = r["rank"]
        got = np.load(FSDP_DIR / f"rows_serve_{rank}.npz")
        rows = slice(rank * per, (rank + 1) * per)
        apart = [c for i, c in enumerate(calls)
                 if not np.array_equal(got[f"got_{i}"], single[f"control_{rank}_{i}"])]
        if apart:
            faults.append(f"rank {rank}'s logits are not its row control's bits in {apart}")
        errs.append([])
        for i, c in enumerate(calls):
            mine, want = got[f"got_{i}"], single[f"want_{i}"][rows]
            diff = np.abs(mine - want).max(axis=-1)
            errs[-1].append(float(diff.max()) if np.isfinite(mine).all() else float("inf"))
            for j, (a, b) in enumerate(zip(mine.argmax(-1), want.argmax(-1))):
                if a != b:
                    gap = float(want[j, b] - want[j, a])
                    flips.append(dict(call=c, row=rank * per + j, token=int(a), want=int(b),
                                      gap=gap, logits_apart=float(diff[j])))
    serve = [r["rows_serve"] for r in ranks]
    one = serve[0]["single"]
    worst = max(max(e) for e in errs)
    if not worst <= ROWS_SERVE_TOL:
        faults.append(f"logits {worst} from the one-process call's (tolerance {ROWS_SERVE_TOL})")
    if not all(r["peak_gib"] < one["peak_gib"] for r in serve):
        faults.append(f"peak memory a rank {[r['peak_gib'] for r in serve]} GiB is not below the "
                      f"one-process whole-batch call's {one['peak_gib']} GiB")
    controls = [serve[0][f"control_{r}"] for r in range(len(ranks))]
    print(f"{card} | rows 14e: {LM_ARCH} at full width and depth (matmul weights in bf16) served "
          f"on each rank's rows as (data {len(ranks)}, model 1) in phase 14's processes, "
          f"{ROWS_SERVE_BATCH} rows of {ROWS_SERVE_PROMPT} tokens and {ROWS_SERVE_STEPS} greedy "
          f"decode steps, {per} rows a rank: logits apart from the row controls' in "
          f"{len([f for f in faults if 'row control' in f])} ranks; within {worst:.4e} of the "
          f"one-process whole-batch call's rows fed the same tokens (tolerance "
          f"{ROWS_SERVE_TOL}; per call, worst rank {[round(max(c), 5) for c in zip(*errs)]}); "
          f"greedy tokens apart from that call's (not gated) at {len(flips)} of "
          f"{len(calls) * ROWS_SERVE_BATCH} (step, row) pairs {flips}; peak "
          f"{[round(r['peak_gib'], 3) for r in serve]} GiB a rank (held "
          f"{[round(r['held_gib'], 3) for r in serve]}) against {one['peak_gib']:.3f} in one "
          f"process; prefill {[round(r['prefill_ms'], 1) for r in serve]} ms and decode "
          f"{[round(r['decode_ms'], 1) for r in serve]} ms a token a rank against "
          f"{one['prefill_ms']:.1f} and {one['decode_ms']:.1f} in one process on every row and "
          f"{[round(c['prefill_ms'], 1) for c in controls]} and "
          f"{[round(c['decode_ms'], 1) for c in controls]} for the row controls (host clock); "
          f"collectives staged {[r['staged'] for r in serve]}; from the weights' draw to the "
          f"mesh run's end {[round(r['mesh_s'], 1) for r in serve]} s a rank")
    if faults:
        fail("14e: " + "; ".join(faults))
    return dict(max_err=worst, flips=flips, peak_gib=[r["peak_gib"] for r in serve],
                single_peak_gib=one["peak_gib"])


def update_gap(got, want, before, chunk: int = 1 << 26) -> float:
    """||got - want|| / ||want - before|| in float64, ``got`` on the card
    and the host's ``want`` and ``before`` moved there a chunk at a time."""
    got, want, before = got.reshape(-1), want.reshape(-1), before.reshape(-1)
    num = den = 0.0
    for i in range(0, got.numel(), chunk):
        g = got[i:i + chunk].double()
        w = want[i:i + chunk].to(got.device).double()
        b = before[i:i + chunk].to(got.device).double()
        num += float(((g - w) ** 2).sum())
        den += float(((w - b) ** 2).sum())
    return (num / den) ** 0.5


def fsdp_phase(seed: int, card: str) -> dict:
    """Steps 14a, 14c, 14d and 14e: fault D's repair and the
    tensor-parallel steps (granite-3-2b, then mamba2-370m's SSM heads, and
    its serving), then granite-3-2b served on each rank's rows, at full
    width on the card.  Returns the ranks' kernel launches (all 0: the
    training path runs no hand-written kernel)."""
    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    FSDP_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    outs = finish_modules(start_modules(
        [[str(r), str(FSDP_RANKS), str(FSDP_DIR / "store"), str(seed)]
         for r in range(FSDP_RANKS)], wrapper=FSDP_PROGRAM), timeout=1000)
    seconds = time.perf_counter() - t0
    ranks = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("FSDP_RANK ")]
        if not lines:
            fail(f"a rank of phase 14 printed no result:\n{out[-3000:]}")
        ranks.append(json.loads(lines[-1].split(" ", 1)[1]))
    ranks.sort(key=lambda r: r["rank"])
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v

    def gates(steps, single, want, what):
        norm_gap = max(abs(r["grad_norm"] - single["grad_norm"]) / single["grad_norm"]
                       for r in steps)
        if any(abs(r["loss"] - single["loss"]) > MESH_TRAIN_TOL or r["step"] != 1
               for r in steps) or not steps[0][want]["update_gap"] <= MESH_TRAIN_UPDATE_TOL \
                or not norm_gap <= MESH_TRAIN_NORM_TOL:
            fail(f"{what}: {steps} against {single} (loss tolerance {MESH_TRAIN_TOL}, update "
                 f"{MESH_TRAIN_UPDATE_TOL}, gradient norm {MESH_TRAIN_NORM_TOL})")
        return norm_gap

    fsdp, single = [r["fsdp"] for r in ranks], ranks[0]["single"]
    norm_gap = gates(fsdp, single, "plain", "the sharded step at full width")
    if not all(r["peak_gib"] < FSDP_PEAK_SHARE * single["peak_gib"] for r in fsdp):
        fail(f"the sharded step's peak memory a rank {[r['peak_gib'] for r in fsdp]} GiB is not "
             f"below {FSDP_PEAK_SHARE} of the one-process step's {single['peak_gib']} GiB")
    print(f"{card} | fsdp 14a: {LM_ARCH} at full width cut to {FSDP_LAYERS} layers, one train "
          f"step of {TRAIN_BATCH} x {TRAIN_SEQ} tokens as (data {FSDP_RANKS}, model 1) in "
          f"{FSDP_RANKS} processes on the card over gloo (collectives staged through the host), "
          f"each rank holding its blocks and gathering a layer at a time: losses "
          f"{[round(r['loss'], 6) for r in fsdp]} against {single['loss']:.6f} in one process "
          f"(tolerance {MESH_TRAIN_TOL}); with AdamW {MESH_TRAIN_OPT}: every leaf's update within "
          f"{fsdp[0]['plain']['update_gap']:.3e} (relative L2, worst "
          f"{fsdp[0]['plain']['worst_leaf']}; tolerance {MESH_TRAIN_UPDATE_TOL}), gradient "
          f"norms {[round(r['grad_norm'], 6) for r in fsdp]} against "
          f"{single['grad_norm']:.6f} ({norm_gap:.2e} apart; tolerance {MESH_TRAIN_NORM_TOL}); "
          f"parameters and moments held {[round(r['held_gib'], 3) for r in fsdp]} GiB a rank; "
          f"peak memory (max allocated) {[round(r['peak_gib'], 3) for r in fsdp]} GiB a rank "
          f"against {single['peak_gib']:.3f} GiB for the one-process step (limit "
          f"{FSDP_PEAK_SHARE} of it); step {[round(r['step_ms'], 1) for r in fsdp]} ms a rank "
          f"against {single['step_ms']:.1f} ms in one process ({TRAIN_BATCH} microbatches of one "
          f"row, each rank's shape; its first step; host clock); collectives staged "
          f"{[dict(r['staged_batch'], **r['staged_model']) for r in fsdp]}; from the ranks' "
          f"first barrier to the compared parameters {[round(r['mesh_s'], 1) for r in fsdp]} s "
          f"(the gathers and comparisons {[round(r['compare_s'], 1) for r in fsdp]} s)")

    tp, single, control = [r["tp"] for r in ranks], ranks[0]["tp_single"], ranks[0]["control"]
    tp_norm_gap = gates(tp, control, "control", "the tensor-parallel step at full width")
    if not tp[0]["plain"]["update_gap"] <= MESH_TP_PLAIN_TOL:
        fail(f"the tensor-parallel step's updates are {tp[0]['plain']} from the plain "
             f"one-process step's (limit {MESH_TP_PLAIN_TOL}; the split control's "
             f"{control['update_gap']:.3e})")
    # with data 1, a parameter gather could only be one over ``model``
    if any(r["staged_batch"].get("all_gather", 0) or not r["staged_model"] for r in tp):
        fail(f"the tensor-parallel step gathered a parameter over model, or joined no "
             f"share over model: {[(r['staged_model'], r['staged_batch']) for r in tp]}")
    print(f"{card} | tp 14c: {LM_ARCH} at full width and depth, the same step as (data 1, "
          f"model {FSDP_RANKS}) in the same {FSDP_RANKS} processes, tensor-parallel over model "
          f"(each rank's heads, FFN columns and matmul shares from its model blocks; the "
          f"49,155-row vocabulary does not divide, so the embedding and head stay whole), "
          f"{TRAIN_BATCH} microbatches of one row: against the split control (one process, each "
          f"split matmul as the ranks' shares summed in float32 and rounded once): losses "
          f"{[round(r['loss'], 6) for r in tp]} against {control['loss']:.6f} (tolerance "
          f"{MESH_TRAIN_TOL}); every leaf's update within {tp[0]['control']['update_gap']:.3e} "
          f"(worst {tp[0]['control']['worst_leaf']}; tolerance {MESH_TRAIN_UPDATE_TOL}); "
          f"gradient norms {[round(r['grad_norm'], 6) for r in tp]} against "
          f"{control['grad_norm']:.6f} ({tp_norm_gap:.2e} apart; tolerance "
          f"{MESH_TRAIN_NORM_TOL}); against the plain one-process step (loss "
          f"{single['loss']:.6f}, norm {single['grad_norm']:.6f}): updates within "
          f"{tp[0]['plain']['update_gap']:.3e} (worst {tp[0]['plain']['worst_leaf']}; limit "
          f"{MESH_TP_PLAIN_TOL}), the split control's own {control['update_gap']:.3e} (worst "
          f"{control['worst_leaf']}); parameters and moments held "
          f"{[round(r['held_gib'], 3) for r in tp]} GiB a rank; peak memory "
          f"{[round(r['peak_gib'], 3) for r in tp]} GiB a rank against {single['peak_gib']:.3f} "
          f"in one process; step {[round(r['step_ms'], 1) for r in tp]} ms a rank against "
          f"{single['step_ms']:.1f} ms in one process and {control['step_ms']:.1f} for the "
          f"control (host clock); collectives staged over model "
          f"{[r['staged_model'] for r in tp]}, over the batch axes and the norm "
          f"{[r['staged_batch'] for r in tp]}; from the ranks' barrier to the compared "
          f"parameters {[round(r['mesh_s'], 1) for r in tp]} s; 14a and 14c {seconds:.2f} s")
    ssm = ssm_tp_check(ranks, card)
    rows = rows_serve_check(ranks, card)
    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    print(f"{card} | phase 14's rank processes (14a, 14c, 14d, 14e) {seconds:.2f} s")
    return dict(ranks=ranks, norm_gap=norm_gap, tp_norm_gap=tp_norm_gap, ssm=ssm, rows=rows,
                seconds=seconds, launches=launches)


def ssm_tp_check(ranks: list, card: str) -> dict:
    """Step 14d's gates: the tensor-parallel mamba2-370m step bit for bit
    against the split control (loss, norm, every leaf) and within
    SSM_TP_PLAIN_TOL of the plain step; a layer's collectives over
    ``model`` a microbatch as its split asks (``w_in``'s and ``conv_w``'s
    pieces exchanged forward, in the recompute and for their gradients; B
    and C gathered forward and in the recompute, their gradients summed
    once), and no parameter gathered whole; the serving logits the split
    control's bits, within SSM_SERVE_TOL of whole weights, and in float32
    within SSM_SERVE_F32_TOL of whole weights in float32.  Prints each
    rank's in-projection columns and the bytes its collectives brought back
    a layer."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config(SSM_ARCH)
    tp, single, control, rows2 = ([r["ssm_tp"] for r in ranks], ranks[0]["ssm_single"],
                                  ranks[0]["ssm_control"], ranks[0]["ssm_rows2"])
    if any(r["loss"] != control["loss"] or r["grad_norm"] != control["grad_norm"]
           or r["step"] != 1 for r in tp) or tp[0]["control"]["update_gap"] != 0.0:
        fail(f"14d: the tensor-parallel {SSM_ARCH} step is not the split control's bits: "
             f"{[(r['loss'], r['grad_norm']) for r in tp]} against ({control['loss']}, "
             f"{control['grad_norm']}), worst leaf {tp[0]['control']}")
    if not tp[0]["plain"]["update_gap"] <= SSM_TP_PLAIN_TOL or \
            any(abs(r["loss"] - single["loss"]) > MESH_TRAIN_TOL for r in tp):
        fail(f"14d: the tensor-parallel step is {tp[0]['plain']} from the plain one-process "
             f"step's updates (limit {SSM_TP_PLAIN_TOL}), losses "
             f"{[r['loss'] for r in tp]} against {single['loss']}")
    per = cfg.n_layers * TRAIN_BATCH  # a layer a microbatch
    want = {"model_all_to_all": 2 * 3 * per, "model_all_gather": 2 * per,
            "model_reduce_scatter": per}
    if any(any(r["staged_model"].get(k, 0) != v for k, v in want.items())
           or r["staged_batch"].get("all_gather", 0) or r["staged_batch"].get("reduce_scatter", 0)
           for r in tp):
        fail(f"14d: collectives staged {[(r['staged_model'], r['staged_batch']) for r in tp]}; "
             f"want {want} a rank and no all_gather or reduce_scatter of a parameter")
    dims = dict(d_model=cfg.d_model, expand=cfg.ssm_expand, state=cfg.ssm_state)
    widths = [sum(n for _, n in ssm.in_columns(r, FSDP_RANKS, **dims))
              for r in range(FSDP_RANKS)]
    d_inner, heads, _ = ssm.ssm_dims(**dims)
    served = np.load(FSDP_DIR / "ssm_serve.npz")
    calls = ["prefill"] + [f"decode step {i}" for i in range(1, SSM_SERVE_STEPS + 1)]

    def logits(run, i):
        return torch.from_numpy(served[f"{run}_{i}"])

    apart = [i for i in range(len(calls))
             if not np.array_equal(served[f"got_{i}"], served[f"control_{i}"])]
    if apart:
        fail(f"14d serving: the tensor-parallel logits are not the split control's bits in "
             f"{[calls[i] for i in apart]}, at most "
             f"{max(float((logits('got', i) - logits('control', i)).abs().max()) for i in apart)}")
    errs = [check_logits(logits("got", i), logits("want", i), SSM_SERVE_TOL,
                         f"14d serving, {c}")[0] for i, c in enumerate(calls)]
    errs32 = [check_logits(logits("got32", i), logits("want32", i), SSM_SERVE_F32_TOL,
                           f"14d serving in float32, {calls[i]}")[0]
              for i in range(SSM_SERVE_F32_STEPS + 1)]
    # the bf16 model's own rounding: whole weights in bf16 against float32
    own = [float((logits("want", i) - logits("want32", i)).abs().max())
           for i in range(SSM_SERVE_F32_STEPS + 1)]
    split = [float((logits("got", i) - logits("want32", i)).abs().max())
             for i in range(SSM_SERVE_F32_STEPS + 1)]
    serve = [r["ssm_serve"] for r in ranks]
    print(f"{card} | tp 14d: {SSM_ARCH} at full width and depth ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, 32 SSM heads of 64, state {cfg.ssm_state}, vocabulary "
          f"{cfg.vocab_size}), one step of {TRAIN_BATCH} x {TRAIN_SEQ} tokens as (data 1, model "
          f"{FSDP_RANKS}) in phase 14's processes, each rank computing its SSM heads and its "
          f"share of B and C (w_in columns a rank {widths} of "
          f"{2 * d_inner + 2 * cfg.ssm_state + heads}, "
          f"gathered as pieces from the ranks' blocks; B and C gathered over model after the conv; "
          f"the gated norm's sum of squares summed over model, w_out row-parallel), "
          f"{TRAIN_BATCH} microbatches of one row: "
          f"the split control's bits (losses {[r['loss'] for r in tp]}, norms "
          f"{[r['grad_norm'] for r in tp]}, every leaf: worst update gap "
          f"{tp[0]['control']['update_gap']}); against the plain one-process step (loss "
          f"{single['loss']:.6f}, norm {single['grad_norm']:.6f}): updates within "
          f"{tp[0]['plain']['update_gap']:.3e} (worst {tp[0]['plain']['worst_leaf']}; limit "
          f"{SSM_TP_PLAIN_TOL}), the split control's own {control['update_gap']:.3e} (worst "
          f"{control['worst_leaf']}), the plain step in 2-row microbatches "
          f"{rows2['update_gap']:.3e} (worst {rows2['worst_leaf']}); parameters and moments held "
          f"{[round(r['held_gib'], 3) for r in tp]} GiB a rank; peak memory "
          f"{[round(r['peak_gib'], 3) for r in tp]} GiB a rank against "
          f"{single['peak_gib']:.3f} in one process; step {[round(r['step_ms'], 1) for r in tp]} "
          f"ms a rank against {single['step_ms']:.1f} ms in one process and "
          f"{control['step_ms']:.1f} for the control (host clock); collectives staged over "
          f"model {[r['staged_model'] for r in tp]} (B and C gathers: model_all_gather), the "
          f"rest {[r['staged_batch'] for r in tp]}; bytes staged a layer a microbatch "
          f"{[round(r['staged_bytes'] / per) for r in tp]}")
    print(f"{card} | tp 14d serving: {SSM_ARCH} at full width and depth, prefill of "
          f"{SSM_SERVE_PROMPT[0]} x {SSM_SERVE_PROMPT[1]} tokens and {SSM_SERVE_STEPS} decode "
          f"steps as (data 1, model {FSDP_RANKS}), parameters and cache as blocks: every logits "
          f"the split control's bits; within {max(errs):.4e} of whole weights without a mesh "
          f"(tolerance {SSM_SERVE_TOL}; per call {[round(e, 5) for e in errs]}); in float32 (the "
          f"prefill and {SSM_SERVE_F32_STEPS} decode steps) within {max(errs32):.4e} of whole "
          f"weights in float32 (tolerance {SSM_SERVE_F32_TOL}; per call "
          f"{[float(f'{e:.4e}') for e in errs32]}); against those float32 logits, whole weights "
          f"in bf16 sit {[round(e, 5) for e in own]} and the tensor-parallel bf16 ones "
          f"{[round(e, 5) for e in split]}; prefill {[round(r['prefill_ms'], 1) for r in serve]} "
          f"ms and decode {[round(r['decode_ms'], 1) for r in serve]} ms a token a rank against "
          f"{serve[0]['single']['prefill_ms']:.1f} and {serve[0]['single']['decode_ms']:.1f} "
          f"without a mesh and {serve[0]['control']['prefill_ms']:.1f} and "
          f"{serve[0]['control']['decode_ms']:.1f} for the control (host clock); collectives "
          f"staged {[r['staged'] for r in serve]}, all over model; bytes they brought back a "
          f"layer: prefill {[round(r['prefill_bytes'] / cfg.n_layers) for r in serve]}, a decode "
          f"step {[round(r['decode_bytes'] / cfg.n_layers) for r in serve]}")
    return dict(in_columns=widths, step_bytes_a_layer=[r["staged_bytes"] / per for r in tp],
                decode_bytes_a_layer=[r["decode_bytes"] / cfg.n_layers for r in serve],
                plain_gap=tp[0]["plain"]["update_gap"], rows2_gap=rows2["update_gap"],
                serve_err=max(errs), serve_err_f32=max(errs32), serve_own_bf16=max(own))


def start_dryrun() -> list:
    """Start each cell of DRYRUN_CELLS in a process of its own on the host
    CPU (``python -m repro_torch.launch.dryrun``; no card)."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    return start_modules([["repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                           "--out", str(DRYRUN_DIR)] + (["--multi-pod"] if multi_pod else [])
                          for arch, shape, multi_pod in DRYRUN_CELLS])


def dryrun_phase(started: list, card: str) -> list:
    """Step 14b: the dry run's cells, each ``ok`` (the processes exit 1 on a
    failed cell), with their per-rank argument and peak bytes, dominant
    roofline term and useful ratio."""
    t0 = time.perf_counter()
    finish_modules(started, timeout=DRYRUN_TIMEOUT_S)
    waited = time.perf_counter() - t0
    records = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        mesh = "2x16x16" if multi_pod else "16x16"
        rec = json.loads((DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json").read_text())
        if not rec["ok"]:
            fail(f"dry run {arch} {shape} {mesh}: {rec.get('error')}")
        m, r = rec["memory"], rec["roofline"]
        records.append(dict(arch=arch, shape=shape, mesh=mesh, chips=rec["chips"],
                            run_s=rec["run_s"], argument_gib=m["argument_size_in_bytes"] / 2**30,
                            peak_gib=m["peak_bytes"] / 2**30, dominant=r["dominant"],
                            compute_s=r["compute_s"], memory_s=r["memory_s"],
                            collective_s=r["collective_s"], useful_ratio=r["useful_ratio"],
                            collective_bytes=rec["collectives"]["total"],
                            flops=rec["jaxpr_cost"]["flops"],
                            library_flops_a_rank=rec["cost_xla_reference"]["flops"]))
        print(f"{card} | dryrun 14b: {arch} {shape} on {mesh} ({rec['chips']} ranks of a fake "
              f"process group, meta tensors, on the host CPU): argument "
              f"{records[-1]['argument_gib']:.3f} GiB and peak {records[-1]['peak_gib']:.3f} GiB a "
              f"rank; dominant {r['dominant']} (compute {r['compute_s']:.3e} s, memory "
              f"{r['memory_s']:.3e} s, collective {r['collective_s']:.3e} s); useful ratio "
              f"{r['useful_ratio']:.4f}; collective bytes a rank {rec['collectives']['total']}; "
              f"{rec['run_s']} s to run the rank's program")
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    print(f"dryrun 14b: waited {waited:.2f} s for the cells at the end of the run")
    return records


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
    use_model_config()
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
    # 14b's dry-run cells need no card: they run on the host from here on
    dryrun = start_dryrun()
    atexit.register(lambda: [proc.kill() for _, proc in dryrun if proc.poll() is None])

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

    request_ms = {}
    for spec in routes:
        eng = engines[spec]
        request_ms[spec] = ms = host_ms(lambda: eng.predict_scores(X), REQUEST_TIMING_REPS)
        print(f"{card} | request {spec}: {ROWS} rows end to end (H2D, keys, kernels, "
              f"D2H, merge, finalize) {ms:.3f} ms median, host clock")
    # 4d. the fused tree_parallel strategy (the reference walk; no hand kernel)
    fused_plan_phase(ir, X, refs, PLAN_ROUTES[0], request_ms[PLAN_ROUTES[0]], dev, card)

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
    # for the staging gate, the deployment and host-C phases
    want = {mode: refs[mode].predict_scores(X) for mode in ("integer", "flint")}
    staged = staging_gate(engines, want["integer"], X, args.seed, dev, card)
    print(json.dumps({"staging": staged}))
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

    # 11. the drivers (their launches counted in their processes) and the LM
    drivers = drivers_and_lm_phase(args.seed, dev, card)
    torch.cuda.empty_cache()

    # 12. training, with the launch counters read around it (all 0)
    train = train_phase(args.seed, dev, card)
    torch.cuda.empty_cache()

    # 13. the mesh, with the launch counters read around it (all 0)
    mesh = mesh_phase(ir, args.seed, dev, card)
    torch.cuda.empty_cache()

    # 14. fault D's repair on the card and the dry run, with the launch
    # counters read around them (all 0)
    t_phase = time.perf_counter()
    tt.reset_launches()
    fsdp = fsdp_phase(args.seed, card)
    fsdp_launches = {k: fsdp["launches"].get(k, 0) + v for k, v in tt.LAUNCHES.items()}
    dry = dryrun_phase(dryrun, card)
    seconds = time.perf_counter() - t_phase
    print(f"{card} | fsdp and dry-run phase: {seconds:.2f} s; kernel launches {fsdp_launches}")
    print(json.dumps({"fsdp": dict(fsdp, phase_s=seconds), "dryrun": dry}))
    if any(fsdp_launches.values()):
        fail(f"the sharded step launched a hand-written kernel: {fsdp_launches}")

    paths = {"engine": launches, "gateway": gw_launches, "plan_gateway": plan_launches,
             **deploy, "host_c": host_c["mixed"], "host_c_gateway": host_c["gateway"],
             "drivers": drivers, "train": train, "mesh": mesh, "fsdp": fsdp_launches}
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
