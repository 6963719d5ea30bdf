"""Warm-time measured autotuning of the cuda backend's CTA shape and the
host-C backends' blocking knobs.

The cuda backend's ``(block_b, block_t)`` — rows and trees per CTA — has a
static heuristic (``kernels/ops.py::pick_blocks``: 128 rows where the
staged row tile fits, one wave of CTAs), but the best shape is a property
of the card and the forest, not a constant.  This module is the measured
answer: during ``TreeEngine.warm()`` each candidate of
``kernels/ops.py::pick_blocks_candidates`` (the heuristic first, then its
halved and doubled neighbours that fit) is built on the engine's *already
materialized* layout artifact and timed (min-of-rounds ``predict_partials``
on deterministic pseudo-random rows, with ``torch.cuda.synchronize()``
around each round on the card), and the winner's kwargs are pinned.  The
host-C backends sweep the JAX package's grids: ``native_c_table``'s
``block_rows`` in (8, 1, 4, 16) and ``native_c_bitvector``'s ``interleave``
in (8, 1, 4), the default first.  Their winner is a property of the host
CPU, not of the card: it is keyed, cached and written to an artifact's
``tune_db`` under the CPU (``torch-cpu:<isa>``) whatever the engine's
device.

Every candidate produces bit-identical uint32 partials (the knobs only
re-tile the grid; uint32 atomics merge exactly in any order), so tuning can
never change an answer, only its latency.  Winner selection is
deterministic: strict-min time with the heuristic first, so ties — and an
injected constant timer — resolve to the default.

The winner is cached per (backend, layout, mode, route kwargs, device) in the
owning ``ModelVersion`` and copied across hot-swaps by the registry, so a
swapped-in version of the same model reuses the measurement instead of
re-timing; the measuring cost itself is surfaced through
``drain_compile_timings`` under the ``"tune"`` key and the chosen config
through the metrics ``tuned`` column.

``REPRO_AUTOTUNE=0`` is the global kill switch, read as the JAX package
reads it; tuning is otherwise opt-in per engine/gateway
(``TreeEngine(autotune=True)``, a ``?autotune=true`` route).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

# rows the candidates are timed on — one serving-sized bucket, enough to
# amortize per-call overheads without making warm() noticeably slower
_TUNE_ROWS = 256
_ROUNDS = 3
_WARMUP = 1

# backends with a measurable construction knob; anything else is a no-op
TUNABLE_BACKENDS = ("native_c_table", "native_c_bitvector", "cuda")


def autotune_enabled(flag) -> bool:
    """``flag`` gated by the ``REPRO_AUTOTUNE=0`` environment kill switch."""
    return bool(flag) and os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def config_str(kwargs: dict) -> str:
    """Compact human form of a winner, e.g. ``block_b=128,block_t=2`` — the
    metrics ``tuned`` column and the gateway table cell."""
    return ",".join(f"{k}={v}" for k, v in sorted(kwargs.items())) or "-"


def candidate_grid(backend_name: str, artifact, rows: int = _TUNE_ROWS, *,
                   device=None) -> list:
    """The candidate ``backend_kwargs`` grid for one backend, the default
    or heuristic FIRST (ties resolve to it).  The cuda grid is sized for
    ``device``'s SM count, the same for every kernel (``impl``), since all
    three stage alike.  Empty when the backend has no tunable knob."""
    if backend_name == "native_c_table":
        return [{"block_rows": r} for r in (8, 1, 4, 16)]
    if backend_name == "native_c_bitvector":
        return [{"interleave": k} for k in (8, 1, 4)]
    if backend_name != "cuda":
        return []
    from repro_torch.kernels.ops import _sm_count, pick_blocks_candidates

    sms = _sm_count(torch.device(device if device is not None else "cpu"))
    return [{"block_b": bb, "block_t": bt}
            for bb, bt in pick_blocks_candidates(rows, artifact.feature.shape[0],
                                                 artifact.n_features, sms)]


def measure_backend(backend, X, *, rounds: int = _ROUNDS,
                    warmup: int = _WARMUP) -> float:
    """Min-of-rounds ``predict_partials`` wall seconds, each round between
    two ``torch.cuda.synchronize()`` on the card (warmup first, so the
    kernels' build never pollutes the measurement)."""
    dev = backend.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for _ in range(warmup):
        backend.predict_partials(X)
    best = float("inf")
    for _ in range(rounds):
        sync()
        t0 = time.perf_counter()
        backend.predict_partials(X)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def tune_backend(backend_name: str, artifact, mode: str, *,
                 rows: int = _TUNE_ROWS, baseline=None, measure=None,
                 backend_kwargs=None, device=None):
    """Measure the candidate grid on ``artifact`` and return
    ``(winner_kwargs, winner_backend, report)``.

    ``baseline`` (optional) is an already-built backend for the grid's first
    (default) entry — reused instead of rebuilding it.  Every other
    candidate is built on ``device`` with the route's own ``backend_kwargs``
    (e.g. ``impl``) plus the candidate's.  ``measure`` is injectable for
    deterministic tests.  Returns ``(None, None, [])`` when the backend has
    no grid to sweep.  The report is ``[(kwargs, seconds), ...]`` in grid
    order.
    """
    from repro_torch.backends import create_backend

    # resolve the default at call time so tests can monkeypatch the module
    measure = measure if measure is not None else measure_backend
    grid = candidate_grid(backend_name, artifact, rows, device=device)
    if len(grid) < 2:
        return None, None, []
    rng = np.random.default_rng(0)
    X = rng.normal(0.0, 4.0, (rows, artifact.n_features)).astype(np.float32)
    report = []
    best_i, best_t, best_b = 0, float("inf"), None
    for i, kw in enumerate(grid):
        b = (baseline if i == 0 and baseline is not None
             else create_backend(backend_name, artifact, mode=mode,
                                 device=device, **{**(backend_kwargs or {}), **kw}))
        t = float(measure(b, X))
        report.append((dict(kw), t))
        if t < best_t:
            best_i, best_t, best_b = i, t, b
    return dict(grid[best_i]), best_b, report
