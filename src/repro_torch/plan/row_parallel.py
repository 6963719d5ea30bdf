"""RowParallelPlan: shard the batch, concatenate the results.

Tree traversal is row-independent, so splitting a batch across concurrent
calls of the same backend changes nothing about any row's accumulation:
row-parallel outputs are bit-identical to the single plan for every mode,
float included (the one plan that can shard the float mode).  The shards
share one backend instance, whose calls are reentrant: its device tables
are read-only and the kernel wrappers' counters take a lock.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from repro_torch.plan.base import ExecutionPlan, build_backend, register_plan

_DEFAULT_SHARDS = 2


@register_plan
class RowParallelPlan(ExecutionPlan):
    name = "row_parallel"

    def __init__(self, model, *, mode: str = "integer", backend="reference",
                 shards=None, layout: Optional[str] = None,
                 backend_kwargs: Optional[dict] = None, device=None):
        self.backend = build_backend(backend, model, mode, layout, backend_kwargs,
                                     device)
        super().__init__(self.backend.packed, mode=self.backend.mode)
        self.shards = int(shards or _DEFAULT_SHARDS)
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self._pool = None  # created lazily, released by close()
        self._pool_lock = threading.Lock()

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:  # shared by callers on several threads
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.shards, thread_name_prefix="row-shard"
                )
            return self._pool

    def close(self) -> None:
        """Drain in-flight chunk dispatches and release the pool (re-created
        on the next predict, as for tree_parallel)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # ------------------------------------------------------------ execution
    def _chunks(self, X):
        """Contiguous near-equal row chunks; short batches use fewer shards."""
        X = np.asarray(X, np.float32)
        return [c for c in np.array_split(X, self.shards) if len(c)]

    def _scatter(self, X, method):
        chunks = self._chunks(X)
        # capture the parent span here, on the dispatching thread
        parent = self.trace_parent
        pool = self._ensure_pool()
        futs = [
            pool.submit(self._timed, f"r{i}/{len(chunks)}", method, c,
                        span_parent=parent)
            for i, c in enumerate(chunks)
        ]
        return [f.result() for f in futs]

    def _merged(self, parts, parent):
        """Concatenate row chunks under a timed ``merge`` stage/span."""
        t0 = time.perf_counter_ns()
        out = np.concatenate([np.asarray(p) for p in parts])
        t1 = time.perf_counter_ns()
        self._record_stage("merge", (t1 - t0) / 1e6)
        self._span("merge", t0, t1, parent, shards=len(parts))
        return out

    def predict_partials(self, X):
        if not self.deterministic:
            raise NotImplementedError(
                f"mode {self.mode!r} has no integer partials; row_parallel "
                "serves it through predict_scores"
            )
        parent = self.trace_parent
        return self._merged(self._scatter(X, self.backend.predict_partials),
                            parent)

    def predict_scores(self, X):
        if self.deterministic:
            return super().predict_scores(X)  # finalize(concatenated partials)
        parent = self.trace_parent
        outs = self._scatter(X, self.backend.predict_scores)
        t0 = time.perf_counter_ns()
        scores = np.concatenate([np.asarray(s) for s, _ in outs])
        preds = np.concatenate([np.asarray(p) for _, p in outs])
        t1 = time.perf_counter_ns()
        self._record_stage("merge", (t1 - t0) / 1e6)
        self._span("merge", t0, t1, parent, shards=len(outs))
        return scores, preds

    # -------------------------------------------------------------- metadata
    @property
    def backends(self) -> tuple:
        return (self.backend,)

    @property
    def packed(self):
        return self.backend.packed

    @property
    def n_shards(self) -> int:
        return self.shards

    def describe(self) -> dict:
        d = super().describe()
        d.update(shards=self.shards)
        return d
