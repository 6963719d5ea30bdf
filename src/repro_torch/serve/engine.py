"""TreeEngine: the serving path's shape-bucketing wrapper over one plan.

    engine -> ExecutionPlan -> backend.predict_partials -> merge -> finalize

For plans that work per shape, incoming batches are padded up to a small set
of power-of-two row buckets (capped at ``max_bucket``, which defaults to the
backend's ``preferred_block_rows``).  Tree traversal is row-independent, so
padding rows never perturb real rows.  Bucketing also decides the cuda
backend's walk: a 37-row request pads to 64 rows and takes K1, a 20-row one
pads to 32 and takes K2.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np


def bucket_rows(b: int, *, max_bucket: int = 4096) -> int:
    """Padded row count for a batch of ``b`` rows: the next power of two,
    capped at ``max_bucket``; beyond the cap, the next ``max_bucket``
    multiple."""
    if b <= 0:
        raise ValueError("batch must have at least one row")
    if b >= max_bucket:
        return -(-b // max_bucket) * max_bucket
    return 1 << (b - 1).bit_length()


class TreeEngine:
    """Shape-bucketing wrapper over one :class:`~repro_torch.plan.ExecutionPlan`.

    ``packed`` is a :class:`~repro_torch.ir.ForestIR` or any materialized
    layout artifact.  The route is one :class:`~repro_torch.serve.spec.
    EngineSpec`, passed as ``spec`` (an EngineSpec, a dict, or a string like
    ``"integer:cuda@leaf_major"``); the loose keyword arguments survive as
    the reference's deprecation shim.  ``device`` places the backend's
    tables and work: ``cuda`` unless ``device="cpu"`` is passed.
    ``predict``/``predict_scores`` take numpy (B, F) float32 rows of any
    count and return numpy results.
    """

    def __init__(self, packed=None, spec=None, *, mode: Optional[str] = None,
                 backend=None, backend_kwargs: Optional[dict] = None,
                 max_bucket: Optional[int] = None, layout: Optional[str] = None,
                 plan: Optional[str] = None, shards: Optional[int] = None,
                 plan_kwargs: Optional[dict] = None, autotune=None,
                 device=None):
        from repro_torch.plan import create_plan
        from repro_torch.serve.spec import EngineSpec

        spec = EngineSpec.coerce(spec, caller="TreeEngine", mode=mode,
                                 backend=backend, layout=layout, plan=plan,
                                 shards=shards, backend_kwargs=backend_kwargs,
                                 autotune=autotune)
        if spec.autotune:
            raise NotImplementedError(
                "autotune is not ported yet (ROADMAP.md Queue 1 item 7, "
                "serve/autotune.py)")
        self.spec = spec
        self.plan = create_plan(
            spec.plan, packed, mode=spec.mode, backend=spec.backend,
            shards=spec.shards, layout=spec.layout,
            backend_kwargs=dict(spec.backend_kwargs) if spec.backend_kwargs else None,
            device=device, **(plan_kwargs or {})
        )
        self.packed = self.plan.packed
        self.mode = self.plan.mode
        self.max_bucket = max_bucket or self.plan.preferred_block_rows or 4096
        self.compiled_buckets: set[int] = set()
        # first-execution wall ms per bucket, drained into metrics
        self._compile_ms: dict = {}
        self.closed = False

    @property
    def backend(self):
        """The (first) shard backend."""
        backends = self.plan.backends
        return backends[0] if backends else None

    @property
    def backend_name(self) -> str:
        return self.plan.backend_name

    @property
    def plan_name(self) -> str:
        return self.plan.name

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def layout(self) -> str:
        """The ForestIR layout(s) the plan's backends are walking."""
        return self.plan.layout

    @property
    def deterministic(self) -> bool:
        """True when outputs are bit-exact integer scores."""
        return self.plan.deterministic

    def drain_shard_timings(self) -> dict:
        """Per-shard wall time since the last drain (``{label: (ms, calls)}``)."""
        return self.plan.drain_timings()

    def drain_stage_timings(self) -> dict:
        """Pipeline-stage wall time since the last drain (pad, finalize)."""
        return self.plan.drain_stage_timings()

    def drain_compile_timings(self) -> dict:
        """First-execution wall ms per bucket since the last drain (the
        kernels' build lands in the first bucket's entry)."""
        out, self._compile_ms = self._compile_ms, {}
        out.update(self.plan.drain_setup_timings())
        return out

    def close(self) -> None:
        """Release executors the plan owns and mark the engine closed."""
        self.closed = True
        self.plan.close()

    def attach_trace(self, tracer, parent) -> None:
        """Attach a tracer and the span that parents this thread's spans."""
        self.plan.attach_tracer(tracer)
        self.plan.trace_parent = parent

    def detach_trace(self) -> None:
        self.plan.trace_parent = None

    def warm(self, max_rows: int) -> None:
        """Run every bucket any batch of 1..``max_rows`` rows can map to: the
        power-of-two buckets below ``max_bucket`` and the ``max_bucket``
        multiples at or above it."""
        zeros = lambda nb: np.zeros((nb, self.packed.n_features), np.float32)
        if not self.plan.compiles_per_shape:
            self.predict(zeros(1))
            return
        top = bucket_rows(max_rows, max_bucket=self.max_bucket)
        nb = 1
        while nb <= top and nb < self.max_bucket:
            self.predict(zeros(nb))
            nb *= 2
        if top >= self.max_bucket:
            for m in range(self.max_bucket, top + 1, self.max_bucket):
                self.predict(zeros(m))

    def padded_rows(self, b: int) -> int:
        """Rows actually executed for a ``b``-row batch."""
        if not self.plan.compiles_per_shape:
            return b
        return bucket_rows(b, max_bucket=self.max_bucket)

    def _pad(self, X):
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"expected (B, F) features, got shape {X.shape}")
        b = X.shape[0]
        nb = self.padded_rows(b)
        if nb != b:
            X = np.concatenate([X, np.zeros((nb - b, X.shape[1]), np.float32)])
        return X, b, nb

    def _pad_traced(self, X):
        t0 = time.perf_counter_ns()
        X, b, nb = self._pad(X)
        t1 = time.perf_counter_ns()
        self.plan._record_stage("pad", (t1 - t0) / 1e9)
        self.plan._span("pad", t0, t1, self.plan.trace_parent, rows=b, padded=nb)
        return X, b, nb

    def _execute(self, fn, X):
        X, b, nb = self._pad_traced(X)
        cold = self.plan.compiles_per_shape and nb not in self.compiled_buckets
        t0 = time.perf_counter()
        out = fn(X)
        if self.plan.compiles_per_shape:
            # only a predict that returned has run its bucket
            self.compiled_buckets.add(nb)
            if cold:
                self._compile_ms[nb] = (time.perf_counter() - t0) * 1e3
        return out, b

    def predict_scores(self, X):
        (scores, preds), b = self._execute(self.plan.predict_scores, X)
        return np.asarray(scores)[:b], np.asarray(preds)[:b]

    def predict(self, X) -> np.ndarray:
        return self.predict_scores(X)[1]

    def predict_partials(self, X):
        """Merged (B, C) uint32 partials through the bucketed path."""
        acc, b = self._execute(self.plan.predict_partials, X)
        return np.asarray(acc)[:b]
