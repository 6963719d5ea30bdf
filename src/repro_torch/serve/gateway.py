"""The serving gateway: cache → micro-batcher → registry → engine → plan.

``Gateway.submit(model_id, X)`` is the one client entry point.  It first
probes the :class:`QuantizedKeyCache` with the request's rows at once (exact
FlInt-key match — safe because the flint/integer engines are
bit-deterministic); rows that miss are coalesced by the
:class:`MicroBatcher` into block-shaped batches and executed on the
:class:`TreeEngine` of the model's *current* registry version for the
gateway's route (an :class:`EngineSpec` such as ``integer:cuda`` or
``integer:cuda@padded?impl=onehot``) on the gateway's ``device``, then
filled into the cache in one call.  Every deterministic route gives the same
bits, so cache entries stay keyed on (model, version, mode) only.  The
response stitches cached and computed rows back into request order by
indexing, so callers always see exactly what a direct
``TreeEngine.predict_scores`` on their rows would return, bit for bit.

The batcher runs each batch in an executor thread, so several model lanes —
and several gateways — launch kernels from threads at once; the kernels'
launch counters take a lock, and every launch goes to the thread's current
stream.  The backend returns host arrays, which waits for the device, so
the stage wall times below include the device work.

Metrics (per-model latency percentiles, throughput, batch occupancy, cache
hit rate, admission rejects) are recorded on every request — including
requests served entirely from cache, which count into the latency histogram
and the ``hit_requests`` counter — and surfaced via ``Gateway.stats()`` /
``Gateway.render_table()``.  Per-stage wall time (queue wait, bucket pad,
shard execute, finalize, cache probe, response stitch) is always recorded
into log-scale histograms (``stats()["per_model"][mid]["stages"]`` and the
``*_ms`` table columns).

Tracing is opt-in: pass ``tracer=repro_torch.obs.Tracer(...)`` and every
sampled request carries a span tree — ``request`` → ``cache_probe`` /
``queue`` / ``batch`` (→ ``pad`` → ``shard:*`` → ``finalize``) → ``stitch``.
A batch shared by several coalesced requests emits ONE batch subtree,
parented under the first live rider and tagged with every rider's span id
(``attrs["riders"]``) so the export layer grafts it under each.  Untraced
gateways pay one falsy-check per stage (``NULL_TRACER`` / ``NULL_SPAN``
propagate through every hook).  While a ``torch.profiler`` records, the same
stages are named ranges in its trace (``repro_torch.obs.profiled``):
``gateway.cache_probe`` and ``gateway.stitch`` here on the event loop,
``gateway.batch`` and ``gateway.record`` on the batch thread.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.backends import backend_class
from repro_torch.device import resolve_device
from repro_torch.obs import NULL_TRACER, profiled, stage
from repro_torch.serve.cache import QuantizedKeyCache, row_keys
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.queue import AdmissionError, MicroBatcher
from repro_torch.serve.registry import ModelRegistry

# a probe with no hit: no rows, no scores, no preds
_NO_HITS = (np.empty(0, np.intp), None, None)


class Gateway:
    def __init__(self, registry: ModelRegistry, spec=None, *,
                 max_batch_rows: int = 256,
                 max_delay_ms: float = 2.0, max_queue_rows: int = 4096,
                 cache_rows: int = 65536, tracer=None, device=None,
                 plan_kwargs: dict = None):
        from repro_torch.core.ensemble import mode_spec
        from repro_torch.plan import plan_class, select_plan
        from repro_torch.serve.spec import EngineSpec

        self.registry = registry
        # every engine this gateway builds lives on this device (``cuda``
        # unless ``device="cpu"`` is passed; without a card it raises here)
        self.device = resolve_device(device)
        # NULL_TRACER hands out falsy NULL_SPANs, so every span hook below
        # short-circuits to a no-op when tracing is off
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the serving route is one EngineSpec (object, dict, or spec string
        # like "integer:cuda@padded?impl=onehot"); None is the default route
        spec = EngineSpec.coerce(spec, caller="Gateway")
        self.spec = spec
        self.mode = spec.mode
        self.backend = spec.backend
        self.layout = spec.layout  # None -> backend's preferred ForestIR layout
        # deployment knobs for the plan (``device_parallel``,
        # ``clamp_shards``), forwarded to every engine this gateway builds
        self.plan_kwargs = plan_kwargs
        # resolve the plan once here so an impossible route (an unknown
        # plan, or a partial-merging plan in float mode) fails at
        # construction like any other bad route, not on the first request's
        # lazy engine build
        resolved_plan = select_plan(spec.plan, mode=spec.mode,
                                    backend=spec.backend, shards=spec.shards)
        if plan_class(resolved_plan).deterministic_only \
                and not mode_spec(spec.mode).deterministic:
            raise ValueError(
                f"plan {resolved_plan!r} needs exact integer partials; mode "
                f"{spec.mode!r} accumulates floats — use 'row_parallel' to "
                f"shard"
            )
        self.metrics = MetricsRegistry()
        # every engine this gateway built, so close() can release them
        self._engines: dict = {}
        # validate the route up front and let the backends' declared
        # capabilities decide cacheability: the cache is only sound when
        # every shard backend promises bit-deterministic outputs for this
        # mode.  ``backend`` may be a sequence of names (heterogeneous
        # tree-parallel shards): all of them must agree.
        names = [self.backend] if isinstance(self.backend, str) \
            else list(self.backend)
        deterministic = True
        for name in names:
            caps = backend_class(name).capabilities
            if self.mode not in caps.modes:
                raise ValueError(
                    f"backend {name!r} does not implement mode {self.mode!r}; "
                    f"supported modes: {caps.modes}"
                )
            if self.layout is not None:
                caps.require_layout(self.layout, name)
            deterministic &= self.mode in caps.deterministic_modes
        # cache keys stay (model, version, mode, row-key): deterministic-mode
        # scores are bit-identical across layouts, backends and plans, so
        # entries are shared no matter which route computed them
        self.cache = QuantizedKeyCache(cache_rows if deterministic else 0)
        self.batcher = MicroBatcher(
            self._execute,
            max_batch_rows=max_batch_rows,
            max_delay_ms=max_delay_ms,
            max_queue_rows=max_queue_rows,
            on_batch=lambda mid, rows, padded: self.metrics.model(mid).record_batch(rows, padded),
            on_queue=self._record_queue_waits,
            tracer=self.tracer,
            pass_spans=True,
        )

    def _record_queue_waits(self, model_id: str, waits_ms: list) -> None:
        mm = self.metrics.model(model_id)
        for w in waits_ms:
            mm.record_stage("queue", w)

    # ----------------------------------------------------------- execution
    def _engine(self, mv):
        eng = mv.engine(self.spec, device=self.device, plan_kwargs=self.plan_kwargs)
        # memoized per route inside the ModelVersion, so this dict stays
        # small: one entry per (version, route) this gateway ever dispatched.
        # Engines the registry's retention policy closed (released versions)
        # are pruned here, so swapped-out versions actually free.
        if any(e.closed for e in self._engines.values()):
            self._engines = {k: e for k, e in self._engines.items()
                             if not e.closed}
        self._engines[id(eng)] = eng
        return eng

    def _execute(self, model_id: str, X: np.ndarray, rider_spans=()):
        """Batch executor handed to the MicroBatcher (runs in a thread).

        ``rider_spans`` are the coalesced requests' spans in batch order.
        The batch subtree (pad → shard → finalize) is emitted once, parented
        under the first *live* rider and tagged with every rider's span id —
        the export layer grafts it under each of them.
        """
        with profiled("gateway.batch"):
            mv = self.registry.get(model_id)  # resolve version at dispatch time
            eng = self._engine(mv)
            mm = self.metrics.model(model_id)
            live = [s for s in rider_spans if s]
            batch_span = None
            if live:
                batch_span = self.tracer.child(
                    live[0], "batch", model=model_id, rows=len(X),
                    riders=[s.span_id for s in live],
                )
            eng.attach_trace(self.tracer, batch_span)
            try:
                scores, preds = eng.predict_scores(X)
            finally:
                eng.detach_trace()
                if batch_span:
                    batch_span.end()
            with profiled("gateway.record"):
                # per-shard + per-stage wall time of this dispatch -> metrics row
                mm.record_shards(eng.drain_shard_timings())
                mm.record_stages(eng.drain_stage_timings())
                mm.record_compiles(eng.drain_compile_timings())
                # the dispatched SIMD ISA (free here: the batch above already
                # built the backend, so the probe never triggers a compile)
                mm.record_isa(eng.simd_isa())
                mm.record_tuned(eng.tuned_config)
                mm.record_spec(str(self.spec))
            # meta = the version that actually computed, so cache fills are
            # keyed consistently even when a hot-swap lands between submit and
            # dispatch
            return scores, preds, eng.padded_rows(len(X)), mv.version

    # -------------------------------------------------------------- submit
    async def submit(self, model_id: str, X):
        """Serve one request of 1..n rows.  Returns (scores, preds)."""
        t0 = time.perf_counter()
        X = np.atleast_2d(np.asarray(X, np.float32))
        n = X.shape[0]
        if n == 0 or X.size == 0:
            raise ValueError("empty request")
        mm = self.metrics.model(model_id)
        mv = self.registry.get(model_id)
        cacheable = self.cache.capacity_rows > 0
        # NULL_SPAN when tracing is off or this request is unsampled —
        # every child hook below then short-circuits
        span = self.tracer.request_span("request", model=model_id, rows=n)

        with stage("gateway.cache_probe", mm.record_stage, "cache", self.tracer,
                   span, "cache_probe") as st:
            hit_idx, h_scores, h_preds = _NO_HITS
            if cacheable:
                keys = row_keys(X)
                hit_idx, h_scores, h_preds = self.cache.probe(
                    (model_id, mv.version, self.mode), keys)
                mm.record_cache(len(hit_idx), n - len(hit_idx))
            st.attrs = {"hits": len(hit_idx), "rows": n}

        if len(hit_idx) == n:
            # served entirely from cache: skip the batcher, count the request
            # into hit_requests, and record latency like any other request —
            # a gateway that timed only its misses would report p50/p95 far
            # worse than what a high-hit-rate client stream experiences.
            with stage("gateway.stitch", mm.record_stage, "stitch"):
                scores, preds = self._stitch(n, hit_idx, h_scores, h_preds,
                                             None, None, None)
            mm.hit_requests += 1
            mm.record_request(n, (time.perf_counter() - t0) * 1e3)
            span.end(cache="all_hit")
            return scores, preds
        miss_idx = slice(None)  # every row, as a view
        if len(hit_idx):
            missed = np.ones(n, bool)
            missed[hit_idx] = False
            miss_idx = np.flatnonzero(missed)
        try:
            m_scores, m_preds, served_version = await self.batcher.submit(
                model_id, X[miss_idx], span=span
            )
            if len(hit_idx) and served_version != mv.version:
                # a hot-swap landed between the cache probe and dispatch:
                # the hits are from the old version.  Recompute the whole
                # request in ONE batcher call — a single execute runs on a
                # single version, so the response cannot mix versions.
                hit_idx, h_scores, h_preds = _NO_HITS
                miss_idx = slice(None)
                m_scores, m_preds, served_version = await self.batcher.submit(
                    model_id, X, span=span
                )
        except AdmissionError:
            # rejected requests still advance the throughput span: the
            # gateway was demonstrably live at this instant
            mm.record_rejected()
            span.end(rejected=True)
            raise
        with stage("gateway.stitch", mm.record_stage, "stitch", self.tracer, span,
                   cached=len(hit_idx), computed=n - len(hit_idx)):
            if cacheable:
                self.cache.fill(
                    (model_id, served_version, self.mode),
                    keys if isinstance(miss_idx, slice)
                    else list(map(keys.__getitem__, miss_idx.tolist())),
                    m_scores, m_preds,
                )
            scores, preds = self._stitch(n, hit_idx, h_scores, h_preds,
                                         miss_idx, m_scores, m_preds)
        mm.record_request(n, (time.perf_counter() - t0) * 1e3)
        span.end()
        return scores, preds

    @staticmethod
    def _stitch(n, hit_idx, h_scores, h_preds, miss_idx, m_scores, m_preds):
        """Reassemble cached and computed rows into request order."""
        # shape/dtype from the results themselves: after a mid-request
        # hot-swap the serving version's class count may differ from mv's
        proto = m_scores if m_scores is not None else h_scores
        scores = np.empty((n, proto.shape[-1]), proto.dtype)
        preds = np.empty(n, np.int32)
        if len(hit_idx):
            scores[hit_idx] = h_scores
            preds[hit_idx] = h_preds
        if m_scores is not None:
            scores[miss_idx] = m_scores
            preds[miss_idx] = m_preds
        return scores, preds

    # ------------------------------------------------------------- control
    async def close(self) -> None:
        """Drain, then tear down.

        The batcher close first *drains*: every batch already dispatched to
        an engine runs to completion and resolves its futures; only rows
        still queued un-dispatched past the batcher's timeout are failed.
        Engines close after, so no in-flight dispatch is ever abandoned.
        """
        await self.batcher.close()
        for eng in self._engines.values():
            eng.close()
        self._engines.clear()

    def stats(self) -> dict:
        return {
            "models": self.registry.describe(),
            "per_model": self.metrics.stats(),
            "cache": self.cache.stats(),
        }

    def render_table(self) -> str:
        return self.metrics.render_table()
