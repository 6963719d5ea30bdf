"""Per-model serving metrics: throughput, latency + per-stage histograms,
batch occupancy, cache hit rate, per-shard execution timings, per-bucket
compile/warm times.

Recorded by the gateway on every request/batch; surfaced as a plain stats
dict (``MetricsRegistry.stats``), a human table (``render_table``), and the
Prometheus/JSON exposition renderers in ``repro_torch.obs.export``.  Latencies
live in fixed log-scale bucket histograms (:class:`repro_torch.obs.LogHistogram`):
exact counters, O(1) per record, bounded memory, p50/p95/p99 within one
bucket width of the old unbounded reservoir — and mergeable, so per-model
distributions roll up into gateway-level ones (:meth:`MetricsRegistry.
aggregate`) without keeping samples.

Stage histograms attribute where a request's time went: ``queue`` (micro-
batch wait), ``cache`` (probe), ``pad`` (bucket padding), ``shard`` (per-
shard execute), ``merge`` (partial sum), ``finalize`` (reciprocal-multiply +
argmax), ``stitch`` (response reassembly) — drained from the execution plan
after every batch (``TreeEngine.drain_stage_timings``) and surfaced as the
``*_ms`` columns.  Shard timings come per label (``s0:cuda`` for the single
plan, ``s0:cuda[0:64]`` and ``s1:bitvector[64:128]`` for the tree shards of
``tree_parallel``, ``r0/2`` and ``r1/2`` for the row chunks of
``row_parallel``): cumulative wall-ms and call counts, which show whether a
sharded plan balances its shards.
``compile_ms_by_bucket`` tracks the one-time compile/warm cost of each
padded row bucket (``TreeEngine.drain_compile_timings``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.obs.histogram import LogHistogram

# stage means surfaced as first-class stats columns (and table columns)
_STAGE_COLUMNS = ("queue", "pad", "shard", "merge", "finalize")


@dataclass
class ModelMetrics:
    requests: int = 0
    hit_requests: int = 0  # requests served entirely from the response cache
    rows: int = 0
    rejected: int = 0
    batches: int = 0
    batched_rows: int = 0     # real rows sent through the engine
    padded_rows: int = 0      # rows after bucket padding
    cache_hits: int = 0
    cache_misses: int = 0
    latency: LogHistogram = field(default_factory=LogHistogram)
    # per-stage wall-ms histograms: stage name -> LogHistogram
    stages: dict = field(default_factory=dict)
    # per-shard execution time: label -> [ms_total, calls]
    shard_ms: dict = field(default_factory=dict)
    # one-time compile/warm wall-ms per padded row bucket (max wins: a
    # bucket recompiles after a hot-swap, keep the worst cold-start)
    compile_ms: dict = field(default_factory=dict)
    # SIMD ISA the serving backend dispatches to: the host-C backends' column,
    # "-" for every backend the port has, kept so the stats dict carries the
    # JAX package's columns
    isa: str = "-"
    # the warm-time autotuner's chosen backend config (e.g. "interleave=4");
    # "-" when the route is untuned or tuning hasn't run yet
    tuned: str = "-"
    # the canonical EngineSpec string the gateway serves this model on
    # (e.g. "integer:cuda@padded?impl=onehot"); "-" pre-dispatch
    spec: str = "-"
    t_first: float = 0.0
    t_last: float = 0.0

    def _touch(self) -> None:
        """Extend the throughput span to now.  Called for *every* admitted or
        rejected request: a gateway under admission pressure keeps serving
        time even while shedding load, and excluding rejections from the
        span inflated ``rows_per_s`` exactly when it mattered most."""
        now = time.perf_counter()
        if self.t_first == 0.0:
            self.t_first = now
        self.t_last = now

    def record_request(self, n_rows: int, latency_ms: float) -> None:
        self._touch()
        self.requests += 1
        self.rows += n_rows
        self.latency.record(latency_ms)

    def record_rejected(self) -> None:
        self._touch()
        self.rejected += 1

    def record_batch(self, real_rows: int, padded_rows: int) -> None:
        self.batches += 1
        self.batched_rows += real_rows
        self.padded_rows += padded_rows

    def record_cache(self, hits: int, misses: int) -> None:
        self.cache_hits += hits
        self.cache_misses += misses

    def record_stage(self, stage: str, ms: float) -> None:
        """One wall-ms sample for a pipeline stage."""
        h = self.stages.get(stage)
        if h is None:
            h = self.stages.setdefault(stage, LogHistogram())
        h.record(ms)

    def record_stages(self, timings: dict) -> None:
        """Fold one drained ``{stage: (ms_total, calls)}`` batch (from
        ``TreeEngine.drain_stage_timings``) into the stage histograms —
        one mean-per-call sample per stage per drain."""
        for stage, (ms, calls) in timings.items():
            if calls:
                self.record_stage(stage, ms / calls)

    def record_shards(self, timings: dict) -> None:
        """Fold one plan drain (``{label: (ms, calls)}``) into the totals
        and the aggregate ``shard`` stage histogram."""
        for label, (ms, calls) in timings.items():
            tot = self.shard_ms.setdefault(label, [0.0, 0])
            tot[0] += ms
            tot[1] += calls
            if calls:
                self.record_stage("shard", ms / calls)

    def record_compiles(self, timings: dict) -> None:
        """Fold drained per-bucket compile/warm times (``{bucket: ms}``)."""
        for bucket, ms in timings.items():
            self.compile_ms[bucket] = max(self.compile_ms.get(bucket, 0.0), ms)

    def record_isa(self, isa) -> None:
        """Record the backend's dispatched SIMD ISA (None keeps "-")."""
        if isa:
            self.isa = str(isa)

    def record_tuned(self, config) -> None:
        """Record the engine's autotuned config string (None keeps "-")."""
        if config:
            self.tuned = str(config)

    def record_spec(self, spec) -> None:
        """Record the canonical serving-route spec string (None keeps "-")."""
        if spec:
            self.spec = str(spec)

    def _stage_mean(self, stage: str) -> float:
        h = self.stages.get(stage)
        return h.mean if h is not None and h.count else float("nan")

    def stats(self) -> dict:
        span = max(self.t_last - self.t_first, 1e-9)
        probed = self.cache_hits + self.cache_misses
        events = self.requests + self.rejected
        out = {
            "requests": self.requests,
            # fully-cached requests: they flow through the same latency
            # histogram (a hit still costs key hashing + stitch), this just
            # makes their share observable
            "hit_requests": self.hit_requests,
            "rows": self.rows,
            "rejected": self.rejected,
            # a single event gives no usable time span; report 0, not a
            # fabricated rate.  Rejections extend the span (_touch), so an
            # admission-pressured gateway reports its true serving rate.
            "rows_per_s": self.rows / span if events > 1 else 0.0,
            "p50_ms": self.latency.percentile(50),
            "p95_ms": self.latency.percentile(95),
            "p99_ms": self.latency.percentile(99),
            "batches": self.batches,
            # requests coalesced per engine dispatch; > 1 means batching won
            "batch_occupancy": self.batched_rows / self.batches if self.batches else 0.0,
            # real rows / padded rows: how much bucket padding cost
            "pad_efficiency": self.batched_rows / self.padded_rows if self.padded_rows else 0.0,
            "cache_hit_rate": self.cache_hits / probed if probed else 0.0,
            "cache_hits": self.cache_hits,
            "isa": self.isa,
            "tuned": self.tuned,
            "spec": self.spec,
            # the per-stage attribution columns: mean wall ms per stage
            # sample — where a request's latency actually went
            **{f"{stage}_ms": self._stage_mean(stage) for stage in _STAGE_COLUMNS},
            "latency": self.latency.snapshot(),
            "stages": {name: h.snapshot() for name, h in sorted(self.stages.items())},
            # keys are int row buckets plus the autotuner's "tune" entry —
            # sort on the string form so the mix stays orderable
            "compile_ms_by_bucket": dict(
                sorted(self.compile_ms.items(), key=lambda kv: str(kv[0]))
            ),
            # per-shard execution time of the serving plan: mean ms per call
            # exposes shard imbalance, total ms the parallel overlap
            "shards": {
                label: {
                    "ms_total": ms,
                    "calls": calls,
                    "ms_per_call": ms / calls if calls else 0.0,
                }
                for label, (ms, calls) in sorted(self.shard_ms.items())
            },
        }
        return out


# (header, stats key) pairs; "shards" renders the shard-label count
_TABLE_COLS = (
    ("requests", "requests"), ("hit_req", "hit_requests"), ("rows", "rows"),
    ("rejected", "rejected"), ("rows_per_s", "rows_per_s"),
    ("p50_ms", "p50_ms"), ("p95_ms", "p95_ms"), ("p99_ms", "p99_ms"),
    ("queue_ms", "queue_ms"), ("pad_ms", "pad_ms"), ("shard_ms", "shard_ms"),
    ("final_ms", "finalize_ms"), ("occup", "batch_occupancy"),
    ("pad_eff", "pad_efficiency"), ("hit_rate", "cache_hit_rate"),
    ("isa", "isa"), ("tuned", "tuned"), ("shards", "shards"),
    # last column on purpose: the canonical spec string is long and would
    # misalign everything to its right
    ("spec", "spec"),
)


class MetricsRegistry:
    def __init__(self):
        self._models: dict[str, ModelMetrics] = {}

    def model(self, model_id: str) -> ModelMetrics:
        return self._models.setdefault(model_id, ModelMetrics())

    def stats(self) -> dict:
        return {mid: m.stats() for mid, m in sorted(self._models.items())}

    def aggregate(self) -> dict:
        """Cross-model rollup: the latency and stage histograms of every
        model merged counter-wise (exact — the histogram property the old
        percentile reservoir could not offer)."""
        latency = LogHistogram()
        stages: dict = {}
        for m in self._models.values():
            latency.merge(m.latency)
            for name, h in m.stages.items():
                stages.setdefault(name, LogHistogram()).merge(h)
        return {
            "models": len(self._models),
            "requests": sum(m.requests for m in self._models.values()),
            "rejected": sum(m.rejected for m in self._models.values()),
            "latency": latency.snapshot(),
            "stages": {name: h.snapshot() for name, h in sorted(stages.items())},
        }

    def render_table(self) -> str:
        head = f"{'model':14s} " + " ".join(f"{h:>10s}" for h, _ in _TABLE_COLS)
        lines = [head, "-" * len(head)]
        for mid, s in self.stats().items():
            cells = []
            for _, key in _TABLE_COLS:
                v = len(s["shards"]) if key == "shards" else s[key]
                if isinstance(v, float):
                    # zero-sample stages and empty latency histograms are
                    # NaN: render an empty cell, not a bare "nan"
                    cells.append(f"{v:10.3f}" if v == v else f"{'-':>10s}")
                elif isinstance(v, str):
                    cells.append(f"{v:>10s}")
                else:
                    cells.append(f"{v:10d}")
            lines.append(f"{mid:14s} " + " ".join(cells))
        return "\n".join(lines)
