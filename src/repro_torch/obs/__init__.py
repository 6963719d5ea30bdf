"""Observability: request tracing, histogram telemetry, exposition.

The serving stack's measurement layer, threaded through the whole execution
path — ``Gateway`` admission → cache probe → micro-batch queue wait → engine
bucket/pad → ``ExecutionPlan`` dispatch → per-shard ``predict_partials`` →
finalize → response stitch:

  * :mod:`repro_torch.obs.trace` — staged spans: nested, thread-safe,
    sampled, near-zero cost when disabled (``NULL_SPAN`` propagation);
    ``profiled(name)``, the stages as ``torch.profiler`` ranges; and
    ``stage(...)``, which times a block into a stage sample, a span and a
    range at once.
  * :mod:`repro_torch.obs.histogram` — fixed log-scale bucket histograms:
    O(1) record, exact counters, mergeable across shards and models.
  * :mod:`repro_torch.obs.export` — JSONL trace export, flame-style
    summaries, Prometheus-text + strict-JSON metric snapshots.

Spans, histograms and exports are pure Python, the same as the JAX
package's ``obs`` layer, so traces and metric exports of the two packages
compare line for line.  Attach a tracer
with ``Gateway(..., tracer=Tracer())``; stage histograms are always on —
they cost one ``perf_counter_ns`` pair per stage — and surface as the
``queue_ms`` / ``pad_ms`` / ``shard_ms`` / ``finalize_ms`` columns in
``MetricsRegistry.stats()``.  Stage wall times on the card stay honest
because the backends return host arrays, which waits for the device.

While a ``torch.profiler`` records, every stage also runs inside a named
range (torch's ``_RecordFunctionFast``, which keeps the interpreter lock),
on the profiler's clock, so a device trace says which stage the host was in
while the card waited: ``gateway.cache_probe``,
``gateway.stitch``, ``batcher.assemble`` and ``batcher.scatter`` on the event
loop; ``gateway.batch`` and ``gateway.record`` on the batch thread;
``engine.pad``, ``plan.shard`` and ``plan.finalize`` in the engine; and
``backend.rows_in``, ``backend.keys``, ``backend.launch`` and
``backend.rows_out`` inside the card's backends.  No flag turns them on: they
exist exactly while a profiler records, and otherwise each site costs one
flag read.  A profiler keeps the ranges of the threads it records (by
default only the one that started it).
"""
from repro_torch.obs.export import (render_flame, render_prometheus, request_trees,
                                    snapshot_json, spans_to_jsonl, write_jsonl)
from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer, profiled, stage

__all__ = [
    "LogHistogram",
    "NULL_SPAN",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "profiled",
    "render_flame",
    "render_prometheus",
    "request_trees",
    "snapshot_json",
    "spans_to_jsonl",
    "stage",
    "write_jsonl",
]
