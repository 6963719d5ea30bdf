"""Observability: request tracing, histogram telemetry, exposition.

The serving stack's measurement layer, threaded through the whole execution
path — ``Gateway`` admission → cache probe → micro-batch queue wait → engine
bucket/pad → ``ExecutionPlan`` dispatch → per-shard ``predict_partials`` →
finalize → response stitch:

  * :mod:`repro_torch.obs.trace` — staged spans: nested, thread-safe,
    sampled, near-zero cost when disabled (``NULL_SPAN`` propagation).
  * :mod:`repro_torch.obs.histogram` — fixed log-scale bucket histograms:
    O(1) record, exact counters, mergeable across shards and models.
  * :mod:`repro_torch.obs.export` — JSONL trace export, flame-style
    summaries, Prometheus-text + strict-JSON metric snapshots.

Pure Python, the same as the JAX package's ``obs`` layer, so traces and
metric exports of the two packages compare line for line.  Attach a tracer
with ``Gateway(..., tracer=Tracer())``; stage histograms are always on —
they cost one ``perf_counter_ns`` pair per stage — and surface as the
``queue_ms`` / ``pad_ms`` / ``shard_ms`` / ``finalize_ms`` columns in
``MetricsRegistry.stats()``.  Stage wall times on the card stay honest
because the backends return host arrays, which waits for the device.
"""
from repro_torch.obs.export import (render_flame, render_prometheus, request_trees,
                                    snapshot_json, spans_to_jsonl, write_jsonl)
from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer

__all__ = [
    "LogHistogram",
    "NULL_SPAN",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "render_flame",
    "render_prometheus",
    "request_trees",
    "snapshot_json",
    "spans_to_jsonl",
    "write_jsonl",
]
