"""Trace + metrics exposition: JSONL spans, flame summaries, Prometheus text.

Three consumers, three renderers over the same data:

  * machines replaying a request → :func:`spans_to_jsonl` /
    :func:`write_jsonl` (one span object per line, trace/span/parent ids
    preserved) and :func:`request_trees` (per-request nested dicts with the
    shared batch-execution subtree grafted under every request that rode it);
  * humans at a terminal → :func:`render_flame`, a flame-graph-style rollup
    (span paths aggregated by name, counts + total/mean ms, indented by
    depth);
  * scrapers → :func:`render_prometheus` over ``MetricsRegistry.stats()``
    output (counters, gauges, and *cumulative* histogram buckets in the
    Prometheus text exposition format) plus :func:`snapshot_json`, the same
    stats as strict JSON (NaN/Inf sanitized to null, numpy scalars coerced).
"""
from __future__ import annotations

import json
import math

__all__ = ["spans_to_jsonl", "write_jsonl", "request_trees", "render_flame",
           "render_prometheus", "snapshot_json"]


# ---------------------------------------------------------------------------
# span export
# ---------------------------------------------------------------------------

def spans_to_jsonl(spans) -> str:
    """One JSON object per completed span, one span per line."""
    return "\n".join(json.dumps(_sanitize(s.to_dict())) for s in spans)


def write_jsonl(spans, path) -> int:
    """Write the JSONL trace to ``path``; returns the span count."""
    spans = list(spans)
    with open(path, "w") as f:
        f.write(spans_to_jsonl(spans))
        if spans:
            f.write("\n")
    return len(spans)


def _children_index(spans):
    """(by_id, children) where ``children[pid]`` lists direct child spans
    plus batch spans adopted via their ``riders`` attr (the shared
    micro-batch execution subtree belongs to every request that rode it)."""
    by_id = {s.span_id: s for s in spans}
    children: dict = {}
    for s in spans:
        if s.parent_id:
            children.setdefault(s.parent_id, []).append(s)
        for rider in s.attrs.get("riders", ()):
            if rider != s.parent_id and rider in by_id:
                children.setdefault(rider, []).append(s)
    for sibs in children.values():
        sibs.sort(key=lambda s: s.t0)
    return by_id, children


def request_trees(spans, root_name: str = "request") -> list:
    """Per-request nested span trees (dicts), batch subtrees grafted under
    each rider."""
    _, children = _children_index(spans)

    def tree(s):
        return {
            "name": s.name,
            "span": s.span_id,
            "dur_ms": s.duration_ms,
            "attrs": _sanitize({k: v for k, v in s.attrs.items() if k != "riders"}),
            "children": [tree(c) for c in children.get(s.span_id, ())],
        }

    return [tree(s) for s in sorted(spans, key=lambda s: s.t0)
            if s.name == root_name]


def render_flame(spans, *, min_ms: float = 0.0) -> str:
    """Flame-style rollup: spans aggregated by their name-path, indented by
    depth, with call counts and total/mean wall ms.  Shard children of one
    batch overlap in time, so a level's totals may exceed its parent's —
    that overlap is the parallelism the plan bought."""
    by_id, children = _children_index(spans)

    # paths from each root; adoption means a span can appear on several paths
    agg: dict = {}  # path tuple -> [count, total_ns]
    roots = [s for s in spans if not s.parent_id or s.parent_id not in by_id]

    def walk(s, prefix):
        path = prefix + (s.name,)
        ent = agg.setdefault(path, [0, 0])
        ent[0] += 1
        ent[1] += (s.t1 or s.t0) - s.t0
        for c in children.get(s.span_id, ()):
            if c.parent_id == s.span_id or s.span_id in c.attrs.get("riders", ()):
                walk(c, path)

    for r in roots:
        walk(r, ())
    lines = [f"{'span':42s} {'count':>8s} {'total_ms':>12s} {'mean_ms':>10s}"]
    lines.append("-" * len(lines[0]))
    for path in sorted(agg):
        count, ns = agg[path]
        ms = ns / 1e6
        if ms < min_ms:
            continue
        label = "  " * (len(path) - 1) + path[-1]
        lines.append(f"{label:42s} {count:8d} {ms:12.3f} {ms / count:10.4f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# metrics exposition
# ---------------------------------------------------------------------------

def _sanitize(obj):
    """Strict-JSON coercion: NaN/Inf -> None, numpy scalars -> python."""
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, float):
        return None if (math.isnan(obj) or math.isinf(obj)) else obj
    if hasattr(obj, "item"):  # numpy scalar
        return _sanitize(obj.item())
    return obj


def snapshot_json(stats: dict, **meta) -> str:
    """The stats dict as strict JSON (scrape-safe: no NaN/Infinity tokens)."""
    return json.dumps(_sanitize({**meta, "stats": stats}), indent=2,
                      allow_nan=False) + "\n"


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def _hist_lines(metric: str, labels: str, snap: dict) -> list:
    """Prometheus cumulative histogram series from a LogHistogram snapshot
    (whose buckets are per-bucket counts with ``None`` = +Inf edge)."""
    lines, cum = [], 0
    for le, c in snap.get("buckets", ()):
        cum += c
        edge = "+Inf" if le is None else repr(float(le))
        lines.append(f'{metric}_bucket{{{labels},le="{edge}"}} {cum}')
    if not snap.get("buckets") or snap["buckets"][-1][0] is not None:
        lines.append(f'{metric}_bucket{{{labels},le="+Inf"}} {snap["count"]}')
    lines.append(f"{metric}_sum{{{labels}}} {_fmt(float(snap['sum']))}")
    lines.append(f"{metric}_count{{{labels}}} {snap['count']}")
    return lines


_COUNTERS = (
    ("requests_total", "requests", "requests served"),
    ("hit_requests_total", "hit_requests", "requests served entirely from cache"),
    ("rows_total", "rows", "rows served"),
    ("rejected_total", "rejected", "requests rejected by admission control"),
    ("batches_total", "batches", "engine batch dispatches"),
    ("cache_hits_total", "cache_hits", "row cache hits"),
)
_GAUGES = (
    ("rows_per_s", "rows_per_s", "serving throughput over the active span"),
    ("batch_occupancy", "batch_occupancy", "mean real rows per engine dispatch"),
    ("pad_efficiency", "pad_efficiency", "real rows / bucket-padded rows"),
    ("cache_hit_rate", "cache_hit_rate", "row cache hit rate"),
)


def render_prometheus(per_model: dict, *, namespace: str = "repro") -> str:
    """``MetricsRegistry.stats()`` -> Prometheus text exposition format.

    Emits per-model counters and gauges, the request-latency histogram, one
    ``stage_ms`` histogram per pipeline stage (queue / pad / shard / merge /
    finalize / ...), per-shard cumulative wall ms, and per-bucket
    compile/warm times.
    """
    out = []

    def head(metric, mtype, help_):
        out.append(f"# HELP {namespace}_{metric} {help_}")
        out.append(f"# TYPE {namespace}_{metric} {mtype}")

    for metric, key, help_ in _COUNTERS:
        head(metric, "counter", help_)
        for mid, s in per_model.items():
            out.append(f'{namespace}_{metric}{{model="{mid}"}} {int(s[key])}')
    for metric, key, help_ in _GAUGES:
        head(metric, "gauge", help_)
        for mid, s in per_model.items():
            v = s[key]
            if isinstance(v, float) and math.isnan(v):
                continue
            out.append(f'{namespace}_{metric}{{model="{mid}"}} {_fmt(float(v))}')

    head("request_latency_ms", "histogram", "end-to-end request latency")
    for mid, s in per_model.items():
        if "latency" in s:
            out.extend(_hist_lines(f"{namespace}_request_latency_ms",
                                   f'model="{mid}"', s["latency"]))
    head("stage_ms", "histogram", "per-stage wall time within a request")
    for mid, s in per_model.items():
        for stage, snap in sorted(s.get("stages", {}).items()):
            out.extend(_hist_lines(f"{namespace}_stage_ms",
                                   f'model="{mid}",stage="{stage}"', snap))

    head("shard_ms_total", "counter", "cumulative per-shard execution wall ms")
    head("shard_calls_total", "counter", "per-shard execution calls")
    for mid, s in per_model.items():
        for label, sh in s.get("shards", {}).items():
            lbl = f'model="{mid}",shard="{label}"'
            out.append(f'{namespace}_shard_ms_total{{{lbl}}} {_fmt(float(sh["ms_total"]))}')
            out.append(f'{namespace}_shard_calls_total{{{lbl}}} {int(sh["calls"])}')

    head("bucket_compile_ms", "gauge",
         "compile/warm wall ms of each padded row bucket")
    for mid, s in per_model.items():
        # buckets are int row counts plus the autotuner's "tune" entry
        for bucket, ms in sorted(s.get("compile_ms_by_bucket", {}).items(),
                                 key=lambda kv: str(kv[0])):
            out.append(f'{namespace}_bucket_compile_ms'
                       f'{{model="{mid}",bucket="{bucket}"}} {_fmt(float(ms))}')
    return "\n".join(out) + "\n"
