"""Serving subsystem: the shape-bucketing engine, the async gateway, and the
shard-worker fabric.

Request path:  client → Gateway.submit → QuantizedKeyCache (per-row probe)
             → MicroBatcher (coalesce to block-shaped batches under a
               latency deadline, admission-controlled) → ModelRegistry
               (versioned, hot-swappable, ITRF artifacts mmap-loaded)
             → TreeEngine (shape-bucketed)
             → ExecutionPlan (single, tree_parallel, row_parallel, or
               remote_tree_parallel over ``worker`` processes and ``wire``)
             → TreeBackend (the cuda walks, the bitvector scorer, or the
               torch reference walk) → cache fill → response.

The names below load on first use, so ``python -m repro_torch.serve.worker``
binds its listener before torch loads.
"""
import importlib

_EXPORTS = {
    "QuantizedKeyCache": "cache", "row_keys": "cache",
    "LMEngine": "engine", "TreeEngine": "engine", "bucket_rows": "engine",
    "Gateway": "gateway",
    "MetricsRegistry": "metrics", "ModelMetrics": "metrics",
    "AdmissionError": "queue", "MicroBatcher": "queue",
    "ModelRegistry": "registry", "ModelVersion": "registry",
    "EngineSpec": "spec",
    "WorkerServer": "worker", "spawn_local_workers": "worker",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
