"""Serving subsystem: the shape-bucketing engine and the async gateway.

Request path:  client → Gateway.submit → QuantizedKeyCache (per-row probe)
             → MicroBatcher (coalesce to block-shaped batches under a
               latency deadline, admission-controlled) → ModelRegistry
               (versioned, hot-swappable) → TreeEngine (shape-bucketed)
             → ExecutionPlan (single, tree_parallel, row_parallel)
             → TreeBackend (the cuda walks, the bitvector scorer, or the
               torch reference walk) → cache fill → response.
"""
from repro_torch.serve.cache import QuantizedKeyCache, row_keys
from repro_torch.serve.engine import TreeEngine, bucket_rows
from repro_torch.serve.gateway import Gateway
from repro_torch.serve.metrics import MetricsRegistry, ModelMetrics
from repro_torch.serve.queue import AdmissionError, MicroBatcher
from repro_torch.serve.registry import ModelRegistry, ModelVersion
from repro_torch.serve.spec import EngineSpec

__all__ = [
    "AdmissionError",
    "EngineSpec",
    "Gateway",
    "MetricsRegistry",
    "MicroBatcher",
    "ModelMetrics",
    "ModelRegistry",
    "ModelVersion",
    "QuantizedKeyCache",
    "TreeEngine",
    "bucket_rows",
    "row_keys",
]
