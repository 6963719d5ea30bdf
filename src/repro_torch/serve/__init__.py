"""Serving: the shape-bucketing ``TreeEngine`` and the ``EngineSpec`` route.

The gateway, registry, cache, queue and metrics are still to be ported.
"""
from repro_torch.serve.engine import TreeEngine, bucket_rows
from repro_torch.serve.spec import EngineSpec

__all__ = ["EngineSpec", "TreeEngine", "bucket_rows"]
