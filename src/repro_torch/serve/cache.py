"""Exact-match response cache keyed on FlInt-quantized int32 feature keys.

The FlInt transform (``float_to_key``) maps every float32 feature vector to a
canonical int32 vector: two requests whose features quantize to the same key
vector are guaranteed — for the ``flint``/``integer`` modes, whose outputs
are bit-deterministic integers — to produce byte-identical scores.  That
makes an exact-match response cache *semantically safe*: a hit returns
exactly what the engine would have computed.  The float mode gives no such
guarantee (float accumulation order), so the gateway only enables the cache
for deterministic engines.

Keys are ``(model_id, version, mode, row_key_bytes)`` so a hot-swap to a new
model version naturally orphans stale entries (LRU evicts them).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.flint import float_to_key_np


def row_keys(X) -> list:
    """Per-row cache key material: FlInt int32 key vector bytes."""
    keys = float_to_key_np(np.ascontiguousarray(X, np.float32))
    return [keys[i].tobytes() for i in range(keys.shape[0])]


class QuantizedKeyCache:
    """LRU cache of per-row (scores, pred) results."""

    def __init__(self, capacity_rows: int = 65536):
        self.capacity_rows = capacity_rows
        self._od: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def key_for(model_id: str, version: int, mode: str, row_key: bytes) -> tuple:
        return (model_id, version, mode, row_key)

    def get(self, key) -> Optional[Tuple[np.ndarray, int]]:
        hit = self._od.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key, scores_row: np.ndarray, pred: int) -> None:
        if self.capacity_rows <= 0:
            return
        if key in self._od:
            self._od.move_to_end(key)
        self._od[key] = (np.asarray(scores_row).copy(), int(pred))
        while len(self._od) > self.capacity_rows:
            self._od.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._od)

    def stats(self) -> dict:
        probed = self.hits + self.misses
        return {
            "rows": len(self._od),
            "capacity_rows": self.capacity_rows,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hits / probed if probed else 0.0,
        }
