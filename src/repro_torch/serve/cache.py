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

The cache works on a whole request at once: :meth:`QuantizedKeyCache.probe`
and :meth:`QuantizedKeyCache.fill` take a namespace ``(model_id, version,
mode)`` and the request's row keys, and every per-row step runs inside C
calls (``map`` over a dict's methods, numpy indexing).  Each namespace maps
its row keys to slots; a slot's scores and prediction live in numpy tables
shared by every namespace of one class count and dtype, and its last touch
in a stamp.  The LRU order is the stamps' order, kept as a log of touches
so the oldest entries are found without a sort.  The order, the counters
and what survives are exactly those of a per-row ``get`` of every row in
row order, then a ``put`` of every missed row in row order — which is what
:meth:`get` and :meth:`put` are.
"""
from __future__ import annotations

from collections import deque
from functools import lru_cache
from itertools import compress, repeat
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.flint import float_to_key_np


def row_keys(X) -> list:
    """Per-row cache key material: FlInt int32 key vector bytes."""
    keys = float_to_key_np(np.ascontiguousarray(X, np.float32))
    keys = np.ascontiguousarray(keys.reshape(keys.shape[0], -1))
    if not keys.shape[1]:
        return [b""] * keys.shape[0]
    # one void item a row: tolist() hands back each row's bytes in one call
    return keys.view(_row_dtype(keys.shape[1])).ravel().tolist()


@lru_cache(maxsize=16)
def _row_dtype(width: int) -> np.dtype:
    return np.dtype((np.void, 4 * width))


_NO_ROWS = np.empty(0, np.intp)


def _consume(it) -> None:
    deque(it, maxlen=0)


def _earlier_smaller(v: np.ndarray) -> np.ndarray:
    """For each ``v[i]``, how many ``v[j]`` with ``j < i`` are smaller.

    Bottom-up over blocks of doubling width: at each width a right half's
    values are counted against its left half's, sorted, so every pair is
    counted once, at the width where it splits.
    """
    n = len(v)
    out = np.zeros(n, np.intp)
    at = np.arange(n)
    span = int(v.max()) + 1 if n else 1
    width = 1
    while width < n:
        block, right = at // (2 * width), (at // width) % 2 == 1
        left = np.sort(block[~right] * span + v[~right])
        base = block[right] * span
        out[right] += np.searchsorted(left, base + v[right]) - np.searchsorted(left, base)
        width *= 2
    return out


class QuantizedKeyCache:
    """LRU cache of per-row (scores, pred) results."""

    def __init__(self, capacity_rows: int = 65536):
        self.capacity_rows = capacity_rows
        cap = max(capacity_rows, 0)
        # namespace -> its id; by id: its {row key: slot} and its class's
        # (scores, preds) table, one per class count and dtype, ``cap`` rows
        # (pages are touched as slots fill); ids of namespaces with no entry
        # left are reused
        self._space_of: dict = {}
        self._free: list = []
        self._indexes: list = []
        self._table_at: list = []
        self._tables: dict = {}
        # the live entries hold slots 0 .. _size - 1
        self._size = 0
        self._row_key = np.empty(cap, object)
        self._space = np.zeros(cap, np.int32)
        # an entry's last touch; the log holds each touch's slot at its
        # stamp, so a log entry is live while its slot's stamp points at it
        self._stamp = np.zeros(cap, np.int64)
        self._log = np.empty(max(2 * cap, 1024), np.int64)
        self._arange = np.arange(len(self._log))  # stamps to slice, and slots
        self._head = self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.probes = 0

    @staticmethod
    def key_for(model_id: str, version: int, mode: str, row_key: bytes) -> tuple:
        return (model_id, version, mode, row_key)

    # ---------------------------------------------------------------- batch
    def probe(self, namespace, row_keys):
        """Look up a request's rows; hits become most recent, in row order.

        Returns ``(hit_rows, scores, preds)``: the hit rows' positions in the
        request and their scores ``(hits, classes)`` and preds ``(hits,)``,
        or ``(hit_rows, None, None)`` when nothing hit.
        """
        n = len(row_keys)
        self.probes += 1
        space = self._space_of.get(namespace)
        if space is None:  # no row of this namespace was ever stored
            self.misses += n
            return _NO_ROWS, None, None
        index = self._indexes[space]
        if n == 1:  # one row: the same steps on Python scalars
            slot = index.get(row_keys[0], -1)
            if slot < 0:
                self.misses += 1
                return _NO_ROWS, None, None
            self.hits += 1
            self._touch_one(slot)
            scores, preds = self._table_at[space]
            return np.zeros(1, np.intp), scores[slot:slot + 1].copy(), preds[slot:slot + 1].copy()
        slots = np.fromiter(map(index.get, row_keys, repeat(-1)), np.intp, n)
        hit = slots >= 0
        hits = int(np.count_nonzero(hit))
        self.hits += hits
        self.misses += n - hits
        if not hits:
            return _NO_ROWS, None, None
        rows = hit.nonzero()[0]
        slots = slots[rows]
        self._touch(slots, repeats=True)
        scores, preds = self._table_at[space]
        return rows, scores[slots], preds[slots]

    def fill(self, namespace, row_keys, scores, preds) -> None:
        """Store computed rows; they become most recent, in row order."""
        m, cap = len(row_keys), self.capacity_rows
        if cap <= 0 or not m:
            return
        scores, preds = np.asarray(scores), np.asarray(preds)
        space = self._space_of.get(namespace)
        if space is None:
            space = self._add_space(namespace, scores)
        if m == 1:
            self._put_one(space, row_keys[0], scores[0], preds[0])
            return
        # a round of at most ``cap + 1`` rows cannot evict a key between two
        # of its own rows, so one request that fits the cache is one round
        for i in range(0, m, cap + 1):
            self._fill_round(space, row_keys[i:i + cap + 1], scores[i:i + cap + 1],
                             preds[i:i + cap + 1])

    def _add_space(self, namespace, scores) -> int:
        """A new namespace's id: that of a namespace whose entries are all
        gone (as LRU empties a swapped-out version), else a new one."""
        table = (scores.shape[-1], scores.dtype.str)
        if table not in self._tables:
            self._tables[table] = (np.empty((self.capacity_rows, scores.shape[-1]), scores.dtype),
                                   np.empty(self.capacity_rows, np.int32))
        for ns in [ns for ns, space in self._space_of.items() if not self._indexes[space]]:
            self._free.append(self._space_of.pop(ns))
        if self._free:
            space = self._free.pop()
        else:
            space = len(self._indexes)
            self._indexes.append({})
            self._table_at.append(None)
        self._space_of[namespace] = space
        self._table_at[space] = self._tables[table]
        return space

    def _put_one(self, space, key, scores_row, pred) -> None:
        """A one-row fill: the same steps on Python scalars."""
        index = self._indexes[space]
        slot = index.get(key, -1)
        if slot < 0:
            if self._size < self.capacity_rows:
                slot = self._size
                self._size += 1
            else:  # the oldest entry makes room
                oldest, self._head = self._lru(1)
                slot = int(oldest[0])
                del self._indexes[self._space[slot]][self._row_key[slot]]
                self.evictions += 1
            index[key] = slot
            self._row_key[slot] = key
            self._space[slot] = space
        self._touch_one(slot)
        scores_t, preds_t = self._table_at[space]
        scores_t[slot] = scores_row
        preds_t[slot] = pred

    def _fill_round(self, space, keys, scores, preds) -> None:
        """Store a round's rows as a ``put`` a row in row order would.

        The round's keys take the newest stamps by last occurrence, the
        oldest other entries make room, and new keys take the freed slots:
        the entries, their order and values are then a put a row's.  So are
        the evictions, which count every put that found its key absent: a
        new key, or a stored one that the round's earlier inserts pushed out
        before its first row (:meth:`_pushed_out`).
        """
        cap, size = self.capacity_rows, self._size
        index = self._indexes[space]
        last = dict(zip(keys, range(len(keys))))  # by first occurrence
        firsts = list(last)
        slots = np.fromiter(map(index.get, firsts, repeat(-1)), np.intp, len(firsts))
        new = slots < 0
        inserts = int(np.count_nonzero(new))
        if inserts < len(firsts):
            inserts += self._pushed_out(slots, new)
        rows = slice(None)
        if len(firsts) < len(keys):  # a repeated row keeps its last value and place
            rows = np.fromiter(last.values(), np.intp, len(firsts))
            by_last = np.argsort(rows)
            rows, slots, new = rows[by_last], slots[by_last], new[by_last]
            keys = list(map(firsts.__getitem__, by_last.tolist()))
        else:
            keys = firsts
        if len(keys) > cap:  # only the last ``cap`` of the round stay
            rows = np.arange(len(scores))[rows][-cap:]
            keys, slots, new = keys[-cap:], slots[-cap:], new[-cap:]
        # stored keys take their new stamps first, so no eviction finds them
        self._reserve(len(keys))
        self._stamp[slots[~new]] = self._arange[self._clock:self._clock + len(keys)][~new]
        new_keys = list(compress(keys, new.tolist()))
        drop = size + len(new_keys) - cap
        freed = _NO_ROWS
        if drop > 0:
            freed, self._head = self._lru(drop)
            self._drop(freed)
        slots[new] = np.concatenate([freed, self._arange[size:size + len(new_keys) - len(freed)]])
        self._size = size + len(new_keys) - len(freed)
        fresh = slots[new]
        index.update(zip(new_keys, fresh.tolist()))
        self._store(space, slots, scores[rows], preds[rows], fresh, new_keys)
        self.evictions += size + inserts - self._size

    def _store(self, space, slots, scores, preds, fresh, fresh_keys) -> None:
        """Write a round's values and make its slots the newest, in order;
        the ``fresh`` slots take ``fresh_keys``."""
        self._row_key[fresh] = fresh_keys
        self._space[fresh] = space
        self._touch(slots)
        scores_t, preds_t = self._table_at[space]
        scores_t[slots] = scores
        preds_t[slots] = preds

    def _pushed_out(self, slots, new) -> int:
        """Stored keys of a round that fall out before their first row.

        ``slots`` are the round's keys' slots by first occurrence, ``new``
        which are not stored.  A stored key is out by its first row when as
        many distinct keys as the capacity were touched after it: the
        entries newer than it, plus the stored keys older than it touched
        earlier in the round, plus the new keys touched earlier in the
        round.  That can reach the capacity only for the ``q`` oldest.
        """
        cap, size = self.capacity_rows, self._size
        q = size - cap + len(slots) - 1
        if q <= 0:
            return 0
        age = np.full(size, q)
        oldest, _ = self._lru(min(q, size))
        age[oldest] = np.arange(len(oldest))
        pos = np.where(new, q, age[slots])
        old = np.flatnonzero(pos < q)
        if not len(old):
            return 0
        old = old[np.argsort(pos[old])]
        new_before = np.cumsum(new) - new
        touched = (size - 1 - pos[old]) + _earlier_smaller(old) + new_before[old]
        return int(np.count_nonzero(touched >= cap))

    # ------------------------------------------------------------ LRU order
    def _touch(self, slots, repeats: bool = False) -> None:
        """``slots`` become the most recent, in order (a repeat: its last)."""
        k = len(slots)
        self._reserve(k)
        at = self._arange[self._clock:self._clock + k]
        self._log[self._clock:self._clock + k] = slots
        if repeats:
            np.maximum.at(self._stamp, slots, at)
        else:
            self._stamp[slots] = at
        self._clock += k

    def _touch_one(self, slot: int) -> None:
        self._reserve(1)
        self._log[self._clock] = slot
        self._stamp[slot] = self._clock
        self._clock += 1

    def _lru(self, count):
        """The ``count`` least recently used slots, oldest first, and the
        log position past the last of them."""
        log, stamp, at, found = self._log, self._stamp, self._head, []
        head = log[at:at + count]
        if (stamp[head] == self._arange[at:at + count]).all():  # none went stale
            return head.copy(), at + count
        need = count
        while need:
            end = min(at + 2 * need + 64, self._clock)
            live = self._arange[at:end]
            live = live[stamp[log[at:end]] == live][:need]
            found.append(log[live])
            need -= len(live)
            at = int(live[-1]) + 1 if not need else end
        return (found[0] if len(found) == 1 else np.concatenate(found)), at

    def _drop(self, slots) -> None:
        """Take the entries at ``slots`` out of their namespaces' indexes."""
        spaces, keys = self._space[slots], self._row_key[slots]
        if (spaces == spaces[0]).all():  # one namespace, as a rule
            _consume(map(self._indexes[spaces[0]].__delitem__, keys))
        else:
            _consume(map(dict.__delitem__, map(self._indexes.__getitem__, spaces.tolist()),
                         keys))

    def _reserve(self, extra: int) -> None:
        """Room in the log for ``extra`` touches; when it is full, keep its
        live entries only, restamped 0, 1, ... in order."""
        if self._clock + extra <= len(self._log):
            return
        at = self._arange[self._head:self._clock]
        live = self._log[self._head:self._clock]
        live = live[self._stamp[live] == at]
        need = max(2 * (len(live) + extra), len(self._log))
        if need > len(self._log):
            self._log = np.empty(need, np.int64)
            self._arange = np.arange(need)
        self._log[:len(live)] = live
        self._stamp[live] = self._arange[:len(live)]
        self._head, self._clock = 0, len(live)

    # -------------------------------------------------------------- per row
    def get(self, key) -> Optional[Tuple[np.ndarray, int]]:
        rows, scores, preds = self.probe(key[:3], [key[3]])
        return (scores[0], int(preds[0])) if len(rows) else None

    def put(self, key, scores_row: np.ndarray, pred: int) -> None:
        self.fill(key[:3], [key[3]], np.asarray(scores_row)[None], np.asarray([pred]))

    def __len__(self) -> int:
        return self._size

    def stats(self) -> dict:
        probed = self.hits + self.misses
        return {
            "rows": self._size,
            "capacity_rows": self.capacity_rows,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hits / probed if probed else 0.0,
            "probes": self.probes,
        }
