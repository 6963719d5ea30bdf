"""The port's response cache, probed and filled a request at a time, against
the JAX package's cache driven a row at a time: a ``get`` a row in row order
at the probe and a ``put`` a missed row in row order at the fill.  Seeded
streams of requests with repeated rows inside a request, repeated requests,
fills of rows already stored (as concurrent requests make them) and a second
namespace (a version bump between probe and fill) must leave the same hits,
misses, evictions, length, LRU order and values, and every probe must return
the same rows."""
import numpy as np
import pytest

from repro.serve.cache import QuantizedKeyCache as JaxCache
from repro_torch.serve import QuantizedKeyCache, row_keys

CLASSES = 3


def _ref_probe(ref, ns, keys):
    out = [(i, ref.get(ref.key_for(*ns, k))) for i, k in enumerate(keys)]
    return [(i, hit) for i, hit in out if hit is not None]


def _ref_fill(ref, ns, keys, scores, preds):
    for k, s, p in zip(keys, scores, preds):
        ref.put(ref.key_for(*ns, k), s, p)


def _lru_keys(cache):
    """The port's stored keys as ``key_for`` gives them, least recently used
    first: its slots by their last touch."""
    namespace = {space: ns for ns, space in cache._space_of.items()}
    return [namespace[cache._space[slot]] + (cache._row_key[slot],)
            for slot in np.argsort(cache._stamp[:len(cache)]).tolist()]


def _same(cache, ref):
    assert (cache.hits, cache.misses, cache.evictions) == (ref.hits, ref.misses, ref.evictions)
    assert len(cache) == len(ref)
    assert _lru_keys(cache) == list(ref._od)  # the same keys survive, in the same LRU order


def _same_probe(got, want):
    rows, scores, preds = got
    assert rows.tolist() == [i for i, _ in want]
    if want:
        np.testing.assert_array_equal(scores, np.stack([s for _, (s, _) in want]))
        assert preds.tolist() == [p for _, (_, p) in want]
    else:
        assert scores is None and preds is None


def _stream(capacity, seed, steps=60):
    """Yield (probe ns, keys, fill ns, fill keys) steps over a small pool."""
    rng = np.random.default_rng(seed)
    pool = row_keys(rng.integers(-9, 9, size=(3 * capacity + 8, 4)).astype(np.float32))
    recent = []
    for step in range(steps):
        version = 1 + step // (steps // 2)  # a version bump halfway
        n = int(rng.integers(1, 2 * capacity + 4))
        if recent and rng.random() < 0.25:
            keys = recent[int(rng.integers(len(recent)))]  # a repeated request
        else:
            keys = [pool[i] for i in rng.integers(len(pool), size=n)]  # repeats inside
        recent.append(keys)
        probe_ns = ("m", version, "integer")
        fill_ns = ("m", version + (rng.random() < 0.15), "integer")  # swap mid-request
        yield probe_ns, keys, fill_ns
        if rng.random() < 0.3:  # a fill of stored rows, old ones included
            yield None, [pool[i] for i in rng.integers(len(pool), size=n)], probe_ns


@pytest.mark.parametrize("capacity", [1, 2, 7, 64, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_store_is_the_per_row_cache(capacity, seed):
    cache, ref = QuantizedKeyCache(capacity), JaxCache(capacity)
    for t, (probe_ns, keys, fill_ns) in enumerate(_stream(capacity, seed)):
        missed = keys
        if probe_ns is not None:
            want = _ref_probe(ref, probe_ns, keys)
            got = cache.probe(probe_ns, keys)
            _same_probe(got, want)
            hit = set(got[0].tolist())
            missed = [k for i, k in enumerate(keys) if i not in hit]
        # the step's own values, so a stale or first-of-two value shows
        scores = np.arange(len(missed) * CLASSES, dtype=np.float32).reshape(-1, CLASSES) + t
        preds = np.arange(len(missed), dtype=np.int32) % CLASSES
        _ref_fill(ref, fill_ns, missed, scores, preds)
        cache.fill(fill_ns, missed, scores, preds)
        _same(cache, ref)
    # every surviving value, in LRU order (the probes keep the two in step)
    for ns in {k[:3] for k in ref._od}:
        keys = [k[3] for k in ref._od if k[:3] == ns]
        _same_probe(cache.probe(ns, keys), _ref_probe(ref, ns, keys))
    _same(cache, ref)
    assert cache.stats()["probes"] > 0


def test_per_row_get_and_put_share_the_batch_store():
    c = QuantizedKeyCache(capacity_rows=3)
    ns = ("m", 1, "integer")
    c.fill(ns, [b"a", b"b"], np.array([[1.0], [2.0]], np.float32), np.array([0, 1]))
    assert c.get(c.key_for(*ns, b"b"))[1] == 1
    c.put(c.key_for(*ns, b"c"), np.array([3.0], np.float32), 0)
    rows, scores, preds = c.probe(ns, [b"c", b"x", b"a"])
    assert rows.tolist() == [0, 2] and scores[:, 0].tolist() == [3.0, 1.0]
    assert _lru_keys(c) == [c.key_for(*ns, k) for k in (b"b", b"c", b"a")]
    assert c.stats()["probes"] == 2 and (c.hits, c.misses) == (3, 1)


def test_capacity_zero_stores_nothing():
    c = QuantizedKeyCache(capacity_rows=0)
    ns = ("m", 1, "integer")
    c.fill(ns, [b"a"], np.ones((1, 2), np.float32), np.zeros(1))
    rows, scores, _ = c.probe(ns, [b"a"])
    assert not len(rows) and scores is None and len(c) == 0 and c.misses == 1


def test_swapped_out_versions_leave_no_bookkeeping():
    """Once LRU has evicted a version's rows, a new version may take its id;
    versions with rows left keep theirs, so no probe sees another's rows."""
    rng = np.random.default_rng(0)
    c, ref = QuantizedKeyCache(capacity_rows=4), JaxCache(4)
    for version in range(300):
        ns = ("m", version, "integer")
        keys = [bytes([i]) for i in rng.integers(3, size=int(rng.integers(1, 4)))]
        scores = np.full((len(keys), CLASSES), version, np.float32)
        preds = np.arange(len(keys), dtype=np.int32)
        c.fill(ns, keys, scores, preds)
        _ref_fill(ref, ns, keys, scores, preds)
        old = ("m", int(rng.integers(max(version - 4, 0), version + 1)), "integer")
        _same_probe(c.probe(old, [b"\0", b"\1", b"\2"]),
                    _ref_probe(ref, old, [b"\0", b"\1", b"\2"]))
        _same(c, ref)
        assert len(c._space_of) <= 5 and len(c._indexes) <= 5
