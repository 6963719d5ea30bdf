"""The port's serving gateway on the CPU against the JAX package's, tolerance
0: cache → micro-batcher → registry → engine → plan → backend → stitch.

Each route pair serves the same seeded request sequence through a port
``Gateway(device="cpu")`` and a JAX ``Gateway`` — ``integer:reference``,
``flint:reference``, ``integer:cuda`` against ``integer:pallas`` and
``integer:cuda@padded?impl=onehot`` against ``integer:pallas@padded?
impl=onehot`` (the JAX kernels in interpret mode) — across a hot swap and a
drain-close.  Responses, cache hit and miss counts and batch counts must be
equal.  The rest holds the cache, the batcher, the registry and the gateway's
own checks, as the JAX package's gateway tests do."""
import asyncio

import numpy as np
import pytest

from repro.serve.gateway import Gateway as JGateway
from repro.serve.registry import ModelRegistry as JModelRegistry
from repro.trees.forest import RandomForestClassifier as JForest
from repro_torch.serve import (AdmissionError, EngineSpec, Gateway, MicroBatcher,
                               ModelRegistry, QuantizedKeyCache, row_keys)
from repro_torch.trees.forest import RandomForestClassifier
from repro_torch.trees.io import forest_to_json

ROUTES = [
    ("integer:reference", "integer:reference"),
    ("flint:reference", "flint:reference"),
    ("integer:cuda", "integer:pallas"),
    ("integer:cuda@padded?impl=onehot", "integer:pallas@padded?impl=onehot"),
]


@pytest.fixture(scope="module")
def data():
    """(rows, labels, forest v1, forest v2): JAX-trained forests, which the
    port's registry quantizes through its own ForestIR."""
    rng = np.random.default_rng(17)
    X = rng.normal(size=(900, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.4).astype(int) + (X[:, 2] > 1.0)
    v1 = JForest(n_estimators=5, max_depth=5, seed=1).fit(X, y)
    v2 = JForest(n_estimators=3, max_depth=4, seed=2).fit(X[:400], y[:400])
    return X, y, v1, v2


def _serve(gateway_cls, registry_cls, route, data, **kw):
    """Serve a fixed sequence: concurrent first requests, repeats (cache
    hits), a hot swap, then requests on v2; close drains the last batch."""
    X, _, v1, v2 = data
    reg = registry_cls()
    reg.register_forest("m", v1)
    gw = gateway_cls(reg, route, max_batch_rows=32, max_delay_ms=1.0, **kw)

    async def run():
        outs = list(await asyncio.gather(
            *[gw.submit("m", X[a:b]) for a, b in ((0, 1), (1, 4), (4, 11), (11, 30))]))
        outs.append(await gw.submit("m", X[:30]))  # every row a cache hit
        outs.append(await gw.submit("m", X[25:40]))  # 5 hits, 10 misses
        reg.register_forest("m", v2)  # hot swap under the gateway
        outs.append(await gw.submit("m", X[:12]))  # v1 entries must not leak
        tail = asyncio.ensure_future(gw.submit("m", X[60:70]))
        await asyncio.sleep(0)
        await gw.close()  # drains the request still queued
        outs.append(await tail)
        return outs

    outs = asyncio.run(run())
    st = gw.stats()
    return outs, st["cache"], st["per_model"]["m"], reg


@pytest.mark.parametrize("route,ref_route", ROUTES)
def test_gateway_matches_the_jax_gateway(data, route, ref_route):
    outs, cache, per_model, reg = _serve(Gateway, ModelRegistry, route, data, device="cpu")
    jouts, jcache, jper_model, _ = _serve(JGateway, JModelRegistry, ref_route, data)
    assert len(outs) == len(jouts) == 8
    for (s, p), (js, jp) in zip(outs, jouts, strict=True):
        assert s.dtype == np.asarray(js).dtype
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(p, np.asarray(jp))
    for key in ("hits", "misses", "rows", "evictions"):
        assert cache[key] == jcache[key], key
    for key in ("requests", "hit_requests", "rows", "batches", "cache_hits", "rejected"):
        assert per_model[key] == jper_model[key], key
    assert cache["hits"] == 30 + 5
    # the last two responses came from v2: equal to a direct v2 engine
    X = data[0]
    direct = reg.get("m").engine(route, device="cpu")
    assert reg.version("m") == 2
    np.testing.assert_array_equal(outs[6][0], direct.predict_scores(X[:12])[0])
    np.testing.assert_array_equal(outs[7][0], direct.predict_scores(X[60:70])[0])
    assert not np.array_equal(outs[6][0], outs[4][0][:12])


@pytest.fixture(scope="module")
def two_class_forest(data):
    """A JAX forest of two classes, where ``data``'s forests have four."""
    X = data[0]
    return JForest(n_estimators=3, max_depth=4, seed=3).fit(X[:400], (X[:400, 0] > 0).astype(int))


def _serve_tiny_cache(gateway_cls, registry_cls, route, data, v2, **kw):
    """An 8-row cache under 20-row requests: repeated rows inside a request,
    concurrent requests that fill the same rows, then a hot swap to a forest
    of another class count while a request with cached rows is queued (its
    whole request is recomputed on the new version), and requests after."""
    X, _, v1, _ = data
    reg = registry_cls()
    reg.register_forest("m", v1)
    gw = gateway_cls(reg, route, max_batch_rows=32, max_delay_ms=1.0, cache_rows=8, **kw)
    rng = np.random.default_rng(5)
    reqs = [X[rng.integers(0, 30, size=20)] for _ in range(6)]

    async def run():
        outs = list(await asyncio.gather(*[gw.submit("m", r) for r in reqs[:3]]))
        for r in reqs[3:] + reqs[:2]:
            outs.append(await gw.submit("m", r))
        outs.append(await gw.submit("m", reqs[5][:6]))  # 6 rows, all stored after
        tail = asyncio.ensure_future(gw.submit("m", reqs[5]))  # probes v1: hits
        await asyncio.sleep(0)
        reg.register_forest("m", v2)  # ... and is served by v2
        outs.append(await tail)
        outs += list(await asyncio.gather(*[gw.submit("m", r) for r in reqs[:2]]))
        await gw.close()
        return outs

    outs = asyncio.run(run())
    st = gw.stats()
    return outs, reqs, st["cache"], st["per_model"]["m"]


@pytest.mark.parametrize("route,ref_route", [ROUTES[0], ROUTES[2]])
def test_tiny_cache_repeats_and_a_class_count_swap_match_the_jax_gateway(
        data, two_class_forest, route, ref_route):
    outs, reqs, cache, per_model = _serve_tiny_cache(
        Gateway, ModelRegistry, route, data, two_class_forest, device="cpu")
    jouts, _, jcache, jper_model = _serve_tiny_cache(
        JGateway, JModelRegistry, ref_route, data, two_class_forest)
    assert len(outs) == len(jouts) == 12
    for (s, p), (js, jp) in zip(outs, jouts, strict=True):
        assert s.dtype == np.asarray(js).dtype
        np.testing.assert_array_equal(s, np.asarray(js))
        np.testing.assert_array_equal(p, np.asarray(jp))
    for key in ("hits", "misses", "rows", "evictions"):
        assert cache[key] == jcache[key], key
    for key in ("requests", "hit_requests", "rows", "batches", "cache_hits", "rejected"):
        assert per_model[key] == jper_model[key], key
    assert cache["rows"] == 8 and cache["evictions"] > 0 and cache["hits"] > 0
    assert any(len(np.unique(r, axis=0)) < len(r) for r in reqs)
    # each answer equals a direct engine of the version that served it
    direct = ModelRegistry()
    v1 = direct.register_forest("v1", data[2]).engine(route, device="cpu")
    v2 = direct.register_forest("v2", two_class_forest).engine(route, device="cpu")
    served = reqs[:3] + reqs[3:] + reqs[:2] + [reqs[5][:6]]
    for (s, p), X in zip(outs[:9], served, strict=True):
        np.testing.assert_array_equal(s, v1.predict_scores(X)[0])
        np.testing.assert_array_equal(p, v1.predict_scores(X)[1])
    for (s, p), X in zip(outs[9:], [reqs[5]] + reqs[:2], strict=True):
        assert s.shape == (20, 2)
        np.testing.assert_array_equal(s, v2.predict_scores(X)[0])
        np.testing.assert_array_equal(p, v2.predict_scores(X)[1])


def test_gateway_probes_the_cache_once_a_request(data):
    X, _, v1, _ = data
    reg = ModelRegistry()
    reg.register_forest("m", v1)
    gw = Gateway(reg, "integer:cuda", max_delay_ms=1.0, device="cpu")
    off = Gateway(reg, "float:reference", max_delay_ms=1.0, device="cpu")

    async def run():
        for g in (gw, off):
            for a, b in ((0, 1), (0, 20), (0, 20), (10, 40)):  # one all-hit request
                await g.submit("m", X[a:b])
            await g.close()

    asyncio.run(run())
    st = gw.cache.stats()
    assert st["probes"] == 4 and (st["hits"] + st["misses"]) / st["probes"] == 71 / 4
    assert gw.stats()["per_model"]["m"]["hit_requests"] == 1
    assert off.cache.capacity_rows == 0 and off.cache.stats()["probes"] == 0


def test_gateway_stats_and_table(data):
    outs, _, per_model, _ = _serve(Gateway, ModelRegistry, "integer:cuda", data, device="cpu")
    assert per_model["spec"] == "integer:cuda" and per_model["tuned"] == "-"
    assert set(per_model["stages"]) >= {"cache", "queue", "pad", "shard", "finalize", "stitch"}
    assert per_model["cache_hit_rate"] > 0 and per_model["batch_occupancy"] >= 1.0
    assert "s0:cuda" in per_model["shards"]


# ------------------------------------------------------------------- cache

def test_cache_lru_and_counters():
    c = QuantizedKeyCache(capacity_rows=2)
    k = lambda i: c.key_for("m", 1, "integer", bytes([i]))
    assert c.get(k(0)) is None and c.misses == 1
    c.put(k(0), np.array([1, 2]), 0)
    c.put(k(1), np.array([3, 4]), 1)
    assert c.get(k(0))[1] == 0 and c.hits == 1
    c.put(k(2), np.array([5, 6]), 1)  # evicts k(1), the LRU entry
    assert len(c) == 2 and c.evictions == 1
    assert c.get(k(1)) is None
    assert c.stats()["hit_rate"] == pytest.approx(1 / 3)


def test_row_keys_match_the_jax_package():
    from repro.serve.cache import row_keys as jrow_keys

    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 7)).astype(np.float32)
    X[0, :3] = [0.0, -0.0, np.inf]
    X[1, :2] = [np.nan, -np.inf]
    X[2] = X[3]
    keys = row_keys(X)
    assert keys == jrow_keys(X)
    assert keys[2] == keys[3] and keys[0] != keys[1]


# ---------------------------------------------------------------- batcher

def _fake_execute(model_id, X):
    return X.sum(axis=1, keepdims=True), np.zeros(len(X), np.int32), len(X), None


def test_micro_batcher_coalesces_and_scatters():
    batches = []

    def execute(model_id, X):
        batches.append(len(X))
        return _fake_execute(model_id, X)

    mb = MicroBatcher(execute, max_batch_rows=16, max_delay_ms=20.0)
    X = np.arange(30, dtype=np.float32).reshape(10, 3)

    async def run():
        outs = await asyncio.gather(*[mb.submit("m", X[i:i + 2]) for i in range(0, 10, 2)])
        await mb.close()
        return outs

    outs = asyncio.run(run())
    for i, (s, _, meta) in enumerate(outs):
        np.testing.assert_array_equal(s[:, 0], X[2 * i:2 * i + 2].sum(axis=1))
        assert meta is None
    assert sum(batches) == 10 and len(batches) < 5


def test_micro_batcher_admission_and_close():
    mb = MicroBatcher(_fake_execute, max_batch_rows=4, max_delay_ms=50.0,
                      max_queue_rows=6)

    async def run():
        first = asyncio.ensure_future(mb.submit("m", np.ones((5, 2), np.float32)))
        await asyncio.sleep(0)
        with pytest.raises(AdmissionError):
            await mb.submit("m", np.ones((3, 2), np.float32))
        await mb.close()
        s, _, _ = await first
        with pytest.raises(RuntimeError, match="closed"):
            await mb.submit("m", np.ones((1, 2), np.float32))
        return s

    np.testing.assert_array_equal(asyncio.run(run())[:, 0], np.full(5, 2.0))


# --------------------------------------------------------------- registry

def test_registry_versions_retention_and_release(data):
    X, y, v1, v2 = data
    reg = ModelRegistry(retain=2)
    mv1 = reg.register_forest("m", v1)
    eng1 = mv1.engine("integer:cuda", device="cpu")
    assert mv1.engine("integer:cuda@leaf_major", device="cpu") is eng1  # resolved layout
    assert mv1.engine("integer:cuda?autotune=true", device="cpu") is not eng1
    # a kernel knob is part of the route: K3 and K2 on one layout never alias
    k3 = mv1.engine("integer:cuda@padded?impl=onehot", device="cpu")
    k2 = mv1.engine("integer:cuda@padded?impl=gather", device="cpu")
    assert k3 is not k2 and (k3.backend.impl, k2.backend.impl) == ("onehot", "gather")
    # the route is a spec and nothing else
    with pytest.raises(TypeError):
        mv1.engine(mode="integer", backend="cuda", device="cpu")
    with pytest.raises(TypeError):
        Gateway(reg, backend="cuda", device="cpu")
    mv2 = reg.register_forest("m", v2)
    assert reg.version("m") == 2 and reg.ids() == ["m"]
    with pytest.raises(ValueError, match="current version"):
        reg.release("m", 2)
    reg.register_forest("m", v1)  # v3: retention releases v1
    assert mv1.released and eng1.closed
    with pytest.raises(RuntimeError, match="released"):
        mv1.engine("integer:cuda", device="cpu")
    reg.release("m", 2)
    assert mv2.released
    with pytest.raises(KeyError):
        reg.release("m", 2)
    d = reg.describe()["m"]
    assert d["version"] == 3 and d["n_features"] == X.shape[1]
    with pytest.raises(KeyError, match="unknown model"):
        reg.get("nope")


def test_registry_json_and_packed_paths_bit_identical(data, tmp_path):
    """The JSON, packed and ITRF artifact boundaries serve the forest's
    bits; ``export_tuned`` with nothing tuned leaves the file as it was."""
    from repro_torch.ir import ForestIR

    X, y, _, _ = data
    rf = RandomForestClassifier(n_estimators=4, max_depth=5, seed=3).fit(X, y)
    reg = ModelRegistry()
    a = reg.register_forest("forest", rf)
    b = reg.register_json("json", forest_to_json(rf))
    c = reg.register_packed("packed", a.packed)
    path = tmp_path / "forest.itrf"
    ForestIR.from_forest(rf).to_itrf(str(path))
    d = reg.register_artifact("artifact", str(path))
    assert (a.source, b.source, c.source, d.source) == ("forest", "json", "packed",
                                                        "artifact")
    ref = a.engine("integer:cuda", device="cpu").predict_scores(X[:40])
    for mv in (b, c, d):
        out = mv.engine("integer:cuda", device="cpu").predict_scores(X[:40])
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
    before = path.read_bytes()
    reg.export_tuned("artifact", str(path))
    assert path.read_bytes() == before
    with pytest.raises(FileNotFoundError):
        reg.register_artifact("m", str(tmp_path / "missing.itrf"))


# ---------------------------------------------------------------- gateway

def test_gateway_survives_event_loop_reuse(data):
    X, _, v1, _ = data
    reg = ModelRegistry()
    reg.register_forest("m", v1)
    gw = Gateway(reg, "integer:cuda", max_delay_ms=1.0, device="cpu")
    s1, _ = asyncio.run(gw.submit("m", X[:4]))
    s2, _ = asyncio.run(gw.submit("m", X[4:8]))  # fresh loop, cache-cold rows
    direct = reg.get("m").engine("integer:cuda", device="cpu")
    np.testing.assert_array_equal(s1, direct.predict_scores(X[:4])[0])
    np.testing.assert_array_equal(s2, direct.predict_scores(X[4:8])[0])


def test_gateway_float_mode_disables_cache(data):
    X, _, v1, _ = data
    reg = ModelRegistry()
    reg.register_forest("m", v1)
    gw = Gateway(reg, "float:reference", device="cpu")
    assert gw.cache.capacity_rows == 0

    async def run():
        a = await gw.submit("m", X[:5])
        b = await gw.submit("m", X[:5])
        await gw.close()
        return a, b

    (s1, _), (s2, _) = asyncio.run(run())
    np.testing.assert_array_equal(s1, s2)
    assert gw.cache.hits == 0


def test_gateway_rejects_bad_routes_and_rows(data):
    X, _, v1, _ = data
    reg = ModelRegistry()
    reg.register_forest("m", v1)
    with pytest.raises(ValueError, match="unknown plan"):
        Gateway(reg, "integer:cuda+unknown_plan:2", device="cpu")
    with pytest.raises(ValueError, match="partials"):  # shards=2 picks tree_parallel
        Gateway(reg, EngineSpec(mode="float", backend="reference", shards=2,
                                plan="tree_parallel"), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        Gateway(reg, "float:cuda", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        Gateway(reg, "integer:cuda@ragged", device="cpu")
    gw = Gateway(reg, "integer:cuda", device="cpu")

    async def run():
        with pytest.raises(ValueError, match="empty"):
            await gw.submit("m", np.zeros((0, 6), np.float32))
        with pytest.raises(ValueError, match="fewer columns"):
            await gw.submit("m", X[:3, :5])
        await gw.close()

    asyncio.run(run())
