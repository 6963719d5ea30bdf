"""The port's observability layer against the JAX package's, tolerance 0:
``LogHistogram`` bucket counts and percentiles, the tracer's sampling
decisions, the span tree of one traced gateway request (names, parenting and
attributes), and the Prometheus / JSON / JSONL exports of the same data."""
import asyncio
import math

import numpy as np
import pytest

from repro.obs import LogHistogram as JLogHistogram
from repro.obs import Tracer as JTracer
from repro.obs import export as jexport
from repro.serve.gateway import Gateway as JGateway
from repro.serve.registry import ModelRegistry as JModelRegistry
from repro.trees.forest import RandomForestClassifier
from repro_torch.obs import NULL_SPAN, NULL_TRACER, LogHistogram, Tracer, export
from repro_torch.serve import Gateway, ModelRegistry


@pytest.fixture(scope="module")
def forest():
    rng = np.random.default_rng(21)
    X = rng.normal(size=(700, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
    return RandomForestClassifier(n_estimators=4, max_depth=4, seed=2).fit(X, y), X


def _pair(values, **grid):
    h, jh = LogHistogram(**grid), JLogHistogram(**grid)
    for v in values:
        h.record(v)
        jh.record(v)
    return h, jh


@pytest.mark.parametrize("grid", [{}, dict(lo=1e-2, hi=1e3, sub=4), dict(lo=0.5, hi=64.0, sub=1)])
def test_histogram_counts_and_percentiles_match(grid):
    rng = np.random.default_rng(len(grid))
    values = np.concatenate([rng.lognormal(0.0, 2.0, 2000), [0.0, -1.0, 1e9, 1e-7]])
    h, jh = _pair(values, **grid)
    assert h.counts == jh.counts
    assert (h.count, h.total, h.vmin, h.vmax) == (jh.count, jh.total, jh.vmin, jh.vmax)
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert h.percentile(q) == jh.percentile(q)
    assert h.snapshot() == jh.snapshot()
    other, jother = _pair(rng.exponential(3.0, 500), **grid)
    assert h.merge(other).counts == jh.merge(jother).counts
    assert h.snapshot() == jh.snapshot()


def test_histogram_empty_and_grid_checks():
    h = LogHistogram()
    assert math.isnan(h.percentile(50)) and math.isnan(JLogHistogram().percentile(50))
    with pytest.raises(ValueError, match="different grids"):
        h.merge(LogHistogram(sub=4))
    with pytest.raises(ValueError):
        LogHistogram(lo=2.0, hi=1.0)


@pytest.mark.parametrize("sample", [1.0, 0.25, 0.4, 0.0])
def test_tracer_samples_the_same_requests(sample):
    t, jt = Tracer(sample=sample), JTracer(sample=sample)
    picks = [bool(t.request_span("r")) for _ in range(40)]
    assert picks == [bool(jt.request_span("r")) for _ in range(40)]
    assert t.started == jt.started
    assert not NULL_SPAN and NULL_SPAN.child("x") is NULL_SPAN
    assert not NULL_TRACER.request_span("r")


def _shape(tree):
    """A span tree without ids and times: (name, attrs, children)."""
    return (tree["name"], tree["attrs"], [_shape(c) for c in tree["children"]])


def _traced(gateway_cls, registry_cls, forest, X, **kw):
    reg = registry_cls()
    reg.register_forest("m", forest)
    tracer = (Tracer if gateway_cls is Gateway else JTracer)()
    gw = gateway_cls(reg, "integer:reference", tracer=tracer, max_batch_rows=64, **kw)

    async def run():
        await gw.submit("m", X[:9])
        await gw.submit("m", np.concatenate([X[:4], X[20:23]]))  # 4 of 7 rows cached
        await gw.close()

    asyncio.run(run())
    return gw, tracer.spans()


def test_gateway_span_trees_match(forest):
    rf, X = forest
    gw, spans = _traced(Gateway, ModelRegistry, rf, X, device="cpu")
    jgw, jspans = _traced(JGateway, JModelRegistry, rf, X)
    trees = [_shape(t) for t in export.request_trees(spans)]
    jtrees = [_shape(t) for t in jexport.request_trees(jspans)]
    assert len(trees) == 2 and trees == jtrees
    names = [c[0] for c in trees[0][2]]
    assert names == ["cache_probe", "queue", "batch", "stitch"]
    assert [c[0] for c in trees[0][2][2][2]] == ["pad", "shard:s0:reference", "finalize"]
    # the renderers of either package read the other's spans alike
    assert export.render_flame(spans) == jexport.render_flame(spans)
    assert export.render_flame(jspans) == jexport.render_flame(jspans)


def test_prometheus_and_json_exports_match(forest, tmp_path):
    rf, X = forest
    gw, spans = _traced(Gateway, ModelRegistry, rf, X, device="cpu")
    stats = gw.stats()["per_model"]
    assert export.render_prometheus(stats) == jexport.render_prometheus(stats)
    assert export.render_prometheus(stats, namespace="port") == \
        jexport.render_prometheus(stats, namespace="port")
    assert export.snapshot_json(stats, device="cpu") == jexport.snapshot_json(stats, device="cpu")
    assert export.spans_to_jsonl(spans) == jexport.spans_to_jsonl(spans)
    assert export.write_jsonl(spans, tmp_path / "t.jsonl") == len(spans)
    assert (tmp_path / "t.jsonl").read_text().rstrip("\n") == jexport.spans_to_jsonl(spans)
