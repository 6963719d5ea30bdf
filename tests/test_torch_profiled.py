"""The serving path's stages as ``torch.profiler`` ranges
(``repro_torch.obs.profiled``), on the CPU: a ``TreeEngine`` on the card's two
backends (their plain versions with ``device="cpu"``) and a ``Gateway`` each
emit their named ranges while a profiler records, the ranges nest on every
thread, and with no profiler recording no range is entered at all; the
``stage`` helper times a block into a stage sample, a span and a range."""
import asyncio
import json

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast

from repro_torch.ir import ForestIR
from repro_torch.obs import NULL_SPAN, Tracer, profiled, stage
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import Gateway, ModelRegistry, TreeEngine
from repro_torch.trees.forest import RandomForestClassifier

ENGINE_RANGES = ("engine.pad", "plan.shard", "backend.rows_in", "backend.keys",
                 "backend.launch", "backend.rows_out", "plan.finalize")
BACKEND_RANGES = ENGINE_RANGES[2:6]
LOOP_RANGES = ("gateway.cache_probe", "gateway.stitch", "batcher.assemble", "batcher.scatter")
GATEWAY_RANGES = LOOP_RANGES + ("gateway.batch", "gateway.record")


@pytest.fixture(scope="module")
def forest():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
    return RandomForestClassifier(n_estimators=4, max_depth=4, seed=3).fit(X, y), X


def ranges(prof, tmp_path) -> list:
    """(name, thread, start_us, end_us) of every range of the program in
    ``prof``'s Chrome trace, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    prefixes = ("gateway.", "batcher.", "engine.", "plan.", "backend.")
    out = [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")
           and e["name"].startswith(prefixes)]
    return sorted(out, key=lambda r: r[2])


def recording(all_threads: bool = False):
    cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads else None
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=cfg)


def test_off_the_helper_hands_out_the_null_span():
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert profiled("plan.shard") is NULL_SPAN
    with profiled("plan.shard") as s:
        assert s is NULL_SPAN


def test_on_the_helper_opens_a_record_function_range(tmp_path):
    with recording() as prof:
        rng = profiled("engine.pad")
        assert isinstance(rng, _RecordFunctionFast)
        with rng:
            pass
    assert profiled("engine.pad") is NULL_SPAN
    assert [r[0] for r in ranges(prof, tmp_path)] == ["engine.pad"]


@pytest.mark.parametrize("route", ["integer:cuda", "integer:bitvector"])
def test_engine_emits_its_stages_nested(forest, route, tmp_path):
    rf, X = forest
    eng = TreeEngine(ForestIR.from_forest(rf), spec=route, device="cpu")
    want = eng.predict_scores(X[:37])
    with recording() as prof:
        got = eng.predict_scores(X[:37])
    np.testing.assert_array_equal(got[0], want[0])
    rs = ranges(prof, tmp_path)
    assert [r[0] for r in rs] == list(ENGINE_RANGES)
    (shard,) = [r for r in rs if r[0] == "plan.shard"]
    for name, _, t0, t1 in rs:
        if name in BACKEND_RANGES:
            assert shard[2] <= t0 and t1 <= shard[3], name
    assert len({r[1] for r in rs}) == 1


def _serve(rf, X, **gw_kw):
    reg = ModelRegistry()
    reg.register_forest("m", rf)
    gw = Gateway(reg, "integer:cuda", device="cpu", max_batch_rows=64, max_delay_ms=1.0,
                 **gw_kw)

    async def run():
        await asyncio.gather(*[gw.submit("m", X[a:a + 7]) for a in range(0, 70, 7)])
        await gw.submit("m", X[:14])  # every row a cache hit
        await gw.close()

    asyncio.run(run())
    return gw


def test_gateway_emits_every_stage_and_ranges_nest_per_thread(forest, tmp_path):
    rf, X = forest
    with recording(all_threads=True) as prof:
        gw = _serve(rf, X)
    rs = ranges(prof, tmp_path)
    names = {r[0] for r in rs}
    assert names >= set(GATEWAY_RANGES) | set(ENGINE_RANGES)
    # the event loop's ranges and the batch thread's are on two threads
    loop = {r[1] for r in rs if r[0].startswith(("gateway.cache", "gateway.stitch", "batcher."))}
    batch = {r[1] for r in rs if r[0] in ("gateway.batch", "gateway.record")}
    assert len(loop) == 1 and not loop & batch
    # on each thread two ranges are nested or apart, never half over each other
    for tid in {r[1] for r in rs}:
        mine = [r for r in rs if r[1] == tid]
        for i, (a, _, a0, a1) in enumerate(mine):
            for b, _, b0, b1 in mine[i + 1:]:
                assert b0 >= a1 or b1 <= a1, (a, b)
    # 11 requests: 11 probes and 11 stitches, the all-hit one's included
    assert sum(r[0] == "gateway.cache_probe" for r in rs) == 11
    assert sum(r[0] == "gateway.stitch" for r in rs) == 11
    assert gw.stats()["per_model"]["m"]["stages"]["stitch"]["count"] == 11


def test_all_hit_request_is_timed_as_a_stitch(forest, tmp_path):
    rf, X = forest
    reg = ModelRegistry()
    reg.register_forest("m", rf)
    gw = Gateway(reg, "integer:cuda", device="cpu", max_batch_rows=64)

    async def run():
        first = await gw.submit("m", X[:5])
        with recording() as prof:
            hit = await gw.submit("m", X[:5])
        await gw.close()
        return first, hit, prof

    first, hit, prof = asyncio.run(run())
    np.testing.assert_array_equal(first[0], hit[0])
    per_model = gw.stats()["per_model"]["m"]
    assert per_model["hit_requests"] == 1
    assert per_model["stages"]["stitch"]["count"] == 2
    assert [r[0] for r in ranges(prof, tmp_path)] == ["gateway.cache_probe", "gateway.stitch"]


def test_a_profiler_of_one_thread_gets_the_event_loops_ranges_alone(forest, tmp_path):
    # the harness's profiler records the thread that starts it: here the
    # event loop's, while the batch thread's ranges stay out of the trace
    rf, X = forest
    with recording() as prof:
        _serve(rf, X)
    assert {r[0] for r in ranges(prof, tmp_path)} == set(LOOP_RANGES)


class _Samples:
    def __init__(self):
        self.got = []

    def __call__(self, key, ms):
        self.got.append((key, ms))


def test_stage_times_the_block_into_a_sample_a_span_and_a_range(tmp_path):
    tracer, record = Tracer(), _Samples()
    root = tracer.request_span("request")
    with recording() as prof:
        with stage("plan.finalize", record, "finalize", tracer, root, rows=3) as st:
            st.attrs["padded"] = 8
        with stage("gateway.cache_probe", record, "cache", tracer, root, "cache_probe"):
            pass
    root.end()
    assert [k for k, _ in record.got] == ["finalize", "cache"]
    assert all(ms >= 0 for _, ms in record.got)
    spans = {s.name: s for s in tracer.spans() if s.name != "request"}
    assert set(spans) == {"finalize", "cache_probe"}
    assert spans["finalize"].attrs == {"rows": 3, "padded": 8}
    assert spans["finalize"].parent_id == root.span_id
    assert [r[0] for r in ranges(prof, tmp_path)] == ["plan.finalize", "gateway.cache_probe"]


@pytest.mark.parametrize("parent", ["null", "raised"])
def test_stage_commits_no_span_without_a_live_parent_and_nothing_on_a_raise(parent):
    tracer, record = Tracer(), _Samples()
    if parent == "null":
        with stage("plan.shard", record, "s0", tracer, NULL_SPAN, "shard:s0"):
            pass
        assert [k for k, _ in record.got] == ["s0"]
    else:
        root = tracer.request_span("request")
        with pytest.raises(ValueError):
            with stage("plan.shard", record, "s0", tracer, root, "shard:s0"):
                raise ValueError("shard failed")
        root.end()
        assert record.got == []
    assert [s.name for s in tracer.spans() if s.name != "request"] == []


def test_no_range_is_entered_without_a_profiler(forest, monkeypatch):
    rf, X = forest

    def refused(name):
        raise AssertionError(f"range {name!r} entered with no profiler")

    monkeypatch.setattr(obs_trace, "_RecordFunctionFast", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    for route in ("integer:cuda", "integer:bitvector"):
        TreeEngine(ForestIR.from_forest(rf), spec=route, device="cpu").predict_scores(X[:9])
    gw = _serve(rf, X)
    assert gw.stats()["per_model"]["m"]["requests"] == 11
