"""The port's shard-worker fabric against the JAX package's, bit for bit.

The cases of ``tests/test_remote.py``, run through ``repro_torch`` with
workers started with ``--device cpu`` (the kernels' plain versions) and held
against the single-process walk, tolerance 0: wire frames round trip and
are the JAX package's bytes, bad magic is refused; two workers merge to the
single plan's bits and float mode is refused; a killed worker and a
straggler past its deadline are re-dispatched; heterogeneous backends per
shard (``cuda|bitvector|reference``, and host-C shards beside them); ``close`` reaps owned workers; the
gateway end to end with worker spans grafted under the shard spans, and
draining on close; span JSONL with the worker's kernel launches; the HELLO
fast path (an ITRF image) next to the array HELLO; a worker started on a
card its host lacks failing each attempt with an error naming the device;
and the two cross-package directions: a port gateway merging JAX workers'
partials, and a JAX plan merging port workers' partials, C shards
included.

Every fixture that spawns workers kills them in its finalizer, and every
plan takes a short connect timeout and deadline, so no test can hang.
"""
import asyncio
import json
import socket
import threading
import time

import numpy as np
import pytest

from repro.ir import ForestIR as JForestIR
from repro.serve import wire as jwire
from repro.serve.engine import TreeEngine as JTreeEngine
from repro_torch.ir import ForestIR
from repro_torch.serve import EngineSpec, Gateway, ModelRegistry, TreeEngine, wire
from repro_torch.serve.worker import spawn_local_workers

#: the short limits every remote plan here takes: a worker loads torch (a
#: JAX worker jax) before its first HELLO_ACK, a few seconds on a busy host
LIMITS = {"connect_timeout_s": 20.0, "deadline_ms": 20000.0}


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        if p.stdout is not None:
            p.stdout.close()


@pytest.fixture(scope="module")
def worker_pair():
    """Two loopback port workers on the CPU, shared by the happy paths."""
    procs, addrs = spawn_local_workers(2, device="cpu")
    yield addrs
    _kill_all(procs)


@pytest.fixture(scope="module")
def jax_worker_pair():
    """Two loopback workers of the JAX package."""
    from repro.serve.worker import spawn_local_workers as jspawn

    procs, addrs = jspawn(2)
    yield addrs
    _kill_all(procs)


@pytest.fixture(scope="module")
def irs(small_forest):
    return ForestIR.from_forest(small_forest), JForestIR.from_forest(small_forest)


@pytest.fixture(scope="module")
def X(shuttle_small):
    return shuttle_small[2][:96].astype(np.float32)


@pytest.fixture(scope="module")
def single(irs, X):
    """The single-process walk's (scores, preds) per mode."""
    return {mode: _scores(TreeEngine(irs[0], f"{mode}:reference", device="cpu"), X)
            for mode in ("flint", "integer")}


def _scores(eng, rows):
    s, p = eng.predict_scores(rows)
    return np.asarray(s), np.asarray(p)


def _assert_same(got, want, label=""):
    np.testing.assert_array_equal(got[0], want[0], err_msg=label)
    np.testing.assert_array_equal(got[1], want[1], err_msg=label)


@pytest.fixture()
def remote_engine(irs, worker_pair):
    """Factory: an engine on the remote plan against the shared pair."""
    made = []

    def make(spec, model=None, **plan_kwargs):
        eng = TreeEngine(irs[0] if model is None else model, spec, device="cpu",
                         plan_kwargs={"workers": list(worker_pair), "model_id": "t",
                                      "version": 1, **LIMITS, **plan_kwargs})
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def test_wire_partials_roundtrip():
    acc = np.arange(4 * 7, dtype=np.uint32).reshape(4, 7) * np.uint32(2654435761)
    payload = wire.encode_partials(9, 3, acc, spans=[("predict", 100, 2500)])
    rid, sid, out, spans = wire.decode_partials(payload)
    assert (rid, sid) == (9, 3)
    assert out.dtype == np.uint32 and np.array_equal(out, acc)
    assert spans == [("predict", 100, 2500)]
    assert out.flags.writeable


def test_wire_pack_arrays_roundtrip():
    arrays = {
        "feature": np.array([0, -1, 2], np.int32),
        "threshold": np.array([0.5, 1.5], np.float32),
        "leaf_fixed": np.array([[1, 2], [3, 4]], np.uint32),
        "offsets": np.array([0, 3], np.int64),
    }
    payload = wire.pack_arrays({"model": "m", "version": 3}, arrays)
    meta, out = wire.unpack_arrays(payload)
    assert meta == {"model": "m", "version": 3}
    for name, a in arrays.items():
        assert out[name].dtype == a.dtype
        assert np.array_equal(out[name], a)


def test_wire_frames_are_the_jax_packages_bytes():
    """Every payload the port encodes is the JAX package's, byte for byte,
    and each package decodes the other's; the frame header is too."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(5, 7)).astype(np.float32)
    acc = rng.integers(0, 2**32, (5, 3), dtype=np.uint64).astype(np.uint32)
    meta = {"wire": 1, "model_id": "m", "version": 2, "shards": [{"shard": 0}]}
    arrays = {"feature": np.array([1, -1, -1], np.int32),
              "leaf_fixed": np.arange(6, dtype=np.uint32).reshape(3, 2)}
    pairs = [
        (wire.encode_hello(meta, arrays), jwire.encode_hello(meta, arrays)),
        (wire.encode_predict(4, 1, X), jwire.encode_predict(4, 1, X)),
        (wire.encode_partials(4, 1, acc, [("predict", 1, 9)]),
         jwire.encode_partials(4, 1, acc, [("predict", 1, 9)])),
        (wire.encode_error(4, "boom"), jwire.encode_error(4, "boom")),
    ]
    for got, want in pairs:
        assert bytes(got) == bytes(want)
    _, _, x_back = jwire.decode_predict(wire.encode_predict(4, 1, X))
    np.testing.assert_array_equal(x_back, X)
    _, _, acc_back, _ = wire.decode_partials(jwire.encode_partials(4, 1, acc))
    np.testing.assert_array_equal(acc_back, acc)
    assert (wire.MAGIC, wire.WIRE_VERSION) == (jwire.MAGIC, jwire.WIRE_VERSION)
    assert [wire.MSG_HELLO, wire.MSG_HELLO_ACK, wire.MSG_PREDICT, wire.MSG_PARTIALS,
            wire.MSG_ERROR, wire.MSG_CLOSE] == [1, 2, 3, 4, 5, 6]
    frames = []
    for mod in (wire, jwire):
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, mod.MSG_PREDICT, pairs[1][0])
            a.close()
            chunks = []
            while chunk := b.recv(1 << 16):
                chunks.append(chunk)
            frames.append(b"".join(chunks))
        finally:
            b.close()
    assert frames[0] == frames[1]
    a, b = socket.socketpair()
    try:
        a.sendall(frames[0])
        msg_type, payload = wire.read_frame(b)
        assert msg_type == wire.MSG_PREDICT and bytes(payload) == bytes(pairs[1][0])
    finally:
        a.close()
        b.close()


def test_wire_frame_rejects_bad_magic():
    a, b = socket.socketpair()
    try:
        a.sendall(b"XXXX" + bytes(5))
        with pytest.raises(wire.ConnectionClosed):
            wire.read_frame(b)
    finally:
        a.close()
        b.close()


def test_wire_refuses_wrong_ranks():
    with pytest.raises(ValueError, match="2-D"):
        wire.encode_predict(1, 0, np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="rows, classes"):
        wire.encode_partials(1, 0, np.zeros(4, np.uint32))


# ---------------------------------------------------------------------------
# cross-process conformance: merged remote partials == single-process walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["flint", "integer"])
def test_two_worker_bit_identity(remote_engine, X, single, mode):
    eng = remote_engine(EngineSpec(mode=mode, backend="cuda",
                                   plan="remote_tree_parallel", shards=2))
    _assert_same(_scores(eng, X), single[mode], mode)
    labels = list(eng.drain_shard_timings())
    assert labels and all(lbl.startswith("w") for lbl in labels)
    assert eng.plan.hello_format == "arrays"
    assert [w["device"] for w in eng.plan.workers()] == ["cpu", "cpu"]


def test_remote_rejects_float_mode(irs, worker_pair):
    with pytest.raises(ValueError, match="exact integer partials"):
        TreeEngine(irs[0], EngineSpec(mode="float", plan="remote_tree_parallel"),
                   device="cpu", plan_kwargs={"workers": list(worker_pair), **LIMITS})


def test_connect_cost_lands_in_compile_ledger(remote_engine, X):
    eng = remote_engine("integer:reference+remote_tree_parallel:2")
    eng.predict_scores(X[:8])
    drained = eng.drain_compile_timings()
    assert "remote" in drained and drained["remote"] > 0.0


def test_heterogeneous_worker_backends(remote_engine, X, single):
    """K1's and K5's plain versions and the reference walk, one backend per
    shard, cycled over the two workers."""
    for spec in ("integer:cuda|bitvector+remote_tree_parallel:2",
                 "integer:cuda|bitvector|reference+remote_tree_parallel:3"):
        eng = remote_engine(spec)
        _assert_same(_scores(eng, X), single["integer"], spec)
        names = {lbl.split(":")[1].split("[")[0] for lbl in eng.drain_shard_timings()}
        assert names == set(EngineSpec.parse(spec).backend)
        assert eng.plan.layout == ("leaf_major+bitvector" if spec.count("|") == 1
                                   else "leaf_major+bitvector+padded")


@pytest.mark.requires_gcc
def test_host_c_worker_shards(remote_engine, X, single):
    """A worker builds a host-C shard beside the card backends' plain
    versions: the table walk after K1's shard, the C bitvector scorer
    before the reference walk; every label names its backend."""
    for spec in ("integer:cuda|native_c_table+remote_tree_parallel:2",
                 "integer:native_c_bitvector|reference+remote_tree_parallel:2"):
        eng = remote_engine(spec)
        _assert_same(_scores(eng, X), single["integer"], spec)
        labels = sorted(eng.drain_shard_timings())
        assert [lbl.split(":")[1].split("[")[0] for lbl in labels] == \
            list(EngineSpec.parse(spec).backend), labels
        assert all(w["alive"] for w in eng.plan.workers()) and not eng.plan.redispatches


def test_itrf_hello_fast_path(irs, remote_engine, X, single, tmp_path):
    """A stripped artifact's image is smaller than the arrays, so HELLO ships
    it whole; the workers rebuild the forest from it and serve the same
    bits.  A float-bearing artifact takes the array HELLO."""
    for include_float, hello in ((False, "itrf"), (True, "arrays")):
        path = tmp_path / f"m{int(include_float)}.itrf"
        irs[0].to_itrf(str(path), include_float=include_float, pack_leaves=True)
        eng = remote_engine("integer:cuda|bitvector+remote_tree_parallel:2",
                            model=ForestIR.from_itrf(str(path)))
        assert eng.plan.hello_format == hello
        assert eng.plan.describe()["hello"] == hello
        _assert_same(_scores(eng, X), single["integer"], hello)


def test_worker_on_a_missing_card_fails_each_attempt(irs, X):
    """A worker started on ``cuda`` where there is no card answers ERROR
    naming the device (it never serves from the CPU); with every worker so,
    the request fails and the workers stay connected."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: a cuda worker serves here")
    procs, addrs = spawn_local_workers(1, device="cuda")
    try:
        eng = TreeEngine(irs[0], "integer:cuda+remote_tree_parallel:1", device="cpu",
                         plan_kwargs={"workers": addrs, **LIMITS})
        with pytest.raises(RuntimeError, match="on device cuda: RuntimeError"):
            eng.predict_scores(X[:4])
        assert [w["alive"] for w in eng.plan.workers()] == [True]
        assert eng.plan.workers()[0]["device"] == "cuda"
        assert eng.plan.redispatches == 0
        eng.close()
    finally:
        _kill_all(procs)


def test_worker_kill_redispatch_bit_identity(irs, X, single):
    """Kill a straggling worker mid-request: its shard re-dispatches to the
    survivor and the merged result stays bit-identical."""
    procs, addrs = spawn_local_workers(2, delays=[3000, 0], device="cpu")
    try:
        eng = TreeEngine(irs[0], "integer:reference+remote_tree_parallel:2",
                         device="cpu", plan_kwargs={"workers": addrs, "model_id": "t",
                                                    "version": 1, **LIMITS})
        killer = threading.Timer(0.5, procs[0].kill)
        killer.start()
        try:
            got = _scores(eng, X)
        finally:
            killer.cancel()
        _assert_same(got, single["integer"])
        assert eng.plan.redispatches >= 1
        assert [w["alive"] for w in eng.plan.workers()] == [False, True]
        eng.close()
    finally:
        _kill_all(procs)


def test_straggler_deadline_redispatch(irs, X, single):
    """A worker past the per-shard deadline is evicted and its shard
    re-dispatched, without killing the process and without waiting it
    out."""
    procs, addrs = spawn_local_workers(2, delays=[6000, 0], device="cpu")
    try:
        eng = TreeEngine(irs[0], "integer:reference+remote_tree_parallel:2",
                         device="cpu", plan_kwargs={"workers": addrs, "model_id": "t",
                                                    "version": 1, **LIMITS})
        eng.plan.deadline_ms = 2000.0
        t0 = time.perf_counter()
        got = _scores(eng, X[:32])
        dt = time.perf_counter() - t0
        _assert_same(got, tuple(a[:32] for a in single["integer"]))
        assert eng.plan.redispatches >= 1
        assert dt < 5.5, dt  # did not wait out the 6 s straggler
        assert procs[0].poll() is None  # evicted, not killed
        eng.close()
    finally:
        _kill_all(procs)


def test_engine_close_reaps_owned_workers(irs, X, single):
    """workers=N spawns processes on the plan's device, owned by the plan;
    close() terminates them."""
    eng = TreeEngine(irs[0], "integer:cuda+remote_tree_parallel:2", device="cpu",
                     plan_kwargs={"workers": 2, "model_id": "t", "version": 1, **LIMITS})
    _assert_same(_scores(eng, X), single["integer"])
    procs = [c.proc for c in eng.plan._conns if c.proc is not None]
    assert len(procs) == 2
    assert [w["device"] for w in eng.plan.workers()] == ["cpu", "cpu"]
    eng.close()
    for p in procs:
        assert p.wait(timeout=10) is not None
    with pytest.raises(RuntimeError, match="closed"):
        eng.plan.predict_partials(X[:2])


# ---------------------------------------------------------------------------
# gateway integration
# ---------------------------------------------------------------------------

def test_gateway_remote_spec_end_to_end(irs, worker_pair, X, single, tmp_path):
    """A registered ITRF artifact served through the gateway on the remote
    route: bit-identical, the route and setup costs in its stats, and the
    workers' spans grafted under the shard dispatch spans."""
    from repro_torch.obs import Tracer

    path = tmp_path / "m.itrf"
    irs[0].to_itrf(str(path), include_float=False, pack_leaves=True)
    reg = ModelRegistry()
    reg.register_artifact("m", str(path))
    tracer = Tracer(sample=1.0)
    route = "integer:cuda|bitvector+remote_tree_parallel:2"

    async def run():
        gw = Gateway(reg, route, device="cpu", cache_rows=0, tracer=tracer,
                     plan_kwargs={"workers": list(worker_pair), **LIMITS})
        out = await asyncio.gather(gw.submit("m", X[:40]), gw.submit("m", X[40:]))
        st = gw.stats()["per_model"]["m"]
        await gw.close()
        return out, st

    (a, b), st = asyncio.run(run())
    _assert_same((np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]])),
                 single["integer"])
    assert st["spec"] == route
    assert "remote" in st["compile_ms_by_bucket"] and "load" in st["compile_ms_by_bucket"]
    assert len(st["shards"]) == 2 and all(lbl.startswith("w") for lbl in st["shards"])
    spans = tracer.spans()
    shard_ids = {s.span_id for s in spans if s.name.startswith("shard:w")}
    worker_spans = [s for s in spans if s.name.startswith("worker:")]
    assert shard_ids and worker_spans
    assert all(s.parent_id in shard_ids for s in worker_spans)
    assert {"worker:decode", "worker:predict"} <= {s.name for s in worker_spans}


def test_gateway_close_drains_inflight(irs, worker_pair, X, single):
    """close() resolves requests already enqueued instead of failing them."""
    reg = ModelRegistry()
    reg.register_packed("m", irs[0])

    async def run():
        gw = Gateway(reg, "integer:reference+remote_tree_parallel:2", device="cpu",
                     cache_rows=0, max_delay_ms=50.0,
                     plan_kwargs={"workers": list(worker_pair), **LIMITS})
        tasks = [asyncio.ensure_future(gw.submit("m", X[:16])) for _ in range(4)]
        await asyncio.sleep(0)
        await gw.close()
        return await asyncio.gather(*tasks)

    for out in asyncio.run(run()):
        _assert_same(out, tuple(a[:16] for a in single["integer"]))


def test_worker_span_jsonl(irs, X, tmp_path):
    """Workers append per-request span JSONL when given --span-out, with
    the kernel launches of their process since the record before."""
    procs, addrs = spawn_local_workers(1, span_dir=str(tmp_path), device="cpu")
    try:
        eng = TreeEngine(irs[0], "integer:cuda|bitvector+remote_tree_parallel:2",
                         device="cpu", plan_kwargs={"workers": addrs, "model_id": "t",
                                                    "version": 1, **LIMITS})
        eng.predict_scores(X[:8])
        eng.close()
        deadline = time.monotonic() + 10
        recs = []
        while time.monotonic() < deadline and len(recs) < 2:
            time.sleep(0.05)
            recs = [json.loads(ln) for f in tmp_path.glob("worker_*.jsonl")
                    for ln in f.read_text().splitlines()]
        assert len(recs) == 2
        assert all(r["model"] == "t" and r["device"] == "cpu" for r in recs)
        assert {sp["name"] for r in recs for sp in r["spans"]} >= {"decode", "predict"}
        # on the CPU the wrappers run the plain versions and count nothing
        assert all(set(r["launches"]) == {"leaf_major", "gather", "onehot", "bitvector"}
                   and not any(r["launches"].values()) for r in recs)
    finally:
        _kill_all(procs)


# ---------------------------------------------------------------------------
# across packages: the frames are one protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hello", ["arrays", "itrf"])
def test_port_plan_merges_jax_workers(irs, jax_worker_pair, X, single, tmp_path, hello):
    """A port gateway on JAX workers (``python -m repro.serve.worker``) over
    the array HELLO and the ITRF image: bit-identical to the port's single
    walk.  The JAX package has no ``cuda`` backend, so the shards take
    ``reference``."""
    model = irs[0]
    if hello == "itrf":
        path = tmp_path / "m.itrf"
        model.to_itrf(str(path), include_float=False)
        model = ForestIR.from_itrf(str(path))
    reg = ModelRegistry()
    reg.register_packed("m", model)
    route = "integer:reference+remote_tree_parallel:2"

    async def run():
        gw = Gateway(reg, route, device="cpu", cache_rows=0,
                     plan_kwargs={"workers": list(jax_worker_pair), **LIMITS})
        out = await gw.submit("m", X)
        eng = next(iter(gw._engines.values()))
        info = eng.plan.hello_format, [w["device"] for w in eng.plan.workers()]
        await gw.close()
        return out, info

    out, (fmt, devices) = asyncio.run(run())
    _assert_same(out, single["integer"], hello)
    assert fmt == hello and devices == [None, None]  # JAX workers name no device


@pytest.mark.requires_gcc
def test_c_shards_across_packages(irs, worker_pair, jax_worker_pair, X, single):
    """A JAX plan's ``native_c_table`` shard built by a port worker, and a
    port plan's ``native_c`` shard built by a JAX worker: both merge to the
    single walk's bits."""
    from repro.serve.spec import EngineSpec as JEngineSpec

    jeng = JTreeEngine(irs[1], JEngineSpec(mode="integer", backend=("reference", "native_c_table"),
                                           plan="remote_tree_parallel", shards=2),
                       plan_kwargs={"workers": list(worker_pair), "model_id": "jc",
                                    "version": 1, **LIMITS})
    eng = TreeEngine(irs[0], "integer:native_c|reference+remote_tree_parallel:2", device="cpu",
                     plan_kwargs={"workers": list(jax_worker_pair), "model_id": "pc",
                                  "version": 1, **LIMITS})
    try:
        _assert_same(_scores(jeng, X), single["integer"], "JAX plan, port workers")
        _assert_same(_scores(eng, X), single["integer"], "port plan, JAX workers")
    finally:
        jeng.close()
        eng.close()


@pytest.mark.parametrize("mode", ["flint", "integer"])
def test_jax_plan_merges_port_workers(irs, worker_pair, X, single, mode, tmp_path):
    """A JAX ``RemoteTreeParallelPlan`` on port workers started with
    ``--device cpu``, with the array HELLO and (integer) the ITRF image the
    JAX plan ships for a stripped artifact: bit-identical to the single
    walk."""
    from repro.ir.artifact import read_itrf as jread_itrf
    from repro.serve.spec import EngineSpec as JEngineSpec

    models = [irs[1]]
    if mode == "integer":
        path = tmp_path / "j.itrf"
        irs[1].to_itrf(str(path), include_float=False)
        models.append(jread_itrf(str(path)))
    for model in models:
        eng = JTreeEngine(model, JEngineSpec(mode=mode, backend="reference",
                                             plan="remote_tree_parallel", shards=2),
                          plan_kwargs={"workers": list(worker_pair), "model_id": "j",
                                       "version": 3, **LIMITS})
        try:
            _assert_same(_scores(eng, X), single[mode], mode)
            assert all(w["alive"] for w in eng.plan.workers())
        finally:
            eng.close()
