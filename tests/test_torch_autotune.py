"""The port's warm-time autotuner (``repro_torch.serve.autotune``) for the
cuda backend's CTA shape, on the CPU.

What must hold, as for the JAX package's autotuner:
  * the grid — ``pick_blocks``'s choice first, then its feasible halved and
    doubled neighbours (rows per CTA multiples of 32 up to 512 whose staged
    row tile fits, trees per CTA from 1 to T);
  * determinism — a constant timer resolves ties to the heuristic, a ranked
    timer picks the same winner every run;
  * bit-identity — serving on the tuned config equals the JAX engine;
  * caching — the winner lands in the owning ``ModelVersion``'s store and a
    hot-swapped version serves on it without re-measuring;
  * escape hatches — ``REPRO_AUTOTUNE=0``, caller-pinned knobs, and the
    route's own kwargs (``impl=onehot``) carried into every candidate.
"""
import asyncio

import numpy as np
import pytest

from repro.ir import ForestIR as JForestIR
from repro.serve import autotune as jat
from repro.serve.engine import TreeEngine as JTreeEngine
from repro.trees.forest import RandomForestClassifier
from repro_torch.ir import ForestIR
from repro_torch.kernels.ops import fits, pick_blocks, pick_blocks_candidates
from repro_torch.serve import Gateway, ModelRegistry, TreeEngine
from repro_torch.serve import autotune as at


@pytest.fixture(scope="module")
def forests():
    rng = np.random.default_rng(31)
    X = rng.normal(size=(800, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.3).astype(int)
    v1 = RandomForestClassifier(n_estimators=6, max_depth=5, seed=1).fit(X, y)
    v2 = RandomForestClassifier(n_estimators=4, max_depth=4, seed=5).fit(X, y)
    return X, v1, v2


def _ranked(block_b, block_t):
    """A deterministic timer: the candidate with this CTA shape is fastest."""
    def measure(backend, X):
        kw = backend._blocks
        return 1.0 if (kw["block_b"], kw["block_t"]) == (block_b, block_t) else 2.0
    return measure


@pytest.mark.parametrize("b,t", [(256, 6), (256, 128), (65_536, 128), (1, 1), (4096, 40)])
def test_candidate_grid_heuristic_first(b, t):
    cands = pick_blocks_candidates(b, t, 87, 132)
    assert cands[0] == pick_blocks(b, t, 87, 132)
    assert len(set(cands)) == len(cands)
    auto_b, auto_t = cands[0]
    for bb, bt in cands[1:]:
        assert fits(bb, 87) and 32 <= bb <= 512 and bb % 32 == 0 and 1 <= bt <= t
        assert (bb in (auto_b // 2, auto_b * 2) and bt == auto_t) or \
            (bb == auto_b and bt in (auto_t // 2, min(t, auto_t * 2)))


def test_grid_for_backends(forests):
    _, v1, _ = forests
    lm = ForestIR.from_forest(v1).materialize("leaf_major")
    grid = at.candidate_grid("cuda", lm)
    assert grid[0] == {"block_b": 128, "block_t": 4} and len(grid) >= 2
    assert at.candidate_grid("reference", lm) == []
    assert at.config_str(grid[0]) == jat.config_str(grid[0]) == "block_b=128,block_t=4"
    assert at.config_str({}) == jat.config_str({}) == "-"


@pytest.mark.parametrize("impl,kernel", [(None, "leaf_major"), ("gather", "gather"),
                                         ("onehot", "onehot")])
def test_grid_follows_the_route_kernel(forests, impl, kernel):
    """Every route's kernel is tuned over the same grid, the staged one, since
    all three stage their row tile alike; every candidate launches the
    route's own kernel."""
    _, v1, _ = forests
    lm = ForestIR.from_forest(v1).materialize("leaf_major")
    kernels = []

    def measure(backend, X):
        kernels.append(backend.impl)
        return 1.0

    _, winner, report = at.tune_backend("cuda", lm, "integer", rows=256, measure=measure,
                                        backend_kwargs={"impl": impl} if impl else None,
                                        device="cpu")
    want = pick_blocks_candidates(256, lm.feature.shape[0], lm.n_features, 132)
    assert [(kw["block_b"], kw["block_t"]) for kw, _ in report] == want
    assert want[0] == (128, 4)  # staged: a group of 4 walks per CTA (unstaged: 1 tree)
    assert winner.impl == kernel and set(kernels) == {kernel}


def test_tune_is_deterministic_and_ties_go_to_default(forests):
    _, v1, _ = forests
    lm = ForestIR.from_forest(v1).materialize("leaf_major")
    const = lambda backend, X: 1.0
    winners = {tuple(at.tune_backend("cuda", lm, "integer", measure=const,
                                     device="cpu")[0].items()) for _ in range(3)}
    assert winners == {(("block_b", 128), ("block_t", 4))}
    for _ in range(2):
        w, wb, report = at.tune_backend("cuda", lm, "integer", device="cpu",
                                        measure=_ranked(64, 4))
        assert w == {"block_b": 64, "block_t": 4} and wb._blocks == w
        assert [kw for kw, _ in report] == at.candidate_grid("cuda", lm)


def test_measure_backend_times_real_calls(forests):
    X, v1, _ = forests
    eng = TreeEngine(ForestIR.from_forest(v1), spec="integer:cuda", device="cpu")
    seconds = at.measure_backend(eng.backend, X[:64], rounds=2, warmup=1)
    assert 0.0 < seconds < 60.0


def test_warm_tunes_and_stays_bit_identical(forests, monkeypatch):
    X, v1, _ = forests
    monkeypatch.setattr(at, "measure_backend", _ranked(64, 4))
    ir = ForestIR.from_forest(v1)
    store = {}
    eng = TreeEngine(ir, spec="integer:cuda?autotune=true", tuned_store=store, device="cpu")
    assert eng.tuned_config is None
    eng.warm(64)
    assert eng.tuned_config == "block_b=64,block_t=4"
    assert eng.backend._blocks == {"block_b": 64, "block_t": 4}
    assert "tune" in eng.drain_compile_timings()
    assert list(store.values()) == [{"block_b": 64, "block_t": 4}]
    ref = JTreeEngine(JForestIR.from_forest(v1), spec="integer:pallas")
    for b in (1, 20, 100):
        s, p = eng.predict_scores(X[:b])
        s_ref, p_ref = ref.predict_scores(X[:b])
        np.testing.assert_array_equal(s, np.asarray(s_ref))
        np.testing.assert_array_equal(p, np.asarray(p_ref))


def test_hot_swap_reuses_the_winner_without_measuring(forests, monkeypatch):
    X, v1, v2 = forests
    calls = []

    def measure(backend, X):
        calls.append(backend._blocks)
        return _ranked(256, 4)(backend, X)

    monkeypatch.setattr(at, "measure_backend", measure)
    reg = ModelRegistry()
    reg.register_forest("m", v1)
    route = "integer:cuda?autotune=true"
    reg.get("m").engine(route, device="cpu").warm(64)
    assert calls and reg.get("m")._tuned
    calls.clear()
    mv2 = reg.register_forest("m", v2)
    eng2 = mv2.engine(route, device="cpu")
    assert eng2.tuned_config == "block_b=256,block_t=4" and not eng2._pending_tune
    eng2.warm(64)
    assert calls == []
    gw = Gateway(reg, route, device="cpu")

    async def run():
        out = await gw.submit("m", X[:10])
        await gw.close()
        return out

    s, _ = asyncio.run(run())
    np.testing.assert_array_equal(s, TreeEngine(mv2.packed, spec="integer:reference",
                                                device="cpu").predict_scores(X[:10])[0])
    assert gw.stats()["per_model"]["m"]["tuned"] == "block_b=256,block_t=4"


def test_escape_hatches(forests, monkeypatch):
    X, v1, _ = forests
    ir = ForestIR.from_forest(v1)
    monkeypatch.setattr(at, "measure_backend", _ranked(64, 4))
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    off = TreeEngine(ir, spec="integer:cuda?autotune=true", device="cpu")
    off.warm(16)
    assert off.tuned_config is None and "tune" not in off.drain_compile_timings()
    monkeypatch.delenv("REPRO_AUTOTUNE")
    pinned = TreeEngine(ir, spec="integer:cuda?autotune=true,block_b=32", device="cpu")
    pinned.warm(16)
    assert pinned.tuned_config is None and pinned.backend._blocks["block_b"] == 32
    untunable = TreeEngine(ir, spec="integer:reference?autotune=true", device="cpu")
    assert not untunable._pending_tune
    monkeypatch.setattr(at, "measure_backend", _ranked(128, 2))  # in K3's grid
    onehot = TreeEngine(ir, spec="integer:cuda@padded?autotune=true,impl=onehot",
                        device="cpu")
    onehot.warm(16)
    assert onehot.tuned_config == "block_b=128,block_t=2"
    assert onehot.backend.impl == "onehot"


def test_routes_differing_only_in_impl_tune_independently(forests, monkeypatch):
    X, v1, _ = forests
    reg = ModelRegistry()
    mv = reg.register_forest("m", v1)
    monkeypatch.setattr(at, "measure_backend", _ranked(128, 2))  # in K3's grid
    k3 = mv.engine("integer:cuda@padded?autotune=true,impl=onehot", device="cpu")
    k3.warm(16)
    monkeypatch.setattr(at, "measure_backend", _ranked(256, 4))
    k2 = mv.engine("integer:cuda@padded?autotune=true", device="cpu")
    assert k2 is not k3 and k2._pending_tune  # K3's winner is not reused
    k2.warm(16)
    assert k3.tuned_config == "block_b=128,block_t=2"
    assert k2.tuned_config == "block_b=256,block_t=4"
    assert (k3.backend.impl, k2.backend.impl) == ("onehot", "gather")
    assert sorted(mv._tuned.values(), key=lambda w: w["block_b"]) == [
        {"block_b": 128, "block_t": 2}, {"block_b": 256, "block_t": 4}]
    for b in (1, 20, 100):
        np.testing.assert_array_equal(k3.predict_scores(X[:b])[0],
                                      k2.predict_scores(X[:b])[0])
