"""The backends' row staging (``repro_torch.backends.staging``): rows in,
keys, launch and rows out for the ``cuda`` and ``bitvector`` backends.

On the CPU the helper takes the plain path: four threads at once through
each backend, each on distinct seeded rows, get exactly the partials of
``portbench``'s plain ``Reference``, and ``STAGED`` counts every call as
``plain`` and none as ``pinned``; the counter stays exact under many threads
and a short switch interval, and resets.

Marked ``cuda`` (the ``card`` fixture skips them without a card): the same
four threads on the card, where every copy is pinned and counted with its
bytes and each thread runs on its own stream; a call that raises after its
copy was enqueued, followed at once on the same thread by a call on other
rows, which must be right (a pinned block is not rewritten while a copy may
still read it); and a backend built on one thread and first used on
another (its tables are on the card before a side stream reads them).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_staging.py
"""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.backends import BitvectorBackend, CudaBackend, staging
from repro_torch.ir import ForestIR

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.forest import make_forest  # noqa: E402  (numpy only)
from portbench.reference import Reference  # noqa: E402
from portbench.system import program_forest  # noqa: E402

# the backends the helper serves, each on the layout it walks
BACKENDS = {"cuda": (CudaBackend, "leaf_major"), "bitvector": (BitvectorBackend, "bitvector")}
THREADS, ROUNDS = 4, 10
CPU_CFG = dict(n_trees=12, depth=5, n_features=9, n_classes=7, threshold_sample_rows=256)
CARD_CFG = dict(n_trees=96, depth=8, n_features=54, n_classes=7, threshold_sample_rows=4096)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def backend_on(name: str, forest, device):
    cls, layout = BACKENDS[name]
    return cls(ForestIR.from_forest(program_forest(forest)).materialize(layout),
               device=device)


def requests(seed: int, sizes, n_features: int) -> list:
    """THREADS lists of ROUNDS distinct seeded row blocks, sizes in turn."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((sizes[(t + r) % len(sizes)], n_features), dtype=np.float32)
             for r in range(ROUNDS)] for t in range(THREADS)]


def on_threads(fn, per_thread: list) -> list:
    """``fn(item)`` for every item, each list on its own thread, all at once."""
    results = [None] * len(per_thread)
    errors = []
    go = threading.Barrier(len(per_thread))

    def run(i):
        try:
            go.wait()
            results[i] = [fn(item) for item in per_thread[i]]
        except Exception as e:  # read back below, so a failure names itself
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(per_thread))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads), "a thread did not finish"
    if errors:
        raise errors[0]
    return results


def four_threads(name: str, cfg: dict, sizes, device, seed: int):
    forest = make_forest(cfg, seed)
    backend = backend_on(name, forest, device)
    reqs = requests(seed + 1, sizes, cfg["n_features"])
    staging.reset_staged()
    got = on_threads(backend.predict_partials, reqs)
    counts = dict(staging.STAGED)
    ref = Reference(forest, device)
    for t in range(THREADS):
        for r in range(ROUNDS):
            want = ref.partials(reqs[t][r])
            assert got[t][r].dtype == np.uint32 and np.array_equal(got[t][r], want), (t, r)
    return reqs, counts


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_four_threads_on_the_cpu_take_the_plain_path(name):
    _, counts = four_threads(name, CPU_CFG, (20, 300, 1), torch.device("cpu"), seed=7)
    assert counts == {"pinned": 0, "plain": THREADS * ROUNDS, "pinned_bytes": 0}


def test_the_counter_stays_exact_under_many_threads_and_resets():
    rows = [[np.full((3, 2), 8 * t + r, np.float32) for r in range(25)] for t in range(16)]

    def stand_in(keys):  # the launch: one uint32 partial a row
        return keys[:, :1].to(torch.int32)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        staging.reset_staged()
        got = on_threads(lambda x: staging.partials(x, 2, torch.device("cpu"), stand_in), rows)
    finally:
        sys.setswitchinterval(old)
    assert staging.STAGED == {"pinned": 0, "plain": 16 * 25, "pinned_bytes": 0}
    for t in range(16):
        for r in range(25):
            key = np.float32(8 * t + r).view(np.int32)  # non-negative: the key is the bits
            assert np.array_equal(got[t][r], np.full((3, 1), key, np.uint32))
    staging.reset_staged()
    assert staging.STAGED == {"pinned": 0, "plain": 0, "pinned_bytes": 0}


def test_rows_with_fewer_columns_than_the_forest_raise_before_any_copy():
    staging.reset_staged()
    with pytest.raises(ValueError, match="fewer columns"):
        staging.partials(np.zeros((4, 2), np.float32), 3, torch.device("cpu"), None)
    assert staging.STAGED["plain"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_four_threads_on_the_card_equal_the_reference(card, name):
    reqs, counts = four_threads(name, CARD_CFG, (65_536, 20, 1000), card, seed=11)
    nbytes = sum(x.shape[0] * x.shape[1] * 4 for per in reqs for x in per)
    assert counts == {"pinned": THREADS * ROUNDS, "plain": 0, "pinned_bytes": nbytes}
    streams = on_threads(lambda _: staging.thread_stream(card), [[0], [0], [0], [0]])
    assert len({id(s[0]) for s in streams}) == THREADS
    assert staging.thread_stream(card) is staging.thread_stream(card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_a_call_that_raises_after_its_copy_leaves_the_next_call_right(card, name):
    forest = make_forest(CARD_CFG, 13)
    backend = backend_on(name, forest, card)
    ref = Reference(forest, card)
    first, second = requests(14, (65_536,), CARD_CFG["n_features"])[0][:2]
    launch = backend._launch

    def forced_error(keys):
        raise RuntimeError("forced launch error")

    for _ in range(3):
        backend._launch = forced_error
        with pytest.raises(RuntimeError, match="forced launch error"):
            backend.predict_partials(first)
        backend._launch = launch
        assert np.array_equal(backend.predict_partials(second), ref.partials(second))
        first, second = second, first


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_a_backend_built_on_one_thread_serves_another(card, name):
    forest = make_forest(CARD_CFG, 15)
    rows = requests(16, (65_536,), CARD_CFG["n_features"])[0][0]
    built = on_threads(lambda _: backend_on(name, forest, card), [[0]])[0][0]
    got = on_threads(built.predict_partials, [[rows]])[0][0]
    assert np.array_equal(got, Reference(forest, card).partials(rows))
