"""The port's fixed-point integer all-reduce and integer data-parallel
training over gloo process groups on the CPU, against the float64 sum, the
JAX package's ``integer_psum`` (under ``jax.vmap`` with an axis name, on the
CPU) and its ``tests/test_distributed.py`` convergence case.  Every case
runs in one group of 8 spawned ranks (``torch_dist_ranks.cases_rank``): the
sums on the groups of the first 2, 4 and 8 ranks, then the training on all
8; the tests read what the ranks wrote.

Tolerance: the reference's own ``quantization_error_bound``.  The port's
power-of-two scale is exact, so it cannot equal the reference's bit for bit
(the reference's float32 ``exp2`` overshoots the power of two, which can
wrap its int32 sum; ROADMAP Queue 3).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.intreeger_allreduce import integer_psum as jax_integer_psum
from repro_torch.configs import smoke_config
from repro_torch.data.tokens import pipeline_for
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.intreeger_allreduce import (_pow2_scale, integer_pmean,
                                                   quantization_error_bound)
from repro_torch.train.step import make_train_step
from torch_dist_ranks import cases_rank, run_ranks

I32_MAX = 2**31 - 1
RANKS = 8
SIZES = (2, 4, 8)
# two ranks holding the float32 just under 1/16, or 1/16 itself
WRAPS = {"just_under": (0.062499996, 2.0**34), "sixteenth": (0.0625, 2.0**33)}
TRAIN = ("granite-3-2b", 16, 64, 25, 5e-3)  # arch, batch, seq, steps, lr


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are small: one intra-op thread each, which leaves the
    other test workers' cores alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n: int) -> np.ndarray:
    return np.random.default_rng(n).normal(scale=3.0, size=(n, 1024)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """The directory the 8 ranks wrote their results to."""
    out = tmp_path_factory.mktemp("ranks")
    cases = []
    for n in SIZES:
        np.save(out / f"data{n}.npy", _data(n))
        cases.append((f"psum{n}", n, str(out / f"data{n}.npy"),
                      [list(range(n)), list(range(n))[::-1]]))
    for tag, (x, _) in WRAPS.items():
        np.save(out / f"{tag}.npy", np.full((2, 3), np.float32(x)))
        cases.append((tag, 2, str(out / f"{tag}.npy"), [[0, 1]]))
    run_ranks(cases_rank, RANKS, str(out), cases, (*TRAIN, "cpu"))
    return out


@pytest.mark.parametrize("n", SIZES)
def test_integer_psum_within_bound_and_order_independent(n, ranks_out):
    data = _data(n)
    sums = np.stack([np.load(ranks_out / f"psum{n}_{r}.npy") for r in range(n)])
    bound = quantization_error_bound(n, float(np.abs(data).max()))
    exact = data.astype(np.float64).sum(axis=0)
    assert np.abs(sums[0, 0] - exact).max() <= bound
    # every rank holds the same bits, in either order of the replicas
    flat = sums.reshape(-1, sums.shape[-1])
    assert all(np.array_equal(row.view(np.uint32), flat[0].view(np.uint32)) for row in flat)
    # and the reference's integer psum over a vmapped axis agrees within it
    want = jax.vmap(lambda x: jax_integer_psum(x, "d", n), axis_name="d")(jnp.asarray(data))
    assert np.abs(sums[0, 0] - np.asarray(want)[0]).max() <= bound


def test_scale_is_an_exact_power_of_two_and_the_largest_that_fits():
    rng = np.random.default_rng(0)
    bounds = np.concatenate([np.abs(rng.normal(size=2000)) * 10.0 ** rng.integers(-20, 20, 2000),
                             2.0 ** np.arange(-30, 30), [0.062499996, 0.0625, 1e-30]])
    for n in (1, 2, 3, 8, 1000):
        for b in bounds.astype(np.float32):
            scale = float(_pow2_scale(torch.tensor(b), n))
            assert np.frexp(scale)[0] == 0.5, (n, b, scale)
            assert n * float(b) * scale <= I32_MAX, (n, b, scale)
            # the largest such power, or float32's largest power of two
            assert scale == 2.0**127 or n * max(float(b), 1e-30) * 2 * scale > I32_MAX, \
                (n, b, scale)


@pytest.mark.parametrize("tag", list(WRAPS))
def test_the_cases_where_the_reference_wraps_sum_to_plus_an_eighth(tag, ranks_out):
    """Two ranks holding the float32 just under 1/16, or 1/16 itself.  The
    reference's int32 sum wraps to -0.12499975 and -0.12499973 (jax 0.9.0 on
    the CPU): its ``exp2`` of 34 overshoots 2**34 in the first case, and in
    the second its float32 ``(2**31 - 1) / 2`` rounds up to 2**30, so that
    the exact 2**34 is one power too many.  The port's scale keeps the sum
    under 2**31 and within the bound."""
    x, scale = WRAPS[tag]
    data = np.full((2, 3), np.float32(x))
    assert float(_pow2_scale(torch.tensor(data.max()), 2)) == scale
    got = np.load(ranks_out / f"{tag}_0.npy")[0]
    exact = data.astype(np.float64).sum(axis=0)
    assert np.abs(got - exact).max() <= quantization_error_bound(2, float(data.max()))
    assert (got > 0.12).all()
    assert np.array_equal(got, np.load(ranks_out / f"{tag}_1.npy")[0])


def test_integer_pmean_without_a_group_is_the_quantized_value():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=64).astype(np.float32))
    got = integer_pmean(x)
    bound = quantization_error_bound(1, float(x.abs().max()))
    assert (got - x).abs().max().item() <= bound


def test_integer_dp_training_converges(ranks_out):
    """``tests/test_distributed.py``'s case: granite smoke, 8 ranks, batch
    16, seq 64, 25 steps at lr 5e-3; the loss descends, tracks the exact
    single-process path, and every rank ends with the same bits."""
    arch, batch, seq, steps, lr = TRAIN
    runs = [np.load(ranks_out / f"dp_{r}.npz") for r in range(RANKS)]
    for r in runs[1:]:
        assert np.array_equal(r["losses"], runs[0]["losses"])
        assert list(r["digests"]) == list(runs[0]["digests"])
    integer = runs[0]["losses"]

    cfg = smoke_config(arch)
    params = tfm.init_params(cfg, 0, device="cpu")
    ostate = opt.init_opt_state(params)
    step = make_train_step(cfg, opt.AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps))
    pipe = pipeline_for(cfg, batch, seq)
    exact = []
    for s in range(steps):
        params, ostate, m = step(params, ostate, pipe.batch_at(s))
        exact.append(float(m["loss"]))
    print(json.dumps({"exact": exact[-1], "integer": float(integer[-1]),
                      "e0": exact[0], "i0": float(integer[0])}))
    assert integer[-1] < integer[0] - 0.2  # clearly descending
    assert abs(integer[-1] - exact[-1]) < 0.15  # tracks the exact path
