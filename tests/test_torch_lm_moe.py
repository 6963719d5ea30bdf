"""The port's MoE LMs and router against the JAX package: olmoe and
qwen3-moe ``SMOKE`` configurations end to end (see ``torch_lm_cases``),
``flint_topk``'s order on tied logits (the lower expert first, as
``lax.top_k``), and ``moe_block`` with and without capacity drops — the
same output, and the same (token, expert) pairs dropped."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as moe
from torch_lm_cases import TOL, check_forward, check_generate, check_prefill_decode

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    check_generate(arch)


def _tied_logits(seed: int, t: int = 64, e: int = 16):
    """Logits drawn from a handful of values (+0.0 and -0.0 among them), so
    most rows hold ties across the top-k boundary."""
    rng = np.random.default_rng(seed)
    vals = np.array([-1.5, -0.0, 0.0, 0.25, 0.25, 1.0, 2.0], np.float32)
    return vals[rng.integers(0, len(vals), (t, e))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_flint_topk_orders_ties_as_lax_top_k(seed, k):
    """The same experts in the same order as the reference's ``flint_topk``,
    which is ``lax.top_k`` over the int32 keys: on equal keys (+0.0 and
    -0.0 share one) the lower index comes first."""
    from repro.core.flint import float_to_key as jax_float_to_key

    logits = _tied_logits(seed)
    w_j, ids_j = jax.jit(lambda x: jmoe.flint_topk(x, k))(jnp.asarray(logits))
    _, ids_lax = jax.lax.top_k(jax_float_to_key(jnp.asarray(logits)), k)
    w_t, ids_t = moe.flint_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_lax))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-7)
    # ties really were broken: some row's k-th and (k+1)-th keys are equal
    srt = np.sort(logits, axis=1)[:, ::-1]
    assert (srt[:, k - 1] == srt[:, k]).any()


def _loop_slots(ids: np.ndarray, n_experts: int) -> np.ndarray:
    """Each pair's exclusive prefix count among same-expert pairs, in pair
    order (a plain loop, independent of both packages)."""
    seen = np.zeros(n_experts, np.int64)
    out = np.empty(ids.size, np.int64)
    for i, e in enumerate(ids.reshape(-1)):
        out[i] = seen[e]
        seen[e] += 1
    return out


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_block_matches_jax_and_drops_the_same_pairs(capacity_factor, k):
    d, e, ff, t = 32, 8, 48, 64
    params = jmoe.moe_params(jax.random.PRNGKey(k), d, e, ff)
    tparams = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    x = np.random.default_rng(int(capacity_factor * 10) + k).normal(size=(2, t // 2, d))
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    y_j, aux_j = jax.jit(lambda p, x: jmoe.moe_block(p, x, n_experts=e, k=k,
                                                     capacity_factor=capacity_factor))(params, xj)
    y_t, aux_t = moe.moe_block(tparams, xt, n_experts=e, k=k, capacity_factor=capacity_factor)
    y_j = np.asarray(y_j.astype(jnp.float32))
    y_t = y_t.float().numpy()
    assert np.abs(y_t - y_j).max() < TOL
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)

    # the same routing and the same drops, pair for pair: the reference's
    # ids and slots as its _moe_block_jit computes them (flint_topk on its
    # own router logits, the one-hot exclusive prefix count), under jit
    def jax_route(x, w_router):
        ids = jmoe.flint_topk(x.reshape(t, d) @ w_router.astype(x.dtype), k)[1].reshape(-1)
        onehot = jax.nn.one_hot(ids, e, dtype=jnp.int32)
        slots = jnp.cumsum(onehot, axis=0) - onehot
        return ids, jnp.take_along_axis(slots, ids[:, None], axis=1)[:, 0]

    ids_j, slots_j = (np.asarray(a) for a in jax.jit(jax_route)(xj, params["w_router"]))
    ids_t = moe.route(tparams, xt.reshape(t, d), k)[2].reshape(-1)
    slots_t = moe.dispatch_slots(ids_t, e).numpy()
    capacity = int(max(1, (t * k * capacity_factor) // e))
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    np.testing.assert_array_equal(slots_t, slots_j)
    np.testing.assert_array_equal(slots_t >= capacity, slots_j >= capacity)
    np.testing.assert_array_equal(slots_j, _loop_slots(ids_j, e))
    dropped = (slots_j >= capacity).reshape(t, k)
    if capacity_factor >= e / k:
        assert not dropped.any()  # E/k makes dispatch dropless
    if capacity_factor <= 0.25:
        assert dropped.any() and not dropped.all(axis=1).all()
    # a token whose every pair dropped reads exactly 0 in both, and no
    # other token does (y above holds the kept pairs to the tolerance)
    gone = dropped.all(axis=1)
    np.testing.assert_array_equal((y_t.reshape(t, d) == 0).all(axis=1), gone)
    np.testing.assert_array_equal((y_j.reshape(t, d) == 0).all(axis=1), gone)
