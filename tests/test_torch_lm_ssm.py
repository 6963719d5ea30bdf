"""The port's state-space LMs against the JAX package: mamba2 and zamba2's
hybrid (shared attention sets alternating every ``hybrid_attn_every``
layers) ``SMOKE`` configurations end to end (see ``torch_lm_cases``), and
the chunked SSD (``ssd_forward``) against the reference's and against the
port's own literal recurrence at the sequence/chunk pairs of
``tests/test_moe_ssm_units.py``, non-divisible lengths included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as ssm
from torch_lm_cases import TOL, check_forward, check_generate, check_prefill_decode

ARCHS = ["mamba2-370m", "zamba2-2.7b"]
D_MODEL, EXPAND, STATE = 64, 2, 16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    check_generate(arch)


def _params():
    params = jssm.ssm_params(jax.random.PRNGKey(0), D_MODEL, EXPAND, STATE)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return params, tparams


def _sequential(tparams, x):
    """The literal recurrence: one ``ssd_decode_step`` per position."""
    cache = ssm.ssm_init_cache(x.shape[0], D_MODEL, EXPAND, STATE, x.dtype)
    outs = []
    for t in range(x.shape[1]):
        y, cache = ssm.ssd_decode_step(tparams, x[:, t:t + 1], cache, d_model=D_MODEL,
                                       expand=EXPAND, state=STATE)
        outs.append(y)
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("seq,chunk", [(16, 8), (24, 8), (32, 32), (17, 8)])
def test_ssd_forward_matches_jax_and_the_recurrence(seq, chunk):
    params, tparams = _params()
    x = np.random.default_rng(0).normal(size=(2, seq, D_MODEL)) * 0.3
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    y_j, st_j = jax.jit(lambda p, x: jssm.ssd_forward(
        p, x, d_model=D_MODEL, expand=EXPAND, state=STATE, chunk=chunk,
        return_final_state=True))(params, xj)
    y_t, st_t = ssm.ssd_forward(tparams, xt, d_model=D_MODEL, expand=EXPAND, state=STATE,
                                chunk=chunk, return_final_state=True)
    assert y_t.shape == (2, seq, D_MODEL) and y_t.dtype == torch.bfloat16
    assert np.abs(y_t.float().numpy() - np.asarray(y_j.astype(jnp.float32))).max() < TOL
    np.testing.assert_allclose(st_t["ssm"].numpy(), np.asarray(st_j["ssm"]), atol=1e-5)
    np.testing.assert_array_equal(st_t["conv"].float().numpy(),
                                  np.asarray(st_j["conv"].astype(jnp.float32)))
    # the chunked algorithm == the literal recurrence (the reference test's
    # tolerances)
    y_s, st_s = _sequential(tparams, xt)
    np.testing.assert_allclose(y_t.float().numpy(), y_s.float().numpy(), atol=0.15, rtol=0.2)
    np.testing.assert_allclose(st_t["ssm"].numpy(), st_s["ssm"].numpy(), atol=0.05, rtol=0.1)
    np.testing.assert_allclose(st_t["conv"].float().numpy(), st_s["conv"].float().numpy(),
                               atol=1e-2)


def test_ssd_decode_step_matches_jax():
    params, tparams = _params()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, D_MODEL)) * 0.3
    d_inner, h, conv_dim = ssm.ssm_dims(D_MODEL, EXPAND, STATE)
    conv = rng.normal(size=(2, ssm.CONV_K - 1, conv_dim))
    state = rng.normal(size=(2, h, STATE, ssm.HEADDIM)).astype(np.float32)
    y_j, c_j = jax.jit(lambda p, x, c: jssm.ssd_decode_step(
        p, x, c, d_model=D_MODEL, expand=EXPAND, state=STATE))(
        params, jnp.asarray(x, jnp.bfloat16),
        {"conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(state)})
    y_t, c_t = ssm.ssd_decode_step(
        tparams, torch.from_numpy(x).to(torch.bfloat16),
        {"conv": torch.from_numpy(conv).to(torch.bfloat16), "ssm": torch.from_numpy(state)},
        d_model=D_MODEL, expand=EXPAND, state=STATE)
    assert np.abs(y_t.float().numpy() - np.asarray(y_j.astype(jnp.float32))).max() < TOL
    np.testing.assert_allclose(c_t["ssm"].numpy(), np.asarray(c_j["ssm"]), atol=1e-5)
    np.testing.assert_array_equal(c_t["conv"].float().numpy(),
                                  np.asarray(c_j["conv"].astype(jnp.float32)))
