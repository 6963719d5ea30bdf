"""Shared cases of the port's LM tests (``test_torch_lm_*.py``).

Each LM architecture's ``SMOKE`` configuration, with the JAX package's
``init_params(cfg, PRNGKey(1))`` weights carried across to the port by
``params_from_numpy``, on the same seeded numpy batches.  The JAX functions
run under ``jax.jit`` on the CPU, as the JAX package's own tests run them;
the port runs on the CPU through ``LMEngine(device="cpu")``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.serve.engine import LMEngine as JaxLMEngine
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import LMEngine

# the reference's own bf16 tolerance (tests/test_arch_smoke.py, prefill/decode
# consistency): logits within TOL; argmax equal wherever the reference's
# top-2 margin exceeds 2 * TOL
TOL = 0.08
B, S = 2, 32
PROMPT, GEN = 16, 8


def make_batch(cfg, b: int = B, s: int = S, seed: int = 1) -> dict:
    """Numpy inputs as ``tests/test_arch_smoke.py`` draws them."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)}
    if cfg.family == "vlm":
        st = s - cfg.vision_patches
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, st)).astype(np.int32),
                "patches": rng.normal(size=(b, cfg.vision_patches, cfg.frontend_dim)
                                      ).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def without_last_token(batch: dict) -> dict:
    return dict(batch, tokens=batch["tokens"][:, :-1])


@functools.lru_cache(maxsize=None)
def jax_case(arch: str):
    """(JAX config, JAX params, the same params as numpy)."""
    jcfg = jax_smoke_config(arch)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def port_engine(arch: str, max_seq: int) -> LMEngine:
    cfg = smoke_config(arch)
    params = tfm.params_from_numpy(cfg, jax_case(arch)[2], device="cpu")
    return LMEngine(cfg, params, max_seq=max_seq, device="cpu")


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_forward(arch: str) -> np.ndarray:
    jcfg, jp, _ = jax_case(arch)
    fn = jax.jit(lambda p, bt: jtfm.forward_logits(jcfg, p, bt))
    return np.asarray(fn(jp, _jnp(make_batch(jcfg))))


@functools.lru_cache(maxsize=None)
def jax_prefill_decode(arch: str):
    """(prefill's last-token logits on all tokens but the last, the decode
    step's logits on the last token), max_seq = S."""
    jcfg, jp, _ = jax_case(arch)
    batch = make_batch(jcfg)
    eng = JaxLMEngine(jcfg, jp, max_seq=S)
    logits, cache = eng._prefill(jp, _jnp(without_last_token(batch)))
    decoded, _ = eng._decode(jp, cache, jnp.asarray(batch["tokens"][:, -1:]))
    return np.asarray(logits), np.asarray(decoded)


def prompt_len(cfg) -> int:
    """PROMPT tokens, after the patches for the vlm."""
    return PROMPT + (cfg.vision_patches if cfg.family == "vlm" else 0)


def prompt_batch(cfg) -> dict:
    return make_batch(cfg, s=prompt_len(cfg), seed=2)


@functools.lru_cache(maxsize=None)
def jax_greedy(arch: str):
    """The JAX ``LMEngine``'s greedy tokens (B, GEN) and the logits each was
    picked from, stepping its own jitted prefill and decode as its
    ``generate`` does."""
    jcfg, jp, _ = jax_case(arch)
    eng = JaxLMEngine(jcfg, jp, max_seq=prompt_len(jcfg) + GEN)
    logits, cache = eng._prefill(jp, _jnp(prompt_batch(jcfg)))
    toks, seen = [], []
    for _ in range(GEN):
        seen.append(np.asarray(logits))
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32).reshape(-1, 1)
        toks.append(np.asarray(nxt))
        logits, cache = eng._decode(jp, cache, nxt)
    return np.concatenate(toks, axis=1), np.stack(seen)


def top2_margin(logits: np.ndarray) -> np.ndarray:
    part = np.sort(logits, axis=-1)
    return part[..., -1] - part[..., -2]


def assert_logits_close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err < TOL, f"{what}: max |port - jax| = {err}"
    sure = top2_margin(want) > 2 * TOL
    agree = got.argmax(-1) == want.argmax(-1)
    assert agree[sure].all(), f"{what}: argmax differs where the margin exceeds {2 * TOL}"


def check_forward(arch: str) -> None:
    cfg = smoke_config(arch)
    eng = port_engine(arch, S)
    with torch.inference_mode():
        got = tfm.forward_logits(cfg, eng.params, {k: torch.from_numpy(v)
                                                   for k, v in make_batch(cfg).items()})
    assert got.shape[-1] == cfg.vocab_size
    assert_logits_close(got.numpy(), jax_forward(arch), f"{arch} forward_logits")


def check_prefill_decode(arch: str) -> None:
    cfg = smoke_config(arch)
    batch = make_batch(cfg)
    eng = port_engine(arch, S)
    logits, cache = eng.prefill(without_last_token(batch))
    assert cache["pos"] == S - 1
    decoded, cache = eng.decode(cache, torch.from_numpy(batch["tokens"][:, -1:]))
    assert cache["pos"] == S
    want_prefill, want_decode = jax_prefill_decode(arch)
    assert_logits_close(logits.numpy(), want_prefill, f"{arch} prefill")
    assert_logits_close(decoded.numpy(), want_decode, f"{arch} decode_step")
    # the port's own consistency, as tests/test_arch_smoke.py checks the
    # reference's: the decode step equals the full forward's last position
    with torch.inference_mode():
        full = tfm.forward_logits(cfg, eng.params, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    assert_logits_close(decoded.numpy(), full[:, -1].numpy(), f"{arch} decode vs forward")


def check_generate(arch: str) -> None:
    cfg = smoke_config(arch)
    want, seen = jax_greedy(arch)
    got = port_engine(arch, prompt_len(cfg) + GEN).generate(prompt_batch(cfg), GEN).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    differ = np.nonzero((got != want).any(axis=0))[0]
    if differ.size:
        # a divergence is allowed only where the reference itself was within
        # its tolerance of a tie at the first step that differs
        step = differ[0]
        rows = got[:, step] != want[:, step]
        margin = top2_margin(seen[step][rows])
        assert (margin < TOL).all(), (f"{arch}: greedy tokens diverge at step {step} "
                                      f"where the reference's top-2 margin is {margin}")
