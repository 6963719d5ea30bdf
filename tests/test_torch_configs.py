"""The port's configuration registry and token pipeline against the JAX
package: every ``ARCHS`` entry's ``CONFIG`` and ``SMOKE`` equal field for
field, ``param_count`` and ``active_param_count`` equal for all eleven, the
published shapes the reference's ``test_exact_config_shapes`` pins, and
``TokenPipeline.batch_at`` equal element for element."""
import dataclasses

import numpy as np
import pytest

from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro_torch.configs import base
from repro_torch.data import tokens

ARCHS = list(jbase.ARCHS)


def test_registry_lists_the_same_archs():
    assert base.ARCHS == jbase.ARCHS
    assert [f.name for f in dataclasses.fields(base.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ModelConfig)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["get_config", "smoke_config"])
def test_config_equals_jax_field_for_field(arch, which):
    got, want = getattr(base, which)(arch), getattr(jbase, which)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("resolved_head_dim", "sub_quadratic", "has_decode"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert [base.block_kind(got, i) for i in range(got.n_layers)] == \
        [jbase.block_kind(want, i) for i in range(want.n_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch):
    for which in ("get_config", "smoke_config"):
        got, want = getattr(base, which)(arch), getattr(jbase, which)(arch)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()


def test_granite_3_2b_param_count():
    """The full-width model the chip run serves: 2.53 B parameters."""
    n = base.get_config("granite-3-2b").param_count()
    assert n == jbase.get_config("granite-3-2b").param_count()
    assert 2.5e9 < n < 2.55e9


def test_exact_config_shapes():
    """The registry carries the exact published configurations (the
    reference's ``tests/test_arch_smoke.py::test_exact_config_shapes``)."""
    get_config = base.get_config
    c = get_config("gemma3-27b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab_size) == (
        62, 5376, 32, 16, 21504, 262144,
    )
    c = get_config("qwen3-moe-30b-a3b")
    assert (c.n_experts, c.experts_per_token, c.n_kv_heads, c.d_ff) == (128, 8, 4, 768)
    c = get_config("granite-34b")
    assert (c.n_layers, c.n_kv_heads) == (88, 1)
    c = get_config("zamba2-2.7b")
    assert (c.n_layers, c.d_model, c.ssm_state) == (54, 2560, 64)
    c = get_config("mamba2-370m")
    assert (c.n_layers, c.d_model, c.ssm_state) == (48, 1024, 128)
    c = get_config("olmoe-1b-7b")
    assert (c.n_experts, c.experts_per_token) == (64, 8)
    c = get_config("hubert-xlarge")
    assert c.encoder_only and c.vocab_size == 504
    c = get_config("llava-next-34b")
    assert (c.n_layers, c.d_model, c.n_heads) == (60, 7168, 56)
    c = get_config("starcoder2-3b")
    assert (c.n_kv_heads, c.d_ff) == (2, 12288)
    c = get_config("granite-3-2b")
    assert (c.n_layers, c.vocab_size) == (40, 49155)


@pytest.mark.parametrize("arch", ["granite-3-2b", "llava-next-34b", "hubert-xlarge"])
@pytest.mark.parametrize("shards", [(1, 0), (2, 1)])
def test_token_pipeline_batches_equal_jax(arch, shards):
    """Same seed, step and shard: the same arrays, element for element."""
    n_shards, shard = shards
    cfg, jcfg = base.smoke_config(arch), jbase.smoke_config(arch)
    seq = 32
    got = tokens.pipeline_for(cfg, 4, seq, seed=3, n_shards=n_shards, shard=shard)
    want = jtokens.pipeline_for(jcfg, 4, seq, seed=3, n_shards=n_shards, shard=shard)
    for step in (0, 5):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
