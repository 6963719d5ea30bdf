"""Fixed-point conversion and packing of the port against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfp
from repro.core.packing import pack_forest as jax_pack_forest
from repro_torch.core import fixedpoint as tfp
from repro_torch.core.packing import pack_forest


@pytest.mark.parametrize("n_trees", [1, 2, 7, 128, 1000])
def test_scale_and_quantization_match(n_trees):
    p = np.random.default_rng(n_trees).random((50, 3))
    p[0] = [0.0, 1.0, 0.5]
    assert tfp.scale_for(n_trees) == jfp.scale_for(n_trees)
    assert tfp.max_abs_error(n_trees) == jfp.max_abs_error(n_trees)
    q = tfp.prob_to_fixed_np(p, n_trees)
    np.testing.assert_array_equal(q, jfp.prob_to_fixed_np(p, n_trees))
    np.testing.assert_array_equal(tfp.fixed_to_prob_np(q, n_trees),
                                  jfp.fixed_to_prob_np(q, n_trees))


@pytest.mark.parametrize("n_trees", [1, 9])
def test_fixed_to_prob_matches_on_partials_above_2_31(n_trees):
    acc = np.random.default_rng(0).integers(0, 2 ** 32, (64, 4), dtype=np.uint64)
    acc = acc.astype(np.uint32)
    acc[0] = [2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1, 0]
    ref = np.asarray(jfp.fixed_to_prob(jnp.asarray(acc), n_trees))
    port = tfp.fixed_to_prob(torch.from_numpy(acc), n_trees).numpy()
    assert port.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


def test_pack_forest_matches(small_forest):
    ref, port = jax_pack_forest(small_forest), pack_forest(small_forest)
    for name, value in vars(ref).items():
        if isinstance(value, np.ndarray):
            assert getattr(port, name).dtype == value.dtype, name
            np.testing.assert_array_equal(getattr(port, name), value, err_msg=name)
    assert (port.layout, port.max_depth, port.scale) == (ref.layout, ref.max_depth, ref.scale)
