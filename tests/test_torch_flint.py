"""FlInt keys of the port against the JAX package: bit-equal on every float32
bit pattern class, including the NaN and infinity patterns
``test_flint.py`` leaves out."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flint as jflint
from repro_torch.core import flint as tflint

_SPECIAL = np.array(
    [
        0x00000000, 0x80000000,  # +0, -0
        0x7F800000, 0xFF800000,  # +inf, -inf
        0x00000001, 0x80000001,  # smallest subnormals
        0x007FFFFF, 0x807FFFFF,  # largest subnormals
        0x00800000, 0x80800000,  # smallest normals
        0x7F7FFFFF, 0xFF7FFFFF,  # largest finite
        0x7FC00000, 0xFFC00000,  # quiet NaNs
        0x7F800001, 0xFF800001,  # signalling NaNs
        0x7FABCDEF, 0xFFFFFFFF,  # NaN payloads
        0x3F800000, 0xBF800000,  # +1, -1
    ],
    np.uint32,
)


def _patterns(seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([_SPECIAL, rand]).view(np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_keys_bit_equal_to_reference(seed):
    f = _patterns(seed)
    ref_np = jflint.float_to_key_np(f)
    ref_jax = np.asarray(jflint.float_to_key(jnp.asarray(f)))
    port = tflint.float_to_key(torch.from_numpy(f)).numpy()
    assert port.dtype == np.int32 and ref_np.dtype == np.int32
    np.testing.assert_array_equal(port, ref_np)
    np.testing.assert_array_equal(port, ref_jax)
    np.testing.assert_array_equal(tflint.float_to_key_np(f), ref_np)


@pytest.mark.parametrize("seed", [0, 1])
def test_roundtrip_bit_equal_to_reference(seed):
    keys = jflint.float_to_key_np(_patterns(seed))
    ref = jflint.key_to_float_np(keys)
    port = tflint.key_to_float(torch.from_numpy(keys)).numpy()
    assert port.dtype == np.float32
    np.testing.assert_array_equal(_bits(port), _bits(ref))
    np.testing.assert_array_equal(_bits(tflint.key_to_float_np(keys)), _bits(ref))


def test_every_int32_key_inverts():
    """Keys at the ends of the int32 range (INT32_MIN - b for negative b
    cannot overflow) invert exactly as the reference's."""
    keys = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 1], np.int32)
    port = tflint.key_to_float(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(_bits(port), _bits(jflint.key_to_float_np(keys)))
    again = tflint.float_to_key(torch.from_numpy(port)).numpy()
    np.testing.assert_array_equal(again, jflint.float_to_key_np(port))


def test_keys_preserve_order_of_finite_floats():
    f = _patterns(2)
    f = np.unique(f[np.isfinite(f)])  # sorted, -0.0 and +0.0 merged
    keys = tflint.float_to_key(torch.from_numpy(f)).numpy()
    assert np.all(np.diff(keys.astype(np.int64)) > 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int32_numpy_keys_bit_equal_to_the_jax_packages(seed):
    """The port's numpy keys, computed in int32 arithmetic, against the JAX
    package's int64 round trip: every special pattern (the sign bit alone,
    -0.0's 0x80000000, included), a sweep of each pattern's neighbours, and
    seeded random bits, flat, as cache rows and as one scalar."""
    rng = np.random.default_rng(seed)
    near = (_SPECIAL[:, None].astype(np.int64) + np.arange(-2, 3)) % 2 ** 32
    bits = np.concatenate([_SPECIAL, near.ravel().astype(np.uint32),
                           rng.integers(0, 2 ** 32, 1 << 16, dtype=np.uint64).astype(np.uint32)])
    f = bits.view(np.float32)
    port = tflint.float_to_key_np(f)
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, jflint.float_to_key_np(f))
    rows = f[:87 * (len(f) // 87)].reshape(-1, 87)
    np.testing.assert_array_equal(tflint.float_to_key_np(rows), jflint.float_to_key_np(rows))
    assert int(tflint.float_to_key_np(np.float32(-0.0))) == 0
    for b in _SPECIAL.tolist():
        x = np.array(b, np.uint32).view(np.float32)
        assert int(tflint.float_to_key_np(x)) == int(jflint.float_to_key_np(x))
