"""Port: B6/B7 byte-plane relayouts and the flat word<->byte helpers
(spark_rapids_jni_tpu_torch.ops.ragged_bytes) against the JAX package,
whose Pallas kernels run in interpret mode here. All exact. On CPU
tensors the port's wrappers run the kernels' plain versions."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import ragged_bytes as jrb

from spark_rapids_jni_tpu_torch.ops import ragged_bytes as prb


def _t32(x):
    return torch.from_numpy(x.view(np.int32).copy())


@pytest.mark.parametrize("p,n", [(3, 16), (196, 40), (1, 8), (7, 515), (49, 600)])
def test_expand_u32_planes_matches_jax(rng, p, n):
    x = rng.integers(0, 2**32, (p, n), dtype=np.uint32)
    want = np.asarray(jrb.expand_u32_planes(jnp.asarray(x), interpret=True))
    got = prb.expand_u32_planes(_t32(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4 * p, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,n", [(3, 16), (196, 40), (1, 8), (7, 515), (49, 600)])
def test_pack_u8_planes_matches_jax(rng, p, n):
    x8 = rng.integers(0, 256, (4 * p, n), dtype=np.uint8)
    want = np.asarray(jrb.pack_u8_planes(jnp.asarray(x8), interpret=True))
    got = prb.pack_u8_planes(torch.from_numpy(x8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_pack_is_expand_inverse(rng):
    x = rng.integers(0, 2**32, (49, 600), dtype=np.uint32)
    back = prb.pack_u8_planes(prb.expand_u32_planes(_t32(x)))
    np.testing.assert_array_equal(back.numpy().view(np.uint32), x)


def test_wrappers_reject_wrong_types():
    with pytest.raises(ValueError):
        prb.expand_u32_planes(torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        prb.pack_u8_planes(torch.zeros((3, 4), dtype=torch.uint8))


@pytest.mark.parametrize("r,l", [(16, 3), (100, 196), (7, 1), (8, 1)])
def test_u32_rows_to_u8_flat_matches_jax(rng, r, l):
    x = rng.integers(0, 2**32, (r, l), dtype=np.uint32)
    want = np.asarray(jrb.u32_rows_to_u8_flat(jnp.asarray(x)))
    got = prb.u32_rows_to_u8_flat(_t32(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbytes", [0, 4, 508, 512, 2048, 5000])
def test_flat_u8_to_u32_matches_jax(rng, nbytes):
    buf = rng.integers(0, 256, nbytes, dtype=np.uint8)
    want = np.asarray(jrb.flat_u8_to_u32(jnp.asarray(buf)))
    got = prb.flat_u8_to_u32(torch.from_numpy(buf))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
