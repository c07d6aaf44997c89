"""Port: B3 (hopper_kernels.groupby_sum_outer) and
aggregate.groupby_sum_bounded against the JAX package, whose Pallas
kernel runs in interpret mode here. Counts are exact; float32 sums are
held to the reference's own bound, rtol 2e-6 / atol 1e-3
(tests/test_pallas_kernels.py), since the port accumulates in another
order (float64 then one rounding) than the reference's limb matmul."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops.aggregate import groupby_sum_bounded as jax_groupby
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_groupby_sum_outer

from spark_rapids_jni_tpu_torch.ops.aggregate import groupby_sum_bounded
from spark_rapids_jni_tpu_torch.ops.hopper_kernels import groupby_sum_outer, groupby_sum_outer_plain

RTOL, ATOL = 2e-6, 1e-3


def _both(keys, vals, num_keys):
    js, jc = pallas_groupby_sum_outer(
        jnp.asarray(keys, jnp.int64), jnp.asarray(vals), num_keys, interpret=True
    )
    ps, pc = groupby_sum_outer(torch.from_numpy(keys.astype(np.int64)),
                               torch.from_numpy(vals), num_keys)
    return np.asarray(js), np.asarray(jc), ps, pc


@pytest.mark.parametrize(
    "n,num_keys", [(5000, 4096), (300, 7), (40000, 130), (2048, 16384), (3000, 65536)]
)
def test_groupby_sum_outer_matches_jax(rng, n, num_keys):
    keys = rng.integers(-5, num_keys + 5, n)
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    js, jc, ps, pc = _both(keys, vals, num_keys)
    assert ps.dtype == torch.float32 and pc.dtype == torch.int64
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_allclose(ps.numpy(), js, rtol=RTOL, atol=ATOL)
    ind = (keys >= 0) & (keys < num_keys)
    want = np.bincount(keys[ind], weights=vals[ind].astype(np.float64), minlength=num_keys)
    np.testing.assert_allclose(ps.numpy(), want, rtol=RTOL, atol=ATOL)


def test_int64_keys_past_2_32_and_negative_dropped():
    keys = np.asarray([0, 1, 2**32, -3, 2**32 + 1, 2**40], np.int64)
    vals = np.asarray([1.0, 2.0, 100.0, 200.0, 300.0, 400.0], np.float32)
    js, jc, ps, pc = _both(keys, vals, 4)
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(pc.numpy(), [1, 1, 0, 0])
    np.testing.assert_allclose(ps.numpy(), [1.0, 2.0, 0.0, 0.0])
    np.testing.assert_allclose(ps.numpy(), js)


def test_empty_input():
    keys = np.zeros((0,), np.int64)
    vals = np.zeros((0,), np.float32)
    js, jc, ps, pc = _both(keys, vals, 4)
    np.testing.assert_array_equal(ps.numpy(), np.zeros(4, np.float32))
    np.testing.assert_array_equal(pc.numpy(), np.zeros(4, np.int64))
    np.testing.assert_array_equal(ps.numpy(), js)


def test_limb_precision_case(rng):
    # values where one bf16 rounding would corrupt the sum: the port must
    # keep f32-class accuracy as the reference's 3-limb split does
    keys = np.zeros(1000, np.int64)
    vals = (1.0 + rng.random(1000) * 1e-4).astype(np.float32)
    js, _, ps, pc = _both(keys, vals, 4)
    want = float(np.sum(vals.astype(np.float64)))
    assert abs(float(ps[0]) - want) / want < 1e-6
    np.testing.assert_allclose(ps.numpy(), js, rtol=RTOL, atol=ATOL)
    assert int(pc[0]) == 1000


def test_rejects_large_domain():
    with pytest.raises(ValueError, match="num_keys"):
        groupby_sum_outer(torch.zeros(8, dtype=torch.int64), torch.zeros(8), 65537)


def test_plain_is_the_cpu_path(rng):
    keys = torch.from_numpy(rng.integers(0, 64, 1000))
    vals = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    a = groupby_sum_outer(keys, vals, 64)
    b = groupby_sum_outer_plain(keys, vals, 64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n,num_keys", [(5000, 4096), (40000, 130), (3000, 65536), (100, 70000)])
def test_groupby_sum_bounded_float_matches_jax(rng, n, num_keys):
    keys = rng.integers(-5, num_keys + 5, n).astype(np.int64)
    vals = rng.standard_normal(n).astype(np.float32)
    js, jc = jax_groupby(jnp.asarray(keys), jnp.asarray(vals), num_keys)
    ps, pc = groupby_sum_bounded(torch.from_numpy(keys), torch.from_numpy(vals), num_keys)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "np_dt", [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64]
)
def test_groupby_sum_bounded_integer_exact(rng, np_dt):
    n, num_keys = 3000, 37
    keys = rng.integers(-3, num_keys + 3, n).astype(np.int64)
    info = np.iinfo(np_dt)
    vals = rng.integers(info.min, info.max, n, dtype=np_dt)
    js, jc = jax_groupby(jnp.asarray(keys), jnp.asarray(vals), num_keys)
    ps, pc = groupby_sum_bounded(torch.from_numpy(keys), torch.from_numpy(vals), num_keys)
    assert ps.dtype == torch.int64
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).view(np.int64))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))

