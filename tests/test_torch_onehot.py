"""Port: B2 (hopper_kernels.groupby_sum_bounded, the one-hot bounded GROUP
BY SUM) against the JAX package's ``pallas_groupby_sum_bounded``, whose
Pallas body runs in interpret mode here. The reference's own cases
(tests/test_pallas_kernels.py) and its tolerance, rtol/atol 1e-4, plus
K = 1 and K = 4096 with INT32 and INT64 keys."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_groupby_sum_bounded

from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

TOL = 1e-4  # the reference's bound for its one-hot kernel


def _both(keys, vals, num_keys):
    want = np.asarray(pallas_groupby_sum_bounded(jnp.asarray(keys), jnp.asarray(vals), num_keys,
                                                 interpret=True))
    got = hk.groupby_sum_bounded(torch.from_numpy(keys), torch.from_numpy(vals), num_keys)
    assert got.dtype == torch.float32 and got.shape == (num_keys,)
    return want, got.numpy()


def test_parity_reference_case(rng):
    keys = rng.integers(0, 50, 5000).astype(np.int64)
    vals = rng.standard_normal(5000).astype(np.float32)
    want, got = _both(keys, vals, 50)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    oracle = np.bincount(keys, weights=vals, minlength=50).astype(np.float32)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
@pytest.mark.parametrize("n,num_keys", [(5000, 4096), (300, 1), (3000, 130), (2048, 4096),
                                        (700, 7), (1, 4096)])
def test_matches_jax_interpret(rng, n, num_keys, np_dt):
    keys = rng.integers(-5, num_keys + 5, n).astype(np_dt)
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    want, got = _both(keys, vals, num_keys)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    ind = (keys >= 0) & (keys < num_keys)
    oracle = np.bincount(keys[ind], weights=vals[ind].astype(np.float64), minlength=num_keys)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


def test_int64_keys_past_2_32_dropped():
    keys = np.asarray([0, 1, 2**32, 2**32 + 1, -1, 2**40], np.int64)
    vals = np.asarray([1.0, 2.0, 100.0, 200.0, 300.0, 400.0], np.float32)
    want, got = _both(keys, vals, 4)
    np.testing.assert_allclose(got, [1.0, 2.0, 0.0, 0.0])
    np.testing.assert_allclose(got, want)


@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_empty_input(np_dt):
    want, got = _both(np.zeros((0,), np_dt), np.zeros((0,), np.float32), 4)
    np.testing.assert_array_equal(got, np.zeros(4, np.float32))
    np.testing.assert_array_equal(got, want)


def test_values_cast_to_float32_first(rng):
    # the reference casts vals to float32 before summing; a float64 value
    # that float32 cannot hold rounds before it is added
    keys = np.zeros(3, np.int64)
    vals = np.asarray([1.0 + 2.0 ** -30, 1.0 + 2.0 ** -30, 3.0], np.float64)
    want, got = _both(keys, vals, 1)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(5.0)


def test_rejects_large_domain():
    with pytest.raises(ValueError, match="num_keys"):
        hk.groupby_sum_bounded(torch.zeros(8, dtype=torch.int32), torch.zeros(8), 4097)
    with pytest.raises(ValueError, match="num_keys"):
        pallas_groupby_sum_bounded(jnp.zeros((8,), jnp.int32), jnp.zeros((8,)), 4097)


def test_rejects_float_keys():
    with pytest.raises(ValueError, match="integers"):
        hk.groupby_sum_bounded(torch.zeros(8), torch.zeros(8), 4)


def test_plain_is_the_cpu_path(rng):
    keys = torch.from_numpy(rng.integers(-3, 70, 1000))
    vals = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    before = hk.groupby_sum_bounded.launches
    assert torch.equal(hk.groupby_sum_bounded(keys, vals, 64),
                       hk.groupby_sum_bounded_plain(keys, vals, 64))
    assert hk.groupby_sum_bounded.launches == before  # no launch on the CPU


def test_agrees_with_b3_sums(rng):
    keys = torch.from_numpy(rng.integers(-5, 4101, 20_000))
    vals = torch.from_numpy((rng.standard_normal(20_000) * 100).astype(np.float32))
    s3, _ = hk.groupby_sum_outer(keys, vals, 4096)
    assert torch.equal(hk.groupby_sum_bounded(keys, vals, 4096), s3)


def _bincount(keys, vals, num_keys):
    ind = (keys >= 0) & (keys < num_keys)
    return np.bincount(keys[ind], weights=vals[ind].astype(np.float64),
                       minlength=num_keys).astype(np.float32)


@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("num_keys", [0, 1])
def test_plain_tiny_domains_match_bincount(rng, np_dt, n, num_keys):
    keys = rng.integers(-2, 3, n).astype(np_dt)
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    got = hk.groupby_sum_bounded_plain(torch.from_numpy(keys), torch.from_numpy(vals), num_keys)
    assert got.dtype == torch.float32 and got.shape == (num_keys,)
    np.testing.assert_allclose(got.numpy(), _bincount(keys, vals, num_keys), rtol=TOL, atol=TOL)


# (bin, value) pairs written into the values: a NaN bin, +inf and -inf
# bins, a bin where +inf meets -inf (NaN), a NaN beside an inf
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
@pytest.mark.parametrize("specials", [
    [(1, np.nan)], [(2, np.inf)], [(3, -np.inf)], [(4, np.inf), (4, -np.inf)],
    [(5, np.nan), (5, np.inf)], [(0, np.inf), (1, -np.inf), (2, np.nan)]])
def test_plain_nan_and_inf_bins_match_bincount(rng, np_dt, specials):
    keys = rng.integers(-1, 9, 2000).astype(np_dt)
    vals = (rng.standard_normal(2000) * 100).astype(np.float32)
    for i, (key, special) in enumerate(specials):
        vals[np.flatnonzero(keys == key)[i]] = special  # i: the pairs' rows differ
    got = hk.groupby_sum_bounded_plain(torch.from_numpy(keys), torch.from_numpy(vals), 8)
    want = _bincount(keys, vals, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL, equal_nan=True)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
