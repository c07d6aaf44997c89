"""Port: unsigned-word helpers (spark_rapids_jni_tpu_torch.ops.uword)
against numpy's uint32/uint64 arithmetic, including values >= 2^31 and
>= 2^63."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.ops import uword


def _u32(rng, n=4096):
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    x[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    return x


def _u64(rng, n=4096):
    x = rng.integers(0, 2**64, n, dtype=np.uint64)
    x[:5] = [0, 2**32 - 1, 2**32, 2**63, 2**64 - 1]
    return x


def _t32(x):
    return torch.from_numpy(x.view(np.int32).copy())


def _t64(x):
    return torch.from_numpy(x.view(np.int64).copy())


def _np32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [0, 1, 7, 8, 16, 24, 31])
def test_shr_u32_int_shift(rng, k):
    x = _u32(rng)
    np.testing.assert_array_equal(_np32(uword.shr_u32(_t32(x), k)), x >> np.uint32(k))


@pytest.mark.parametrize("k", [0, 1, 8, 13, 24, 31])
def test_shl_u32_wraps(rng, k):
    x = _u32(rng)
    np.testing.assert_array_equal(_np32(uword.shl_u32(_t32(x), k)), x << np.uint32(k))


def test_shifts_with_tensor_amounts(rng):
    x = _u32(rng)
    k = rng.integers(0, 32, x.shape[0]).astype(np.uint32)
    tk = torch.from_numpy(k.astype(np.int64))
    np.testing.assert_array_equal(_np32(uword.shr_u32(_t32(x), tk)), x >> k)
    np.testing.assert_array_equal(_np32(uword.shl_u32(_t32(x), tk)), x << k)


def test_u32_to_i64(rng):
    x = _u32(rng)
    got = uword.u32_to_i64(_t32(x)).numpy()
    np.testing.assert_array_equal(got, x.astype(np.int64))
    assert got.min() >= 0


def test_split_and_join_u64(rng):
    x = _u64(rng)
    lo, hi = uword.split_u64(_t64(x))
    np.testing.assert_array_equal(_np32(lo), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    np.testing.assert_array_equal(_np32(hi), (x >> np.uint64(32)).astype(np.uint32))
    back = uword.join_u64(lo, hi).numpy().view(np.uint64)
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_ucmp64_is_the_unsigned_order(rng, op):
    import operator

    x, y = _u64(rng), _u64(rng)
    y[5:9] = x[5:9]  # some equal pairs
    fn = getattr(operator, op)
    np.testing.assert_array_equal(uword.ucmp64(fn, _t64(x), _t64(y)).numpy(), fn(x, y))
    # a Python int operand holds its bits (u64_bits), as the limits do
    for v in (0, 2**63 - 1, 2**63, 2**64 - 1):
        np.testing.assert_array_equal(uword.ucmp64(fn, _t64(x), uword.u64_bits(v)).numpy(),
                                      fn(x, np.uint64(v)))


def test_u64_bits():
    for v in (0, 1, 2**63 - 1, 2**63, 2**64 - 1):
        assert uword.u64_bits(v) == int(np.array(v, np.uint64).view(np.int64))


@pytest.mark.parametrize("k", [0, 1, 13, 32, 63])
def test_shr_u64(rng, k):
    x = _u64(rng)
    np.testing.assert_array_equal(uword.shr_u64(_t64(x), k).numpy().view(np.uint64),
                                  x >> np.uint64(k))
    tk = torch.full((x.shape[0],), k, dtype=torch.int64)
    np.testing.assert_array_equal(uword.shr_u64(_t64(x), tk).numpy().view(np.uint64),
                                  x >> np.uint64(k))


def test_i64_i32_pair_reinterpretation(rng):
    x = _u64(rng).reshape(64, 64)
    pairs = uword.i64_as_i32_pairs(_t64(x))
    assert pairs.shape == (64, 64, 2) and pairs.dtype == torch.int32
    np.testing.assert_array_equal(pairs.numpy().view(np.uint32).reshape(64, 128),
                                  x.view(np.uint32))
    np.testing.assert_array_equal(uword.i32_pairs_as_i64(pairs).numpy().view(np.uint64), x)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_to_signed_bits_matches_numpy_wrap(rng, bits):
    x = _u64(rng)
    got = uword.to_signed_bits(_t64(x), bits).numpy()
    want = x.astype({8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]).view(got.dtype)
    np.testing.assert_array_equal(got, want)
