"""Port: ops/f64acc (exact FLOAT64 sums and means over IEEE bits) against
the JAX package, bit for bit. Inputs are made from a seed with numpy and
handed to both as the same bits (uint64 for the reference, int64 for the
port). Every exported function is held on the input classes where exact
accumulation is hard: empty input, no segments, all rows invalid, one
row, cancellation, subnormals, infinities and NaN, -0.0, magnitudes near
overflow, more segments than the masked-reduction branch takes, and
UINT64 sums past 2^63."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401  (turns on x64 before any jax use)
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import f64acc as jf

from spark_rapids_jni_tpu_torch.ops import f64acc as pf


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float64)).view(np.uint64)


def _values(case, rng, n):
    """(float64 values [n], valid [n] bool or None) of one input class."""
    if case == "normal":
        return rng.standard_normal(n) * 1e3, None
    if case == "valid_mask":
        return rng.standard_normal(n), rng.random(n) < 0.7
    if case == "all_invalid":
        return rng.standard_normal(n), np.zeros(n, bool)
    if case == "magnitudes":
        return rng.uniform(1, 10, n) * 10.0 ** rng.integers(-300, 300, n), None
    if case == "cancellation":
        base = np.array([1e16, 1.0, -1e16, 3.0, -1.0, 2.0 ** -60])
        return np.resize(base, n), None
    if case == "subnormals":
        sub = rng.integers(1, 1 << 52, n).view(np.float64) * np.where(rng.random(n) < 0.5, -1, 1)
        return sub, None
    if case == "inf":
        v = rng.standard_normal(n)
        v[::7] = np.inf
        return v, None
    if case == "ninf":
        v = rng.standard_normal(n)
        v[::5] = -np.inf
        return v, None
    if case == "inf_minus_inf":
        v = rng.standard_normal(n)
        v[0], v[-1] = np.inf, -np.inf
        return v, None
    if case == "nan":
        v = rng.standard_normal(n)
        v[::11] = np.nan
        v[1::13] = -np.nan
        return v, None
    if case == "negative_zero":
        return np.full(n, -0.0), None
    if case == "near_overflow":
        return np.where(rng.random(n) < 0.9, 1.7e308, -1.0e308) * rng.uniform(0.5, 1, n), None
    if case == "tiny_and_huge":
        v = rng.standard_normal(n) * 1e-310
        v[::3] = 1e300
        return v, None
    raise ValueError(case)


CASES = ["normal", "valid_mask", "all_invalid", "magnitudes", "cancellation", "subnormals", "inf",
         "ninf", "inf_minus_inf", "nan", "negative_zero", "near_overflow", "tiny_and_huge"]
# (rows, segments): the masked-reduction branch, index_add_ past 16
# segments, one row, and the same segment layout with few rows
SHAPES = [(997, 5), (1500, 41), (1, 1), (13, 3)]


def _both_sum(vals, valid, seg, g, mean=False):
    b = _bits(vals)
    jv = None if valid is None else jnp.asarray(valid)
    pv = None if valid is None else torch.from_numpy(valid)
    pb = torch.from_numpy(b.view(np.int64).copy())
    ps = torch.from_numpy(seg.astype(np.int32))
    if mean:
        jm, jc = jf.segment_mean_f64bits(jnp.asarray(b), jnp.asarray(seg, jnp.int32), g, valid=jv)
        pm, pc = pf.segment_mean_f64bits(pb, ps, g, valid=pv)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        return np.asarray(jm), pm.numpy().view(np.uint64)
    js = jf.segment_sum_f64bits(jnp.asarray(b), jnp.asarray(seg, jnp.int32), g, valid=jv)
    p = pf.segment_sum_f64bits(pb, ps, g, valid=pv)
    assert p.dtype == torch.int64
    return np.asarray(js), p.numpy().view(np.uint64)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}g{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_segment_sum_bit_identical(case, shape):
    n, g = shape
    rng = np.random.default_rng(100 * CASES.index(case) + n)
    vals, valid = _values(case, rng, n)
    seg = rng.integers(0, g, n)
    want, got = _both_sum(vals, valid, seg, g)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}g{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_segment_mean_bit_identical(case, shape):
    n, g = shape
    rng = np.random.default_rng(100 * CASES.index(case) + n + 7)
    vals, valid = _values(case, rng, n)
    seg = rng.integers(0, g, n)
    want, got = _both_sum(vals, valid, seg, g, mean=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("n,g", [(0, 3), (0, 0), (4, 0), (0, 20)])
def test_empty_input_and_no_segments(n, g, mean):
    vals = np.arange(n, dtype=np.float64)
    seg = np.zeros(n, np.int64)
    if g == 0 and n:
        # no segments: the reference returns [] whatever the rows
        got = (pf.segment_mean_f64bits if mean else pf.segment_sum_f64bits)(
            torch.from_numpy(_bits(vals).view(np.int64).copy()), torch.from_numpy(seg), 0)
        got = got[0] if mean else got
        assert got.shape == (0,)
        return
    want, got = _both_sum(vals, None, seg, g, mean=mean)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


def test_cancellation_is_exact():
    # the naive float64 sum of (1e16, 1, -1e16) is 0; the exact sum is 1
    seg = np.zeros(3, np.int64)
    _, got = _both_sum(np.array([1e16, 1.0, -1e16]), None, seg, 1)
    assert got.view(np.float64)[0] == 1.0


def test_negative_zero_sums_to_positive_zero():
    # the reference's one documented IEEE deviation, kept for parity
    want, got = _both_sum(np.array([-0.0, -0.0]), None, np.zeros(2, np.int64), 1)
    assert got[0] == 0 and want[0] == 0


def test_correctly_rounded_against_fractions(rng):
    from fractions import Fraction

    vals = rng.uniform(-1, 1, 500) * 10.0 ** rng.integers(-20, 20, 500)
    seg = rng.integers(0, 4, 500)
    _, got = _both_sum(vals, None, seg, 4)
    _, gmean = _both_sum(vals, None, seg, 4, mean=True)
    for k in range(4):
        exact = sum(Fraction(float(v)) for v in vals[seg == k])
        assert got.view(np.float64)[k] == float(exact)
        assert gmean.view(np.float64)[k] == float(exact / int((seg == k).sum()))


def test_small_and_index_add_branches_agree(rng, monkeypatch):
    vals = rng.standard_normal(800) * 10.0 ** rng.integers(-30, 30, 800)
    seg = torch.from_numpy(rng.integers(0, 9, 800))
    bits = torch.from_numpy(_bits(vals).view(np.int64).copy())
    small = pf.segment_sum_f64bits(bits, seg, 9)
    monkeypatch.setattr(pf, "SMALL_SEGMENTS", 0)
    assert torch.equal(pf.segment_sum_f64bits(bits, seg, 9), small)


INT_CASES = {
    "random": lambda rng: rng.integers(-(2**63), 2**63 - 1, 300, dtype=np.int64),
    "small": lambda rng: rng.integers(-1000, 1000, 300, dtype=np.int64),
    "edges": lambda rng: np.array([0, 1, -1, 2**53, 2**53 + 1, -(2**53) - 1, 2**63 - 1,
                                   -(2**63), 2**62 + 2**9, 2**62 + 2**10 + 1], np.int64),
    "near_2_53": lambda rng: (2**53 + rng.integers(-64, 64, 300)).astype(np.int64),
}


@pytest.mark.parametrize("case", sorted(INT_CASES))
def test_i64_to_f64bits_bit_identical(case, rng):
    x = INT_CASES[case](rng)
    want = np.asarray(jf.i64_to_f64bits(jnp.asarray(x)))
    got = pf.i64_to_f64bits(torch.from_numpy(x)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(np.float64), x.astype(np.float64))


U64_CASES = {
    "random": lambda rng: rng.integers(0, 2**64 - 1, 300, dtype=np.uint64, endpoint=True),
    "past_2_63": lambda rng: (np.uint64(2**63) + rng.integers(0, 2**62, 300).astype(np.uint64)),
    "edges": lambda rng: np.array([0, 1, 2**53, 2**53 + 1, 2**63 - 1, 2**63, 2**64 - 1,
                                   2**64 - 2**11, 2**64 - 2**10 - 1], np.uint64),
}


@pytest.mark.parametrize("case", sorted(U64_CASES))
def test_u64_to_f64bits_bit_identical(case, rng):
    x = U64_CASES[case](rng)
    want = np.asarray(jf.u64_to_f64bits(jnp.asarray(x)))
    got = pf.u64_to_f64bits(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(np.float64), x.astype(np.float64))


MEAN_CASES = {
    "random": lambda rng: (rng.integers(-(2**62), 2**62, 200), rng.integers(1, 2**31, 200)),
    "small_counts": lambda rng: (rng.integers(-10**6, 10**6, 200), rng.integers(1, 8, 200)),
    "zero_count": lambda rng: (rng.integers(-5, 5, 20), np.zeros(20, np.int64)),
    "edges": lambda rng: (np.array([2**63 - 1, -(2**63), 0, 1, -1, 7, 2**53 + 1], np.int64),
                          np.array([3, 7, 5, 3, 3, 2**31 - 1, 2], np.int64)),
}


@pytest.mark.parametrize("case", sorted(MEAN_CASES))
def test_mean_i64_div_bit_identical(case, rng):
    sums, cnt = MEAN_CASES[case](rng)
    sums, cnt = sums.astype(np.int64), cnt.astype(np.int64)
    want = np.asarray(jf.mean_i64_div(jnp.asarray(sums), jnp.asarray(cnt)))
    got = pf.mean_i64_div(torch.from_numpy(sums), torch.from_numpy(cnt)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["past_2_63", "random"])
def test_mean_i64_div_unsigned_bit_identical(case, rng):
    sums = U64_CASES[case](rng)
    cnt = rng.integers(1, 2**31, sums.shape[0]).astype(np.int64)
    want = np.asarray(jf.mean_i64_div(jnp.asarray(sums), jnp.asarray(cnt), unsigned=True))
    got = pf.mean_i64_div(torch.from_numpy(sums.view(np.int64)), torch.from_numpy(cnt),
                          unsigned=True).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["normal", "magnitudes", "subnormals", "inf", "nan",
                                  "negative_zero", "near_overflow"])
def test_div_f64bits_by_int_bit_identical(case, rng):
    vals, _ = _values(case, rng, 200)
    cnt = rng.integers(1, 2**31, 200).astype(np.int64)
    cnt[:5] = [1, 2, 3, 7, 10]
    b = _bits(vals)
    want = np.asarray(jf.div_f64bits_by_int(jnp.asarray(b), jnp.asarray(cnt)))
    got = pf.div_f64bits_by_int(torch.from_numpy(b.view(np.int64).copy()),
                                torch.from_numpy(cnt)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    finite = np.isfinite(vals)
    np.testing.assert_array_equal(got.view(np.float64)[finite], vals[finite] / cnt[finite])


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(6))
def test_segment_sum_sweep(seed):
    rng = np.random.default_rng(seed)
    n, g = 20_000, int(rng.integers(1, 60))
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-200, 200, n)
    valid = rng.random(n) < 0.8
    seg = rng.integers(0, g, n)
    for mean in (False, True):
        want, got = _both_sum(vals, valid, seg, g, mean=mean)
        np.testing.assert_array_equal(got, want)
