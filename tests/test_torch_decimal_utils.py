"""Port: ops/decimal_utils against the JAX package's. Every case of
``test_decimal_utils.py`` (the reference's DecimalUtilsTest battery, the
SPARK-40129 cases and div17/div21 among them) runs through both packages,
then seeded sweeps of 1-38 digit operands with nulls and zero divisors
through multiply128 and the three regimes of divide128. The overflow
flags, the result limbs, the validity and the result type must be equal
exactly (integers: tolerance 0); the sweeps are also held against the
Python-int transcription of dec128_multiplier / dec128_divider that
``chip_smoke.py`` checks the card with."""

import decimal

import numpy as np
import pytest

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import decimal_utils as JD

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import decimal_utils as PD

import chip_smoke

CTX = decimal.Context(prec=100)  # 38-digit literals must not round
ROWS = 48


def _unscaled(strings):
    decs = [CTX.create_decimal(v) for v in strings]
    exp = min(d.as_tuple().exponent for d in decs)
    return [int(d.scaleb(-exp, CTX)) for d in decs], exp


def _columns(values, scale, valid=None):
    """The same DECIMAL128 column in both packages (None is null)."""
    vals = [None if valid is not None and not ok else v for v, ok in
            zip(values, valid if valid is not None else [True] * len(values))]
    return (JColumn.from_pylist(vals, jdt.decimal128(scale)),
            Column.from_pylist(vals, pdt.decimal128(scale), device="cpu"))


def _same(got, want):
    assert got.names == want.names
    for g, w in zip(got.columns, want.columns):
        assert int(g.dtype.id) == int(w.dtype.id) and g.dtype.scale == w.dtype.scale
        np.testing.assert_array_equal(g.data.numpy().view(np.uint8),
                                      np.asarray(w.data).view(np.uint8))
        gv = None if g.validity is None else g.validity.numpy()
        wv = None if w.validity is None else np.asarray(w.validity)
        if gv is None or wv is None:
            assert gv is None and wv is None
        else:
            np.testing.assert_array_equal(gv, wv)


# name -> (op, a, b, result scale, expected overflow, expected results);
# the cases of test_decimal_utils.py
CASES = {
    "pos_multiply_one_by_zero": ("multiply128", ["1.0", "10.0", "1000000000000000000000000000000000000.0"],
                                 ["1", "1", "1"], -1, [0, 0, 0],
                                 ["1.0", "10.0", "1000000000000000000000000000000000000.0"]),
    "pos_multiply_one_by_one": ("multiply128", ["1.0", "3.7"], ["1.0", "1.5"], -1, [0, 0],
                                ["1.0", "5.6"]),
    "pos_multiply_zero_by_neg_one": ("multiply128", ["1"], ["1e1"], -1, [0], ["10.0"]),
    "large_pos_multiply_ten_by_ten": ("multiply128", ["577694940161436285811555447.3103121126"],
                                      ["100.0000000000"], -6, [0],
                                      ["57769494016143628581155544731.031211"]),
    "overflow_mult": ("multiply128", ["577694938495380589068894346.7625198736"],
                      ["-1258508260891400005608241690.1564700995"], -6, [1], ["0"]),
    "neg_multiply": ("multiply128", ["1.0", "-1.0", "10.0"], ["-1", "1", "-1"], -1, [0, 0, 0],
                     ["-1.0", "-1.0", "-10.0"]),
    "neg_multiply_one_by_one": ("multiply128", ["1.0", "-1.0", "3.7"], ["-1.0", "-1.0", "-1.5"], -1,
                                [0, 0, 0], ["-1.0", "1.0", "-5.6"]),
    "spark_compat_multiply": ("multiply128",
                              ["3358377338823096511784947656.4650294583",
                               "7161021785186010157110137546.5940777916",
                               "9173594185998001607642838421.5479932913"],
                              ["-12.0000000000", "-12.0000000000", "-12.0000000000"], -6, [0, 0, 0],
                              ["-40300528065877158141419371877.580354",
                               "-85932261422232121885321650559.128933",
                               "-110083130231976019291714061058.575920"]),
    "pos_div_with_zero": ("divide128", ["1.0", "10.0", "1.0", "1000000000000000000000000000000000000.0"],
                          ["1", "2", "0", "5"], -1, [0, 0, 1, 0],
                          ["1.0", "5.0", "0", "200000000000000000000000000000000000.0"]),
    "pos_div_one_by_one": ("divide128", ["1.0", "3.7", "99.9"], ["1.0", "1.5", "4.5"], -1, [0, 0, 0],
                           ["1.0", "2.5", "22.2"]),
    "neg_div_one_by_one": ("divide128", ["1.0", "-3.7", "-99.9"], ["-1.0", "1.5", "-4.5"], -1,
                           [0, 0, 0], ["-1.0", "-2.5", "22.2"]),
    "div_complex": ("divide128", ["100000000000000000000000000000000"],
                    ["3.0000000000000000000000000000000000000"], -6, [0],
                    ["33333333333333333333333333333333.333333"]),
    "div17": ("divide128", ["1454.48287885760884146", "3655.54438423288356646"],
              ["100.00000000000000000", "100.00000000000000000"], -17, [0, 0],
              ["14.54482878857608841", "36.55544384232883566"]),
    "div17_with_pos_scale": ("divide128", ["1454.48287885760884146"], ["1e2"], -17, [0],
                             ["14.54482878857608841"]),
    "div21_with_pos_scale": ("divide128", ["5776949401614362.858115554473103121126"], ["1e2"], -6,
                             [0], ["57769494016143.628581"]),
    "div21": ("divide128",
              ["60250054953505368.439892586764888491018",
               "91910085134512953.335347579448489062875",
               "51312633107598808.869351260608653423886"],
              ["97982875273794447.385070145919990343867",
               "94478503341597285.814104936062234698349",
               "92266075543848323.800466593082956765923"], -6, [0, 0, 0],
              ["0.614904", "0.972815", "0.556138"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case_matches_jax(name):
    op, a_s, b_s, scale, overflow, results = CASES[name]
    a, sa = _unscaled(a_s)
    b, sb = _unscaled(b_s)
    # zero rows pad every case to the sweeps' row count: the JAX package
    # compiles once per shape and scales, so cases of equal scales share one
    pad = [0] * (ROWS - len(a))
    ja, pa = _columns(a + pad, sa)
    jb, pb = _columns(b + pad, sb)
    got = getattr(PD, op)(pa, pb, scale)
    _same(got, getattr(JD, op)(ja, jb, scale))
    assert got.columns[0].to_pylist()[:len(a)] == [bool(o) for o in overflow]
    want = [int(CTX.create_decimal(r).scaleb(-scale, CTX)) for r in results]
    for g, w, o in zip(got.columns[1].to_pylist(), want, overflow):
        if not o or op == "divide128":  # a zero divisor writes 0
            assert g == w


def test_null_propagation():
    pad = ROWS - 2  # the shape and scales of the cases above: no new JAX compile
    ja, pa = _columns([1000, 7] + [0] * pad, -1, valid=[True, False] + [True] * pad)
    jb, pb = _columns([15, 15] + [0] * pad, -1)
    got = PD.multiply128(pa, pb, -1)
    _same(got, JD.multiply128(ja, jb, -1))
    assert got.columns[0].to_pylist()[:2] == [False, None]
    assert got.columns[1].to_pylist()[:2] == [1500, None]


def test_scale_divisor_check_and_type_checks():
    _, pa = _columns([1], -20)
    with pytest.raises(ValueError, match="divisor too big"):
        PD.multiply128(pa, pa, 0)
    with pytest.raises(ValueError, match="DECIMAL128"):
        PD.divide128(Column.from_pylist([1], pdt.INT64, device="cpu"), pa, 0)


def _sweep(seed: int, n: int):
    """Operands of a seeded 1-38 digit count and sign, 5% nulls, about 6%
    zero divisors."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(1, 39, (2, n))
    vals = [[int(rng.integers(1, 10)) * 10 ** (int(k) - 1) + int(rng.integers(0, 10**min(int(k) - 1, 18)))
             * 10 ** max(int(k) - 19, 0) for k in row] for row in digits]
    a, b = ([-v if s else v for v, s in zip(row, rng.random(n) < 0.5)] for row in vals)
    b = [0 if z else v for v, z in zip(b, rng.random(n) < 0.06)]
    return a, b, rng.random(n) >= 0.05, rng.random(n) >= 0.05


# (op, a scale, b scale, result scale): multiply rescaling up and down;
# divide with n_shift_exp = 6 (> 0), -6 (in [-38, 0]) and -40 (< -38)
SWEEPS = [("multiply128", -10, -10, -6), ("multiply128", 0, 0, -4), ("multiply128", -20, -18, -2),
          ("divide128", -10, -2, -2), ("divide128", -10, -10, -6), ("divide128", 0, -30, -10)]


@pytest.mark.parametrize("op,sa,sb,scale", SWEEPS)
def test_seeded_sweep_matches_jax_and_the_oracle(op, sa, sb, scale):
    a, b, va, vb = _sweep(SWEEPS.index((op, sa, sb, scale)), ROWS)
    ja, pa = _columns(a, sa, va)
    jb, pb = _columns(b, sb, vb)
    got = getattr(PD, op)(pa, pb, scale)
    _same(got, getattr(JD, op)(ja, jb, scale))
    oracle = chip_smoke._dec_mul_oracle if op == "multiply128" else chip_smoke._dec_div_oracle
    overflow, result = got.columns[0].to_pylist(), got.columns[1].to_pylist()
    seen = set()
    for i in range(len(a)):
        if not (va[i] and vb[i]):
            assert overflow[i] is None and result[i] is None
            continue
        o, v = oracle(a[i], b[i], sa, sb, scale)
        assert overflow[i] == o, i
        if not o or b[i] == 0:
            assert result[i] == v, i
        seen.add(o)
    assert False in seen


@pytest.mark.slow
@pytest.mark.parametrize("op,sa,sb,scale", SWEEPS)
def test_large_seeded_sweep_matches_the_oracle(op, sa, sb, scale):
    a, b, va, vb = _sweep(100 + SWEEPS.index((op, sa, sb, scale)), 4000)
    _, pa = _columns(a, sa, va)
    _, pb = _columns(b, sb, vb)
    got = getattr(PD, op)(pa, pb, scale)
    oracle = chip_smoke._dec_mul_oracle if op == "multiply128" else chip_smoke._dec_div_oracle
    for i, (o, r) in enumerate(zip(got.columns[0].to_pylist(), got.columns[1].to_pylist())):
        if va[i] and vb[i]:
            wo, wv = oracle(a[i], b[i], sa, sb, scale)
            assert o == wo and (wo and b[i] != 0 or r == wv), i


@pytest.mark.parametrize("make", ["decimal32", "decimal64", "decimal128"])
def test_decimal_pylist_matches_jax(make):
    # ints are unscaled; decimal.Decimal values round half up to the scale
    vals = [0, -1, 12345, None, decimal.Decimal("-1.005"), decimal.Decimal("2.675"),
            decimal.Decimal("99.994")]
    if make == "decimal128":
        vals += [2**127 - 1, -(2**127), 10**38 - 1]
    want = JColumn.from_pylist(vals, getattr(jdt, make)(-2))
    got = Column.from_pylist(vals, getattr(pdt, make)(-2), device="cpu")
    assert got.dtype == getattr(pdt, make)(-2)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.validity.numpy(), np.asarray(want.validity))
    assert got.to_pylist() == want.to_pylist()
