"""Port: ops/cast_decimal (string -> DECIMAL32/64/128) against the JAX
package's. Every golden of ``test_cast_decimal.py`` (the reference's
cast_string.cpp StringToDecimalTests) runs through both packages, with
ANSI errors, empty columns, incoming nulls and the type dispatch by
precision; then a seeded battery of 1-38 digit values in plain and
exponent notation, with more fractional digits than the scale. The
unscaled values, validity and type must be equal bit for bit (integers:
tolerance 0); ANSI mode must raise the port's CastError with the JAX
package's row and string."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import cast_string as JC

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import cast_string as PC


def _columns(strings, in_validity=None):
    jc = JColumn.from_pylist(strings, jdt.STRING)
    pc = Column.from_pylist(strings, pdt.STRING, device="cpu")
    if in_validity is not None:
        v = np.array(in_validity, bool)
        jc = JColumn(jdt.STRING, validity=jnp.asarray(v), offsets=jc.offsets, chars=jc.chars)
        pc = Column(pdt.STRING, validity=torch.from_numpy(v), offsets=pc.offsets, chars=pc.chars)
    return jc, pc


def _same(got, want):
    assert int(got.dtype.id) == int(want.dtype.id) and got.dtype.scale == want.dtype.scale
    g, w = got.data.numpy(), np.asarray(want.data)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    gv = None if got.validity is None else got.validity.numpy()
    wv = None if want.validity is None else np.asarray(want.validity)
    if gv is None or wv is None:
        assert gv is None and wv is None
    else:
        np.testing.assert_array_equal(gv, wv)


def _cast(strings, precision, scale, ansi=False, in_validity=None):
    jc, pc = _columns(strings, in_validity)
    got = PC.string_to_decimal(pc, ansi, precision, scale)
    _same(got, JC.string_to_decimal(jc, ansi, precision, scale))
    return got


# name -> (strings, precision, scale, expected unscaled or None): the
# goldens of test_cast_decimal.py
CASES = {
    "simple": (["1", "0", "-1"], 1, 0, [1, 0, -1]),
    "overprecise": (["123456", "999999", "-123456", "-999999"], 5, 0, [None] * 4),
    "rounding": (["1.23456", "9.99999", "-1.23456", "-9.99999"], 5, -4,
                 [12346, None, -12346, None]),
    "decimal_values": (["1.234", "0.12345", "-1.034", "-0.001234567890123456"], 6, -5,
                       [123400, 12345, -103400, -123]),
    "exponential_notation": (["1.234e-1", "0.12345e1", "-1.034e-2", "-0.001234567890123456e2"],
                             6, -5, [12340, 123450, -1034, -12346]),
    "positive_scale": (["1234e-1", "12345e1", "-1234.5678", "-0.001234567890123456e6"], 6, 2,
                       [1, 1235, -12, -12]),
    "positive_scale_battery": (
        ["813847339", "043469773", "548977048", "985946604", "325679554", "null",
         "957413342", "541903389", "150050891", "663968655", "976832602",
         "757172936", "968693314", "106046331", "965120263", "354546567",
         "108127101", "339513621", "980338159", "593267777"], 8, 3,
        [813847, 43470, 548977, 985947, 325680, None, 957413, 541903, 150051,
         663969, 976833, 757173, 968693, 106046, 965120, 354547, 108127,
         339514, 980338, 593268]),
    "edge_38_digits": (["123456789012345678901234567890123456.01"], 38, -2,
                       [(123456789012345678 * 10**15 + 901234567890123) * 100000 + 45601]),
    "edge_small_exponent": (["8.483315330475049E-4"], 15, -1, [0]),
    "edge_rounds_up": (["8.483315330475049E-2"], 15, -1, [1]),
    "edge_negative_exponent_overflow": (["-1.0E14"], 15, -1, [None]),
    "edge_negative_exponent_fits": (["-1.0E14"], 16, -1, [-1_000_000_000_000_000]),
    "edge_exponent_pads": (["8.575859E8"], 15, -1, [8575859000]),
    "edge_ten": (["10.0"], 3, -1, [100]),
    "edge_nine_digits": (["1.7142857343"], 9, -8, [171428573]),
    "edge_long_fraction": (["1.71428573437482136712623"], 9, -8, [171428573]),
    "edge_long_fraction_overflow": (["1.71428573437482136712623"], 9, -9, [None]),
    "edge_too_many_integer_digits": (["12.345678901"], 9, -8, [None]),
    "edge_fraction_rounds": (["0.12345678901"], 6, -6, [123457]),
    "edge_fraction_overflow": (["1.2345678901"], 6, -6, [None]),
    "edge_not_numbers": (["NaN", "inf", "-inf", "0"], 6, 0, [None, None, None, 0]),
    "edge_positive_scale_rounds": (["1234567809"], 8, 3, [1234568]),
    "edge_positive_scale_pair": (["4347202159", "4347802159"], 4, 6, [4347, 4348]),
    "whitespace_and_signs": (["  1.5 ", "+2.5", "-  1", "1e", "1e2 "], 5, -1,
                             [15, 25, None, 10, None]),
    "decimal128_large_values": ([str(10**37 - 1), "-" + str(10**37 - 1)], 38, 0,
                                [10**37 - 1, -(10**37 - 1)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_golden_matches_jax(name):
    strings, precision, scale, want = CASES[name]
    assert _cast(strings, precision, scale).to_pylist() == want


@pytest.mark.parametrize("precision,tid", [(9, "DECIMAL32"), (10, "DECIMAL64"), (18, "DECIMAL64"),
                                           (19, "DECIMAL128")])
def test_type_dispatch_by_precision(precision, tid):
    assert _cast(["1"], precision, 0).dtype.id == getattr(pdt.TypeId, tid)


def test_empty():
    got = _cast([], 8, 2)
    assert len(got) == 0 and got.dtype.id == pdt.TypeId.DECIMAL32 and got.dtype.scale == 2
    got = _cast([], 30, -3)
    assert tuple(got.data.shape) == (0, 4)


def test_ansi_raises_the_first_error():
    jc, pc = _columns(["1", "bad", "2", "worse"])
    with pytest.raises(JC.CastError) as want:
        JC.string_to_decimal(jc, True, 5, 0)
    with pytest.raises(PC.CastError) as got:
        PC.string_to_decimal(pc, True, 5, 0)
    assert got.value.row_with_error == want.value.row_with_error == 1
    assert got.value.string_with_error == want.value.string_with_error == "bad"


def test_incoming_nulls_are_not_ansi_errors():
    got = _cast(["1.5", "bad", "-2.25"], 5, -2, ansi=True, in_validity=[1, 0, 1])
    assert got.to_pylist() == [150, None, -225]


def _battery(seed: int, n: int):
    """Seeded decimal strings: 1-38 significant digits, a sign, a decimal
    point anywhere, some in exponent notation, some with whitespace."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 39))
        digits = "".join(str(int(d)) for d in rng.integers(0, 10, k))
        point = int(rng.integers(0, k + 1))
        s = digits[:point] + "." + digits[point:] if rng.random() < 0.7 else digits
        if rng.random() < 0.25:
            s += ("e" if rng.random() < 0.5 else "E") + str(int(rng.integers(-20, 21)))
        if rng.random() < 0.4:
            s = "-" + s
        if rng.random() < 0.1:
            s = " " + s + "  "
        out.append(s)
    return out


@pytest.mark.parametrize("precision,scale", [(38, -10), (18, -4), (9, -2)])
def test_seeded_battery_matches_jax(precision, scale):
    strings = _battery(precision, 64)
    valid = [i % 17 != 3 for i in range(len(strings))]
    _cast(strings, precision, scale, in_validity=valid)


# A fault of the reference (ROADMAP.md section 3), pinned, not fixed: where
# an exponent puts the decimal location below 0 and the rounding carries
# into a new digit, the reference counts that digit before the decimal
# point and pads one zero too many, so its result is ten times Spark's
# (Spark casts "9.5e-10" to DECIMAL(38, 10) as 0.0000000010, unscaled 10).
# A plain string of the same value ("0.00000000095") rounds correctly.
@pytest.mark.parametrize("s,precision,scale,spark,reference", [
    ("9.5e-10", 38, -10, 10, 100),
    ("-0.951E-3", 18, -4, -10, -100),
    ("98.6913442836e-3", 9, -2, 10, 100),
    ("0.00000000095", 38, -10, 10, 10),
])
def test_reference_fault_rounding_carry_below_the_decimal_point(s, precision, scale, spark,
                                                                reference):
    assert _cast([s], precision, scale).to_pylist() == [reference]
    assert (spark == reference) == ("e" not in s.lower())


@pytest.mark.parametrize("precision,scale", [(38, -10), (18, -4), (9, -2)])
def test_chip_smoke_oracle_agrees_with_the_port(precision, scale):
    # the independent oracle chip_smoke.py holds the card to (Spark's
    # rounding in Python ints): equal on every row outside the reference's
    # pinned fault above, and the fault's rows ten times Spark's value
    import chip_smoke

    strings, valid, parsed = chip_smoke._dec_strings(np.random.default_rng(precision), 3000)
    col = Column.from_pylist(strings, pdt.STRING, device="cpu")
    col.validity = torch.from_numpy(valid)
    want, ok, fault = chip_smoke._dec_oracle(valid, parsed, precision, scale)
    got = PC.string_to_decimal(col, False, precision, scale).to_pylist()
    assert got == [(10 * w if f else w) if k else None for w, k, f in zip(want, ok, fault)]
