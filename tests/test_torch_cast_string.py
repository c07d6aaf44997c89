"""Port: ops/cast_string (string -> integer) against the JAX package's.
The batteries of ``test_cast_string.py`` (the reference's cast_string.cpp
Simple, Ansi, Overflow and Empty cases) run through both packages for
every integer target, then the int64-lane extremes: INT64 at +-(2^63 - 1),
-2^63 and -2^63 - 1, UINT64 at 2^64 - 1 and 2^64, with signs, whitespace,
leading zeros and non-ANSI truncation. Values, validity and type must be
equal bit for bit (integers: tolerance 0); ANSI mode must raise the port's
CastError with the JAX package's row and string."""

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
from spark_rapids_jni_tpu_torch.ops.strings import to_padded

TYPES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64"]

ANSI_STRINGS = [
    "", "null", "+1", "-0", "4.2",
    "asdf", "98fe", "  00012", ".--e-37602.n", "\r\r\t\n11.12380",
    "-.2", ".3", ".", "+1.2", "\n123\n456\n",
    "1 2", "123", "", "1. 2", "+    7.6",
    "  12  ", "7.6.2", "15  ", "7  2  ", " 8.2  ",
    "3..14", "c0", "\r\r", "    ", "+\n",
]
ANSI_IN_VALIDITY = [0, 0] + [1] * 28

OVERFLOW_STRINGS = [
    "127", "128", "-128", "-129", "255", "256", "32767", "32768", "-32768",
    "-32769", "65525", "65536", "2147483647", "2147483648", "-2147483648",
    "-2147483649", "4294967295", "4294967296", "-9223372036854775808",
    "-9223372036854775809", "9223372036854775807", "9223372036854775808",
    "18446744073709551615", "18446744073709551616",
]


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


def _cast(strings, tn, ansi=False, in_validity=None):
    jc, pc = _columns(strings, in_validity)
    got = PC.string_to_integer(pc, ansi, getattr(pdt, tn))
    _same(got, JC.string_to_integer(jc, ansi, getattr(jdt, tn)))
    return got


@pytest.mark.parametrize("tn", TYPES)
def test_simple(tn):
    assert _cast(["1", "0", "42"], tn).to_pylist() == [1, 0, 42]


@pytest.mark.parametrize("tn", TYPES)
def test_ansi_battery_without_ansi(tn):
    _cast(ANSI_STRINGS, tn, in_validity=ANSI_IN_VALIDITY)


@pytest.mark.parametrize("tn,row,s", [("INT32", 4, "4.2"), ("UINT32", 2, "+1"), ("INT8", 4, "4.2")])
def test_ansi_raises_the_first_error(tn, row, s):
    jc, pc = _columns(ANSI_STRINGS, ANSI_IN_VALIDITY)
    with pytest.raises(JC.CastError) as want:
        JC.string_to_integer(jc, True, getattr(jdt, tn))
    with pytest.raises(PC.CastError) as got:
        PC.string_to_integer(pc, True, getattr(pdt, tn))
    assert got.value.row_with_error == want.value.row_with_error == row
    assert got.value.string_with_error == want.value.string_with_error == s
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tn", TYPES)
def test_overflow_battery(tn):
    _cast(OVERFLOW_STRINGS, tn)


EXTREMES = [
    "9223372036854775807", "-9223372036854775807", "-9223372036854775808",
    "-9223372036854775809", "9223372036854775808", "18446744073709551615",
    "18446744073709551616", "+18446744073709551615", " 0018446744073709551615 ",
    "-0", "9223372036854775807.99", "18446744073709551615.5", "18446744073709551614\t",
    "99999999999999999999", "-18446744073709551615", "1844674407370955161", "18446744073709551609",
    "18446744073709551610", "-9223372036854775800", "9223372036854775799",
]


@pytest.mark.parametrize("tn", ["INT64", "UINT64"])
def test_int64_lane_extremes(tn):
    got = _cast(EXTREMES, tn).to_pylist()
    lo, hi = (-(2**63), 2**63 - 1) if tn == "INT64" else (0, 2**64 - 1)
    for s, g in zip(EXTREMES, got):
        body = s.strip()
        if body[0] in "+-" and tn == "UINT64":  # an unsigned target takes no sign
            want = None
        else:
            want = int(body.split(".")[0])
            want = want if lo <= want <= hi else None
        assert (g if tn == "INT64" or g is None else g % 2**64) == want, s


def test_ansi_valid_column_does_not_raise():
    assert _cast(["1", " 2", "+3"], "INT64", ansi=True).to_pylist() == [1, 2, 3]


@pytest.mark.parametrize("tn", ["INT32", "UINT64"])
def test_empty(tn):
    got = _cast([], tn)
    assert len(got) == 0


def test_incoming_nulls_not_ansi_errors():
    got = _cast(["1", "bad", "3"], "INT32", ansi=True, in_validity=[1, 0, 1])
    assert got.to_pylist() == [1, None, 3]


def test_padded_chars_matches_jax():
    strings = ["", "a", "hello world", None, "  12  ", "xyz"]
    jc, pc = _columns([s if s is not None else "" for s in strings],
                      [s is not None for s in strings])
    pch, plens = to_padded(pc)
    jch, jlens, jml = JC._padded_chars(jc)
    assert pch.shape[1] == jml
    np.testing.assert_array_equal(pch.numpy(), np.asarray(jch))
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))


def test_rejections():
    _, pc = _columns(["1"])
    with pytest.raises(ValueError, match="integral"):
        PC.string_to_integer(pc, False, pdt.FLOAT64)
    with pytest.raises(ValueError, match="STRING"):
        PC.string_to_integer(Column.from_pylist([1], pdt.INT32, device="cpu"), False, pdt.INT32)


@pytest.mark.parametrize("tn,lo,hi", [("INT64", -(2**63), 2**63 - 1), ("INT32", -(2**31), 2**31 - 1),
                                      ("UINT64", 0, 2**64 - 1)])
def test_chip_smoke_oracle_agrees_with_the_port(tn, lo, hi):
    # the independent oracle chip_smoke.py holds the card to: each row's
    # value known by construction
    import chip_smoke

    strs, valid, value, signed = chip_smoke._int_strings(np.random.default_rng(3), 4000)
    col = Column.from_pylist(strs, pdt.STRING, device="cpu")
    col.validity = torch.from_numpy(valid)
    want, ok = chip_smoke._int_oracle(valid, value, signed, lo, hi)
    got = PC.string_to_integer(col, False, getattr(pdt, tn)).to_pylist()
    assert [g if g is None or tn != "UINT64" else g % 2**64 for g in got] == \
        [w if k else None for w, k in zip(want, ok)]
