"""Port: ops/expressions against the JAX package. The same expression is
built with each package's ``col``/``lit``/``when`` over the same seeded
table (every column but one with nulls) and evaluated; the result's
type, bits and validity must be identical. That holds three-valued
AND/OR, null propagation, NULL-on-divide-by-zero, CASE WHEN with a null
condition, casts, and the reference's type promotion (a Python float
meeting an integer column computes in float64; a numpy-scalar literal
promotes as a typed array). UINT16, UINT32 and UINT64 columns (values up
to their type's maximum, with nulls) take jnp's promotion lattice, not
torch's: arithmetic with literals and columns wraps at the width, u32
with i32 gives int64, u64 with i64 gives float64, and UINT64 compares and
``%`` are unsigned. Every result is compared bit for bit (tolerance 0)."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import expressions as jx

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import expressions as px

N = 257


def _extremes(a, zeros=False):
    """Seeded unsigned values with the type's edges: 0, 1, the max, the
    top bit alone and below it; every 11th value 0 where ``zeros``."""
    top = np.iinfo(a.dtype).max
    a[:6] = [0, 1, top, top // 2 + 1, top // 2, top - 1]
    a[6:12] //= a.dtype.type(1 << 7)  # small values too
    if zeros:
        a[::11] = 0
    return a


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    f64 = rng.standard_normal(N) * 100
    f64[::9] = 0.0  # divisors of zero
    f64[::31] = -0.0
    specs = [
        ("i8", "INT8", rng.integers(-100, 100, N).astype(np.int8), rng.random(N) < 0.8),
        ("i32", "INT32", rng.integers(-10**6, 10**6, N).astype(np.int32), None),
        ("i64", "INT64", rng.integers(-10**12, 10**12, N), rng.random(N) < 0.7),
        ("f32", "FLOAT32", (rng.standard_normal(N) * 10).astype(np.float32), rng.random(N) < 0.9),
        ("f64", "FLOAT64", f64, rng.random(N) < 0.8),
        ("b", "BOOL8", rng.integers(0, 2, N).astype(np.uint8), rng.random(N) < 0.75),
        ("d", "TIMESTAMP_DAYS", rng.integers(0, 2557, N).astype(np.int32), rng.random(N) < 0.9),
        ("u8", "UINT8", rng.integers(0, 256, N).astype(np.uint8), rng.random(N) < 0.9),
        ("u16", "UINT16", _extremes(rng.integers(0, 2**16, N, dtype=np.uint16)), rng.random(N) < 0.9),
        ("u32", "UINT32", _extremes(rng.integers(0, 2**32, N, dtype=np.uint32)), rng.random(N) < 0.85),
        ("u32b", "UINT32", _extremes(rng.integers(0, 2**32, N, dtype=np.uint32), zeros=True), None),
        ("u64", "UINT64", _extremes(rng.integers(0, 2**64, N, dtype=np.uint64)), rng.random(N) < 0.9),
        ("u64b", "UINT64", _extremes(rng.integers(0, 2**64, N, dtype=np.uint64), zeros=True), None),
    ]
    jcols, arrays, valids, dts = [], [], [], []
    for _, tn, a, v in specs:
        store = a.view(np.uint64) if tn == "FLOAT64" else a
        jcols.append(JColumn(getattr(jdt, tn), data=jnp.asarray(store),
                             validity=None if v is None else jnp.asarray(v)))
        arrays.append(store)
        valids.append(v)
        dts.append(getattr(pdt, tn))
    names = [s[0] for s in specs]
    return JTable(jcols, names), Table(carry_table(arrays, dts, valids, device="cpu").columns, names)


JT, PT = _inputs()


def _q1_charge(m):
    return m.col("f64") * (m.lit(1.0) - m.col("f64")) * (m.lit(1.0) + m.col("f64"))


# name -> the expression, made from (expressions module, dtype module)
EXPRS = {
    "add_i32_i64": lambda m, d: m.col("i32") + m.col("i64"),
    "add_i8_i8_wraps": lambda m, d: m.col("i8") + m.col("i8"),
    "add_i8_int": lambda m, d: m.col("i8") + 3,
    "mul_i8_float": lambda m, d: m.col("i8") * 2.5,
    "sub_f64_lit": lambda m, d: m.col("f64") - m.lit(1.5),
    "sub_lit_f64": lambda m, d: m.lit(1.0) - m.col("f64"),
    "mul_f64_f64": lambda m, d: m.col("f64") * m.col("f64"),
    "mul_i64_f64": lambda m, d: m.col("i64") * m.col("f64"),
    "mul_f32_lit": lambda m, d: m.col("f32") * 0.5,
    "add_f32_i32": lambda m, d: m.col("f32") + m.col("i32"),
    "q1_charge": lambda m, d: _q1_charge(m),
    "div_f64_f64": lambda m, d: m.col("i32") / m.col("f64"),
    "div_int_int": lambda m, d: m.col("i64") / m.col("i8"),
    "div_by_zero_lit": lambda m, d: m.col("f64") / m.lit(0),
    "div_f32_int": lambda m, d: m.col("f32") / 3,
    "mod_i32": lambda m, d: m.col("i32") % 7,
    "mod_f64": lambda m, d: m.col("f64") % 3.0,
    "eq_i8_int": lambda m, d: m.col("i8") == 5,
    "ne_i32_i64": lambda m, d: m.col("i32") != m.col("i64"),
    "lt_f64_float": lambda m, d: m.col("f64") < 24.0,
    "le_i8_np_int32": lambda m, d: m.col("i8") <= m.lit(np.int32(300)),
    "gt_i32_float": lambda m, d: m.col("i32") > 0.5,
    "ge_days_np_int32": lambda m, d: m.col("d") >= m.lit(np.int32(731)),
    "and_3vl": lambda m, d: (m.col("f64") > 0) & (m.col("i8") < 10),
    "or_3vl": lambda m, d: (m.col("f64") > 0) | (m.col("i8") < 10),
    "and_null_literal": lambda m, d: (m.col("f64") > 0) & m.lit(None),
    "or_null_literal": lambda m, d: (m.col("f64") > 0) | m.lit(None),
    "and_true_literal": lambda m, d: m.col("b") & m.lit(True),
    "q6_predicate": lambda m, d: ((m.col("d") >= m.lit(np.int32(731)))
                                  & (m.col("d") < m.lit(np.int32(1096)))
                                  & (m.col("f64") >= m.lit(0.05)) & (m.col("f64") <= m.lit(70.0))
                                  & (m.col("i32") < m.lit(24.0))),
    "not_compare": lambda m, d: ~(m.col("f64") > 0),
    "not_bool_column": lambda m, d: ~m.col("b"),
    "is_null": lambda m, d: m.col("i64").is_null(),
    "is_not_null": lambda m, d: m.col("f64").is_not_null(),
    "is_null_no_validity": lambda m, d: m.col("i32").is_null(),
    "is_null_of_sum": lambda m, d: (m.col("i8") + m.col("i64")).is_null(),
    "when_columns": lambda m, d: m.when(m.col("f64") > 0, m.col("i32"), m.col("i64")),
    "when_float_literal": lambda m, d: m.when(m.col("b"), 1.5, m.col("f64")),
    "when_int_and_float": lambda m, d: m.when(m.col("i8") > 0, m.col("i32"), 2.5),
    "when_null_condition": lambda m, d: m.when(m.col("i64") > 0, m.col("f64"), m.lit(-1.0)),
    "when_nested": lambda m, d: m.when(m.col("i8") > 50, 1,
                                       m.when(m.col("i8") < -50, -1, m.col("i32"))),
    "cast_i32_f64": lambda m, d: m.col("i32").cast(d.FLOAT64),
    "cast_f64_i32": lambda m, d: m.col("f64").cast(d.INT32),
    "cast_i64_i8": lambda m, d: m.col("i64").cast(d.INT8),
    "cast_b_i32": lambda m, d: m.col("b").cast(d.INT32),
    "days_plus_int": lambda m, d: m.col("d") + 30,
    "u8_plus_int": lambda m, d: m.col("u8") + 1,
    "u8_lt_i8": lambda m, d: m.col("u8") < m.col("i8"),
    # UINT16 / UINT32 / UINT64: jnp's promotion and unsigned semantics
    "u16_plus_int": lambda m, d: m.col("u16") + 7,
    "u16_plus_u8": lambda m, d: m.col("u16") + m.col("u8"),
    "u16_plus_i32": lambda m, d: m.col("u16") + m.col("i32"),
    "u16_times_i8": lambda m, d: m.col("u16") * m.col("i8"),
    "u16_times_float": lambda m, d: m.col("u16") * 2.5,
    "u32_minus_int_wraps": lambda m, d: m.col("u32") - 5,
    "u32_plus_negative_int_wraps": lambda m, d: m.col("u32") + (-5),
    "u32_plus_u16": lambda m, d: m.col("u32") + m.col("u16"),
    "u32_plus_i32": lambda m, d: m.col("u32") + m.col("i32"),
    "u32_minus_i8": lambda m, d: m.col("u32") - m.col("i8"),
    "u32_times_u32_wraps": lambda m, d: m.col("u32") * m.col("u32b"),
    "u32_mod_int": lambda m, d: (m.col("u32") + 7) % 1000,
    "u32_mod_column_with_zeros": lambda m, d: m.col("u32") % m.col("u32b"),
    "u32_filter": lambda m, d: (m.col("u32") + 7) % 1000 > 3,
    "u32_lt_i64": lambda m, d: m.col("u32") < m.col("i64"),
    "u32_ge_u32": lambda m, d: m.col("u32") >= m.col("u32b"),
    "u32_eq_np_literal": lambda m, d: m.col("u32") == m.lit(np.uint32(2**32 - 1)),
    "u32_plus_np_literal": lambda m, d: m.col("u32") + m.lit(np.uint32(4_000_000_000)),
    "u32_plus_np_int32": lambda m, d: m.col("u32") + m.lit(np.int32(5)),
    "u32_div_u16": lambda m, d: m.col("u32") / m.col("u16"),
    "u64_plus_int_wraps": lambda m, d: m.col("u64") + 3,
    "u64_minus_u64_wraps": lambda m, d: m.col("u64") - m.col("u64b"),
    "u64_times_u64_wraps": lambda m, d: m.col("u64") * m.col("u64b"),
    "u64_plus_u32": lambda m, d: m.col("u64") + m.col("u32"),
    "u64_plus_i64_is_float64": lambda m, d: m.col("u64") + m.col("i64"),
    "u64_plus_i32_is_float64": lambda m, d: m.col("u64") + m.col("i32"),
    "u64_plus_f32": lambda m, d: m.col("u64") + m.col("f32"),
    "u64_times_float": lambda m, d: m.col("u64") * 0.5,
    "u64_mod_int": lambda m, d: m.col("u64") % 1000,
    "u64_mod_column_with_zeros": lambda m, d: m.col("u64") % m.col("u64b"),
    "u64_gt_u64": lambda m, d: m.col("u64") > m.col("u64b"),
    "u64_le_np_literal": lambda m, d: m.col("u64") <= m.lit(np.uint64(2**63 + 5)),
    "u64_lt_int": lambda m, d: m.col("u64") < 1000,
    "u64_ne_u32": lambda m, d: m.col("u64") != m.col("u32"),
    "u64_lt_f64": lambda m, d: m.col("u64") < m.col("f64"),
    "u64_div_int": lambda m, d: m.col("u64") / 3,
    "u64_and_u32_predicates": lambda m, d: (m.col("u64") > 5) & (m.col("u32") < 2**31),
    "u64_is_null": lambda m, d: m.col("u64").is_null(),
    "when_u32_or_int": lambda m, d: m.when(m.col("b"), m.col("u32"), 5),
    "when_u64_or_u16": lambda m, d: m.when(m.col("i8") > 0, m.col("u64"), m.col("u16")),
    "when_u32_or_i32": lambda m, d: m.when(m.col("b"), m.col("u32"), m.col("i32")),
    "cast_u16_i8": lambda m, d: m.col("u16").cast(d.INT8),
    "cast_u32_i32": lambda m, d: m.col("u32").cast(d.INT32),
    "cast_u32_i64": lambda m, d: m.col("u32").cast(d.INT64),
    "cast_u32_f64": lambda m, d: m.col("u32").cast(d.FLOAT64),
    "cast_u32_bool8": lambda m, d: m.col("u32").cast(d.BOOL8),
    "cast_u64_i32": lambda m, d: m.col("u64").cast(d.INT32),
    "cast_u64_i64": lambda m, d: m.col("u64").cast(d.INT64),
    "cast_u64_f64": lambda m, d: m.col("u64").cast(d.FLOAT64),
    "cast_u64_u16": lambda m, d: m.col("u64").cast(d.UINT16),
    "cast_u16_u64": lambda m, d: m.col("u16").cast(d.UINT64),
    "cast_i8_u16": lambda m, d: m.col("i8").cast(d.UINT16),
    "cast_i32_u32": lambda m, d: m.col("i32").cast(d.UINT32),
    "cast_i64_u64": lambda m, d: m.col("i64").cast(d.UINT64),
    "cast_f64_u32_saturates": lambda m, d: (m.col("f64") * 1e8).cast(d.UINT32),
    "cast_f64_u64_saturates": lambda m, d: (m.col("f64") * 1e17).cast(d.UINT64),
    "cast_b_u64": lambda m, d: m.col("b").cast(d.UINT64),
}


def _assert_same(pc, jc):
    assert int(pc.dtype.id) == int(jc.dtype.id)
    got = pc.data.numpy()
    want = np.asarray(jc.data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    pv = None if pc.validity is None else pc.validity.numpy()
    jv = None if jc.validity is None else np.asarray(jc.validity)
    if pv is None or jv is None:
        assert pv is None and jv is None
    else:
        np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(name):
    build = EXPRS[name]
    want = build(jx, jdt).evaluate(JT)
    got = build(px, pdt).evaluate(PT)
    _assert_same(got, want)


def test_float32_meeting_float64_keeps_values():
    # the reference keeps a float64 buffer under FLOAT32 here; the port
    # stores float32 of the same values (its column type's width)
    want = (jx.col("f32") * jx.col("f64")).evaluate(JT)
    got = (px.col("f32") * px.col("f64")).evaluate(PT)
    assert got.dtype.id == pdt.TypeId.FLOAT32 and got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data).astype(np.float32))
    np.testing.assert_array_equal(got.validity.numpy(), np.asarray(want.validity))


def test_divide_by_zero_is_null():
    got = (px.col("i32") / px.col("f64")).evaluate(PT)
    f64 = PT.column("f64").data.view(torch.float64)
    assert not got.validity[f64 == 0].any()


def test_three_valued_logic_table():
    # false AND null = false (valid); true AND null = null; true OR null =
    # true (valid); false OR null = null
    from spark_rapids_jni_tpu_torch.columnar import Column

    a = Column.from_pylist([True, False, None, True, False, None], pdt.BOOL8, device="cpu")
    b = Column.from_pylist([None, None, None, True, True, False], pdt.BOOL8, device="cpu")
    t = Table([a, b], ["a", "b"])
    and_ = (px.col("a") & px.col("b")).evaluate(t)
    or_ = (px.col("a") | px.col("b")).evaluate(t)
    assert and_.to_pylist() == [None, False, None, True, False, False]
    assert or_.to_pylist() == [True, None, None, True, True, None]


def test_carry_table_keeps_uint64_bits():
    a = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64)
    t = carry_table([a], [pdt.UINT64], device="cpu")
    assert t.columns[0].data.dtype == torch.int64
    np.testing.assert_array_equal(t.columns[0].to_numpy(), a)


def test_unsigned_arithmetic_against_numpy():
    # numpy's uint64 / uint32 arithmetic is the oracle of the wrapping and
    # the unsigned remainder, compare and cast
    u64 = PT.column("u64").to_numpy()
    u32 = PT.column("u32").to_numpy()
    got = ((px.col("u64") * px.col("u64b")) % 1000).evaluate(PT).to_numpy()
    with np.errstate(over="ignore"):
        want = (u64 * PT.column("u64b").to_numpy()) % np.uint64(1000)
        np.testing.assert_array_equal(got, want)
        got = ((px.col("u32") + 7) % 1000 > 3).evaluate(PT).to_numpy()
        np.testing.assert_array_equal(got.astype(bool), (u32 + np.uint32(7)) % np.uint32(1000) > 3)
    got = px.col("u32").cast(pdt.UINT64).evaluate(PT).to_numpy()
    np.testing.assert_array_equal(got, u32.astype(np.uint64))
