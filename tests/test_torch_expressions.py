"""Port: ops/expressions against the JAX package. The same expression is
built with each package's ``col``/``lit``/``when`` over the same seeded
table (every column but one with nulls) and evaluated; the result's
type, bits and validity must be identical. That holds three-valued
AND/OR, null propagation, NULL-on-divide-by-zero, CASE WHEN with a null
condition, casts, and the reference's type promotion (a Python float
meeting an integer column computes in float64; a numpy-scalar literal
promotes as a typed array)."""

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


@pytest.mark.parametrize("tn", ["UINT16", "UINT32", "UINT64"])
def test_wide_unsigned_columns_not_ported(tn):
    from spark_rapids_jni_tpu_torch.columnar import Column

    t = Table([Column.from_numpy(np.arange(4), getattr(pdt, tn), device="cpu")], ["u"])
    with pytest.raises(NotImplementedError, match="item 5"):
        (px.col("u") + 1).evaluate(t)
