"""Port: the handles' ``Column.has_nulls``, ``Column.to_decimal_pylist``
and ``Table.with_column`` against the JAX package's, on the same seeded
host values. Exact: booleans, ``decimal.Decimal`` values digit for digit
(``as_tuple``), under the default decimal context and under one wide
enough for every 128-bit value, names, dtypes and ``to_pydict``."""

import decimal

import numpy as np
import pytest

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.columnar import Column as JColumn, Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt

from spark_rapids_jni_tpu_torch.columnar import Column, Table, dtype as pdt

ROWS = 12


def _both(values, name, scale=0):
    """One column from ``values`` (None is null) on each side."""
    return (JColumn.from_pylist(values, jdt.DType(jdt.TypeId[name], scale)),
            Column.from_pylist(values, pdt.DType(pdt.TypeId[name], scale), device="cpu"))


@pytest.mark.parametrize("nulls", ["no_mask", "all_valid", "some_null"])
@pytest.mark.parametrize("name", ["INT32", "FLOAT64", "STRING"])
def test_has_nulls(name, nulls):
    rng = np.random.default_rng(11)
    vals = rng.integers(-50, 50, ROWS)
    mask = None if nulls == "no_mask" else np.ones(ROWS, dtype=bool)
    if nulls == "some_null":
        mask[[3, 7]] = False
    if name == "STRING":
        chars = np.frombuffer("".join(map(str, vals)).encode(), dtype=np.uint8)
        offsets = np.concatenate([[0], np.cumsum([len(str(v)) for v in vals])]).astype(np.int32)
        j = JColumn.strings_from_parts(offsets, chars, mask)
        p = Column.strings_from_parts(offsets, chars, mask, device="cpu")
    else:
        arr = vals.astype(np.float64 if name == "FLOAT64" else np.int32)
        j = JColumn.from_numpy(arr, getattr(jdt, name), mask)
        p = Column.from_numpy(arr, getattr(pdt, name), mask, device="cpu")
    assert (j.validity is None) == (p.validity is None) == (mask is None)
    assert p.has_nulls() is j.has_nulls() is (nulls == "some_null")
    assert p.to_pylist() == j.to_pylist()


_LIMB = [2**32 - 1, 2**32, -(2**32), 2**64 - 1, 2**64, -(2**64), 2**96 - 1, 2**96,
         -(2**96), 10**38 - 1, -(10**38 - 1), 2**127 - 1, -(2**127)]


@pytest.mark.parametrize("scale", [-3, 0, 2])
@pytest.mark.parametrize("name", ["DECIMAL32", "DECIMAL64", "DECIMAL128"])
def test_to_decimal_pylist(name, scale):
    rng = np.random.default_rng(17)
    cap = {"DECIMAL32": 10**9 - 1, "DECIMAL64": 10**18 - 1, "DECIMAL128": 10**18 - 1}[name]
    values = [int(v) for v in rng.integers(-cap, cap, ROWS, dtype=np.int64)]
    values[2] = values[9] = None
    values[4] = 0
    values[5], values[6] = cap, -cap
    if name == "DECIMAL128":  # every 32-bit limb boundary, and the precision cap
        values += _LIMB
    j, p = _both(values, name, scale)
    jd, pd = j.to_decimal_pylist(), p.to_decimal_pylist()
    assert pd == jd
    assert [None if d is None else d.as_tuple() for d in pd] == \
           [None if d is None else d.as_tuple() for d in jd]
    assert pd[2] is None and pd[9] is None and jd[9] is None
    # values over the default context's 28 digits come back rounded by it,
    # on both sides; a 39-digit context gives every 128-bit value exactly
    with decimal.localcontext() as ctx:
        ctx.prec = 39
        jd, pd = j.to_decimal_pylist(), p.to_decimal_pylist()
    want = [None if v is None else decimal.Decimal(f"{v}E{scale}") for v in values]
    for got in (jd, pd):
        assert [None if d is None else d.as_tuple() for d in got] == \
               [None if d is None else d.as_tuple() for d in want]


def test_to_decimal_pylist_refuses_a_non_decimal_column():
    j, p = _both([1, 2, None], "INT64")
    for col in (j, p):
        with pytest.raises(AssertionError):
            col.to_decimal_pylist()


def test_with_column():
    rng = np.random.default_rng(23)
    a, b = rng.integers(-9, 9, ROWS), rng.integers(0, 1000, ROWS)
    mask = rng.random(ROWS) >= 0.25
    jt = JTable([JColumn.from_numpy(a, jdt.INT64)], ["a"])
    pt = Table([Column.from_numpy(a, pdt.INT64, device="cpu")], ["a"])
    jn = jt.with_column("d", JColumn.from_numpy(b.astype(np.int32), jdt.decimal32(-2), mask))
    pn = pt.with_column("d", Column.from_numpy(b.astype(np.int32), pdt.decimal32(-2), mask,
                                               device="cpu"))
    assert pn.names == jn.names == ["a", "d"]
    assert [repr(d) for d in pn.dtypes()] == [repr(d) for d in jn.dtypes()]
    assert pn.to_pydict() == jn.to_pydict()
    assert pn.columns[1].to_decimal_pylist() == jn.columns[1].to_decimal_pylist()
    for t in (jt, pt):  # the source table is left as it was
        assert t.names == ["a"] and t.num_columns == 1
    assert pt.to_pydict() == jt.to_pydict()
    assert pn.columns[0] is pt.columns[0]
