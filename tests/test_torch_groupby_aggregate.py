"""Port: ops/aggregate.groupby_aggregate (the sort-based general GROUP BY)
and groupby_sum_bounded(f64_bits=True) against the JAX package on the
same seeded tables: every aggregation over INT8, INT32, INT64, FLOAT32,
FLOAT64, DECIMAL128 and STRING keys with nulls, and value columns of
every numeric type with nulls.

Held exactly (bits and validity): the group keys, counts, integer and
DECIMAL128 sums, integer means, min/max of every type, nunique, and
FLOAT64 sums and means (the exact accumulator). FLOAT32 sums and means
accumulate in float32 in another order than the reference's: rtol 2e-6 /
atol 1e-3 (the reference's bound for float32 group-by sums). The
variance family sums float64 deviations in another order: rtol 1e-12."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import aggregate as jagg

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg

N = 400
RTOL32, ATOL32 = 2e-6, 1e-3
RTOL_VAR = 1e-12
HOWS = ["sum", "count", "count_all", "min", "max", "mean", "nunique", "var", "std", "var_pop",
        "stddev_pop"]
KEY_TYPES = ["INT8", "INT32", "INT64", "FLOAT32", "FLOAT64", "DECIMAL128", "STRING"]
VALUE_TYPES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64",
               "FLOAT32", "FLOAT64", "DECIMAL128", "BOOL8"]


def _dtype(mod, tn):
    return mod.decimal128(-2) if tn == "DECIMAL128" else getattr(mod, tn)


def _column(rng, tn, n, distinct=None):
    """Seeded storage of one column (``distinct`` values drawn from a small
    pool, as group keys are)."""
    def pick(pool):
        return pool[rng.integers(0, len(pool), n)] if distinct else pool

    m = distinct or n
    if tn == "STRING":
        words = [rng.integers(97, 100, rng.integers(1, 20), dtype=np.uint8).tobytes()
                 for _ in range(m)]
        enc = [words[i] for i in rng.integers(0, m, n)] if distinct else words
        offs = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(np.int32)
        return offs, np.frombuffer(b"".join(enc), np.uint8).copy()
    if tn == "DECIMAL128":
        v = rng.integers(-(2**40), 2**40, m)
        limbs = np.zeros((m, 4), np.uint32)
        u = v.astype(np.uint64)
        limbs[:, 0] = (u & 0xFFFFFFFF).astype(np.uint32)
        limbs[:, 1] = (u >> np.uint64(32)).astype(np.uint32)
        limbs[:, 2:] = ((v < 0).astype(np.uint32) * 0xFFFFFFFF)[:, None]
        return pick(limbs)
    if tn == "FLOAT64":
        v = rng.standard_normal(m) * 10.0 ** rng.integers(-5, 8, m)
        if not distinct:
            v[::17] = -0.0
            v[5] = np.inf
        return pick(v).view(np.uint64)
    if tn == "FLOAT32":
        return pick((rng.standard_normal(m) * 100).astype(np.float32))
    if tn == "BOOL8":
        return rng.integers(0, 2, n).astype(np.uint8)
    np_dt = np.dtype(tn.lower())
    info = np.iinfo(np_dt)
    lo, hi = (info.min, info.max) if np_dt.itemsize < 8 else (-(2**40), 2**40)
    if np_dt.kind == "u" and np_dt.itemsize == 8:
        lo, hi = 2**63 - 2**40, 2**63 + 2**40  # UINT64 values across 2^63
    return pick(rng.integers(lo, hi, m, dtype=np_dt, endpoint=True))


def _tables(specs):
    """[(name, type name, storage, validity)] -> (JAX Table, port Table)."""
    jcols, arrays, valids, dts = [], [], [], []
    for _, tn, a, v in specs:
        jv = None if v is None else jnp.asarray(v)
        if tn == "STRING":
            jcols.append(JColumn.strings_from_parts(a[0], a[1], validity=jv))
        else:
            jcols.append(JColumn(_dtype(jdt, tn), data=jnp.asarray(a), validity=jv))
        arrays.append(a)
        valids.append(v)
        dts.append(_dtype(pdt, tn))
    names = [s[0] for s in specs]
    return JTable(jcols, names), Table(carry_table(arrays, dts, valids, device="cpu").columns, names)


_CACHE = {}


def _inputs(key_tn):
    if key_tn not in _CACHE:
        rng = np.random.default_rng(KEY_TYPES.index(key_tn) + 100)
        keys = [("k", key_tn, _column(rng, key_tn, N, distinct=9), rng.random(N) < 0.85),
                ("k2", "INT8", rng.integers(0, 2, N).astype(np.int8), None)]
        vals = [(f"v_{tn.lower()}", tn, _column(rng, tn, N), rng.random(N) < 0.8)
                for tn in VALUE_TYPES]
        vals[0] = (vals[0][0], vals[0][1], vals[0][2], np.zeros(N, bool) if key_tn == "INT8"
                   else vals[0][3])  # one all-null value column
        _CACHE[key_tn] = (_tables(keys), _tables(vals))
    return _CACHE[key_tn]


def _applicable(tn, how):
    if how in ("var", "std", "var_pop", "stddev_pop"):
        return tn not in ("DECIMAL128", "BOOL8")
    if how in ("min", "max"):
        return tn != "DECIMAL128"
    if how == "mean":
        return tn not in ("DECIMAL128", "BOOL8")
    if how == "sum":
        return tn != "BOOL8"
    return True


def _assert_column(name, pc, jc, tn, how):
    assert int(pc.dtype.id) == int(jc.dtype.id), name
    pv = pc.valid_mask().numpy()
    np.testing.assert_array_equal(pv, np.asarray(jc.valid_mask()), err_msg=name)
    got = table_to_numpy(Table([pc]))[0][0]
    want = np.asarray(jc.data)
    if how in ("var", "std", "var_pop", "stddev_pop"):
        np.testing.assert_allclose(got.view(np.float64), want.view(np.float64), rtol=RTOL_VAR,
                                   atol=0, err_msg=name)
    elif tn == "FLOAT32" and how in ("sum", "mean"):
        g = got.view(np.float64) if how == "mean" else got
        w = want.view(np.float64) if how == "mean" else want
        np.testing.assert_allclose(g, w, rtol=RTOL32, atol=ATOL32, err_msg=name)
    else:
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=name)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("key_tn", KEY_TYPES)
def test_groupby_aggregate_matches_jax(key_tn, how):
    (jk, pk), (jv, pv) = _inputs(key_tn)
    aggs = [(f"v_{tn.lower()}", how) for tn in VALUE_TYPES if _applicable(tn, how)]
    want = jagg.groupby_aggregate(jk, jv, aggs)
    got = pagg.groupby_aggregate(pk, pv, aggs)
    assert got.names == want.names and got.num_rows == want.num_rows
    for i, name in enumerate(got.names):
        pc, jc = got.columns[i], want.columns[i]
        if i < 2:  # the group keys
            pa, pvalid = table_to_numpy(Table([pc]))
            if key_tn == "STRING" and i == 0:
                np.testing.assert_array_equal(pa[0][0], np.asarray(jc.offsets))
                np.testing.assert_array_equal(pa[0][1], np.asarray(jc.chars))
            else:
                np.testing.assert_array_equal(pa[0].view(np.uint8),
                                              np.asarray(jc.data).view(np.uint8))
            np.testing.assert_array_equal(pc.valid_mask().numpy(), np.asarray(jc.valid_mask()))
            continue
        tn = aggs[i - 2][0][2:].upper()
        _assert_column(name, pc, jc, tn, how)


def test_empty_groupby():
    (jk, pk), (jv, pv) = _inputs("INT32")
    aggs = [("v_float64", "sum"), ("v_int32", "mean"), ("v_int8", "nunique")]
    from spark_rapids_jni_tpu_torch.ops.copying import slice_table

    got = pagg.groupby_aggregate(slice_table(pk, 0, 0), slice_table(pv, 0, 0), aggs)
    assert got.num_rows == 0 and got.names == ["k", "k2", "v_float64_sum", "v_int32_mean",
                                               "v_int8_nunique"]


def test_var_rejects_non_numeric():
    (_, pk), (_, pv) = _inputs("INT32")
    with pytest.raises(ValueError, match="numeric"):
        pagg.groupby_aggregate(pk, pv, [("v_bool8", "var")])


def test_unknown_aggregation_raises():
    (_, pk), (_, pv) = _inputs("INT32")
    with pytest.raises(ValueError, match="unsupported aggregation"):
        pagg.groupby_aggregate(pk, pv, [("v_decimal128", "min")])


def _f64_specials(rng, n):
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    v[::13] = np.inf
    v[::29] = np.nan
    v[3::31] = -0.0
    return v


@pytest.mark.parametrize("num_keys", [1, 5, 16, 40, 4096])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_groupby_sum_bounded_f64_bits_matches_jax(rng, num_keys, np_dt):
    n = 1200
    keys = rng.integers(-3, num_keys + 3, n).astype(np_dt)
    if np_dt == np.int64:
        keys[::50] = 2**32 + 1  # drops, does not wrap
    bits = _f64_specials(rng, n).view(np.uint64)
    js, jc = jagg.groupby_sum_bounded(jnp.asarray(keys), jnp.asarray(bits), num_keys, f64_bits=True)
    ps, pc = pagg.groupby_sum_bounded(torch.from_numpy(keys), torch.from_numpy(bits.view(np.int64)),
                                      num_keys, f64_bits=True)
    assert ps.dtype == torch.int64 and pc.dtype == torch.int64
    np.testing.assert_array_equal(ps.numpy().view(np.uint64), np.asarray(js))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def test_groupby_sum_bounded_f64_bits_is_exact(rng):
    from fractions import Fraction

    keys = rng.integers(0, 3, 300)
    vals = rng.uniform(-1, 1, 300) * 10.0 ** rng.integers(-15, 15, 300)
    ps, pc = pagg.groupby_sum_bounded(torch.from_numpy(keys), torch.from_numpy(vals.view(np.int64)),
                                      3, f64_bits=True)
    for k in range(3):
        assert ps.numpy().view(np.float64)[k] == float(sum(Fraction(v) for v in vals[keys == k]))
        assert int(pc[k]) == int((keys == k).sum())


def test_groupby_sum_bounded_f64_bits_wants_int64_bits():
    with pytest.raises(ValueError, match="int64 IEEE-bit"):
        pagg.groupby_sum_bounded(torch.zeros(4, dtype=torch.int64), torch.zeros(4), 4,
                                 f64_bits=True)
