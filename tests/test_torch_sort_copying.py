"""Port: the sort and copying tiers (spark_rapids_jni_tpu_torch.ops.sort,
ops.copying, ops.bitutils.total_order_key, and aggregate's segment
helpers) against the JAX package on the same seeded tables. Every
comparison is exact: orders, gathered bytes, validity and segment ids."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import copying as jcopy
from spark_rapids_jni_tpu.ops import sort as jsort

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import copying as pcopy
from spark_rapids_jni_tpu_torch.ops import sort as psort


def _strings(rng, n, lo, hi, valid, prefix=b""):
    enc = [prefix + rng.integers(97, 100, rng.integers(lo, hi + 1), dtype=np.uint8).tobytes()
           for _ in range(n)]
    if valid is not None:
        enc = [e if ok else b"" for e, ok in zip(enc, valid)]
    offs = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(np.int32)
    return offs, np.frombuffer(b"".join(enc), np.uint8).copy()


def _values(rng, name, n, valid, dup, **kw):
    """Values drawn from a small pool (``dup``) so that sorts meet ties."""
    if name == "STRING":
        return _strings(rng, n, valid=valid, **kw)
    if name == "BOOL8":
        return rng.integers(0, 2, n).astype(np.uint8)
    if name == "FLOAT32":
        pool = np.array([0.0, -0.0, np.nan, -np.inf, np.inf, 1.5, -2.25, 3e30], np.float32)
        return pool[rng.integers(0, len(pool), n)]
    if name == "FLOAT64":
        pool = np.array([0.0, -0.0, np.nan, -np.nan, -np.inf, np.inf, 1.5, -2.25, 1e300])
        return pool[rng.integers(0, len(pool), n)].view(np.uint64)
    if name == "DECIMAL128":
        pool = rng.integers(0, 2**32, (6, 4), dtype=np.uint32)
        pool[0] = 0
        pool[1] = 2**32 - 1  # -1
        pool[2, 3] = 2**31  # the most negative top limb
        return pool[rng.integers(0, 6, n)]
    info = np.iinfo(getattr(jdt, name).np_dtype)
    pool = rng.integers(info.min, info.max, dup, dtype=info.dtype, endpoint=True)
    pool[:2] = [info.min, info.max]
    return pool[rng.integers(0, dup, n)]


def _make(rng, names, n, null_cols=(), dup=7, all_null=(), **kw):
    """Seeded columns -> (JAX Table, port Table on the CPU)."""
    jd = [jdt.decimal128(-2) if nm == "DECIMAL128" else getattr(jdt, nm) for nm in names]
    pd = [pdt.decimal128(-2) if nm == "DECIMAL128" else getattr(pdt, nm) for nm in names]
    arrays, valids, jcols = [], [], []
    kw.setdefault("lo", 0)
    kw.setdefault("hi", 3)
    for i, (nm, d) in enumerate(zip(names, jd)):
        v = rng.random(n) < 0.7 if i in null_cols else None
        if i in all_null:
            v = np.zeros(n, bool)
        a = _values(rng, nm, n, v, dup, **kw)
        jv = None if v is None else jnp.asarray(v)
        if nm == "STRING":
            jcols.append(JColumn.strings_from_parts(a[0], a[1], validity=jv))
        else:
            jcols.append(JColumn(d, data=jnp.asarray(a), validity=jv))
        arrays.append(a)
        valids.append(v)
    names_ = [f"c{i}" for i in range(len(names))]
    return JTable(jcols, names_), Table(carry_table(arrays, pd, valids, device="cpu").columns,
                                        names_)


def _assert_tables_equal(pt: Table, jt: JTable):
    arrays, valids = table_to_numpy(pt)
    assert pt.num_rows == jt.num_rows and pt.names == jt.names
    for c, a, v in zip(jt.columns, arrays, valids):
        want_v = np.asarray(c.valid_mask())
        np.testing.assert_array_equal(np.ones(len(want_v), bool) if v is None else v, want_v)
        if c.dtype.id == jdt.TypeId.STRING:
            np.testing.assert_array_equal(a[0], np.asarray(c.offsets))
            np.testing.assert_array_equal(a[1], np.asarray(c.chars))
        elif c.dtype.id == jdt.TypeId.LIST:
            raise AssertionError("compare LIST columns directly")
        else:
            np.testing.assert_array_equal(a.view(np.uint8), np.asarray(c.data).view(np.uint8))


SORTABLE = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64",
            "FLOAT32", "FLOAT64", "BOOL8", "DECIMAL128", "TIMESTAMP_DAYS", "DURATION_SECONDS",
            "STRING"]


# -- sorted_order -------------------------------------------------------------


@pytest.mark.parametrize("name", SORTABLE)
@pytest.mark.parametrize("ascending,nulls_first", [(True, True), (False, False), (True, False),
                                                   (False, True)])
def test_sorted_order_one_column(rng, name, ascending, nulls_first):
    jt, pt = _make(rng, [name], 301, null_cols=(0,))
    want = np.asarray(jsort.sorted_order(jt, [ascending], [nulls_first]))
    got = psort.sorted_order(pt, [ascending], [nulls_first])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("names,asc,nf", [
    (["INT32", "STRING", "FLOAT64"], [True, False, True], [True, True, False]),
    (["DECIMAL128", "INT8", "UINT64"], [False, True, False], [False, True, True]),
    (["BOOL8", "FLOAT32", "STRING", "INT64"], None, None),
])
def test_sorted_order_multi_key(rng, names, asc, nf):
    jt, pt = _make(rng, names, 400, null_cols=(0, 2), dup=3)
    np.testing.assert_array_equal(psort.sorted_order(pt, asc, nf).numpy(),
                                  np.asarray(jsort.sorted_order(jt, asc, nf)))


@pytest.mark.parametrize("lo,hi,prefix", [(0, 20, b""), (0, 3, b"x" * 16), (10, 30, b"ab" * 7)])
def test_sorted_order_string_prefixes(rng, lo, hi, prefix):
    # strings that tie in their first 16 bytes keep row order, as in the
    # reference; shorter strings sort before longer ones with that prefix
    jt, pt = _make(rng, ["STRING", "INT32"], 250, null_cols=(0,), lo=lo, hi=hi, prefix=prefix)
    for asc in (True, False):
        np.testing.assert_array_equal(psort.sorted_order(pt, [asc, True]).numpy(),
                                      np.asarray(jsort.sorted_order(jt, [asc, True])))


@pytest.mark.parametrize("n,names", [(0, ["INT64", "FLOAT64"]), (1, ["INT64", "FLOAT64"]),
                                     (1, ["STRING"])])
def test_sorted_order_empty_and_one_row(rng, n, names):
    # the STRING row is valid and not empty: the reference cannot gather
    # from a STRING column whose chars are empty
    jt, pt = _make(rng, names, n, null_cols=(0,) if names[0] != "STRING" else (), lo=1)
    np.testing.assert_array_equal(psort.sorted_order(pt).numpy(),
                                  np.asarray(jsort.sorted_order(jt)))


@pytest.mark.parametrize("names", [["INT32", "STRING"], ["FLOAT64", "DECIMAL128", "UINT16"]])
def test_sort_by_key(rng, names):
    jt, pt = _make(rng, names + ["INT64"], 200, null_cols=(0, 1))
    keys_j, keys_p = JTable(jt.columns[:len(names)]), Table(pt.columns[:len(names)])
    _assert_tables_equal(psort.sort_by_key(pt, keys_p, [False] * len(names)),
                         jsort.sort_by_key(jt, keys_j, [False] * len(names)))


# -- segment ids (the join's factorization) -------------------------------------


@pytest.mark.parametrize("names", [["INT32"], ["STRING"], ["DECIMAL128"], ["FLOAT32"],
                                   ["FLOAT64", "STRING", "INT8"]])
def test_segment_ids(rng, names):
    jt, pt = _make(rng, names, 300, null_cols=(0,), dup=4)
    jorder = jsort.sorted_order(jt)
    porder = psort.sorted_order(pt)
    jseg, jnum = jagg._segment_ids(jt, jorder)
    pseg, pnum = pagg._segment_ids(pt, porder)
    assert pnum == jnum
    np.testing.assert_array_equal(pseg.numpy(), np.asarray(jseg))


# -- gather ---------------------------------------------------------------------

GATHERABLE = ["INT8", "UINT16", "INT32", "INT64", "FLOAT32", "FLOAT64", "BOOL8", "DECIMAL128",
              "STRING"]


@pytest.mark.parametrize("check_bounds", [False, True])
@pytest.mark.parametrize("nulls", [False, True])
def test_gather_table(rng, check_bounds, nulls):
    jt, pt = _make(rng, GATHERABLE, 120, null_cols=(0, 3, 8) if nulls else (), hi=9)
    lo = -5 if check_bounds else 0
    hi = 125 if check_bounds else 120
    idx = rng.integers(lo, hi, 333).astype(np.int32)
    _assert_tables_equal(pcopy.gather(pt, torch.from_numpy(idx), check_bounds),
                         jcopy.gather(jt, jnp.asarray(idx), check_bounds))


def test_gather_empty_source(rng):
    jt, pt = _make(rng, GATHERABLE, 0)
    idx = np.array([-1, -1, 3], np.int32)
    _assert_tables_equal(pcopy.gather(pt, torch.from_numpy(idx), True),
                         jcopy.gather(jt, jnp.asarray(idx), True))
    with pytest.raises(IndexError):
        pcopy.gather_column(pt.columns[0], torch.from_numpy(idx))
    _assert_tables_equal(pcopy.gather(pt, torch.zeros(0, dtype=torch.int32)),
                         jcopy.gather(jt, jnp.zeros(0, jnp.int32)))


def test_gather_empty_map_and_all_null_strings(rng):
    jt, pt = _make(rng, ["STRING", "INT32"], 50, all_null=(0,))
    for idx in (np.zeros(0, np.int32), np.array([3, 3, 49, 0], np.int32)):
        _assert_tables_equal(pcopy.gather(pt, torch.from_numpy(idx)),
                             jcopy.gather(jt, jnp.asarray(idx)))


def test_gather_list_column(rng):
    n = 40
    lens = rng.integers(0, 6, n)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    child = rng.integers(-128, 128, int(offs[-1]), dtype=np.int8)
    valid = rng.random(n) < 0.8
    jcol = JColumn(jdt.LIST, validity=jnp.asarray(valid), offsets=jnp.asarray(offs),
                   child=JColumn(jdt.INT8, data=jnp.asarray(child)))
    pcol = Column.list_from_parts(torch.from_numpy(offs),
                                  Column(pdt.INT8, data=torch.from_numpy(child)),
                                  validity=torch.from_numpy(valid))
    idx = rng.integers(-3, n + 3, 77).astype(np.int32)
    jg = jcopy.gather_column(jcol, jnp.asarray(idx), check_bounds=True)
    pg = pcopy.gather_column(pcol, torch.from_numpy(idx), check_bounds=True)
    np.testing.assert_array_equal(pg.offsets.numpy(), np.asarray(jg.offsets))
    np.testing.assert_array_equal(pg.child.data.numpy(), np.asarray(jg.child.data))
    np.testing.assert_array_equal(pg.validity.numpy(), np.asarray(jg.validity))


# -- mask, slice, concatenate -----------------------------------------------------


def test_apply_boolean_mask(rng):
    jt, pt = _make(rng, ["INT32", "STRING", "FLOAT64"], 90, null_cols=(1,))
    m = rng.random(90) < 0.4
    _assert_tables_equal(pcopy.apply_boolean_mask(pt, torch.from_numpy(m)),
                         jcopy.apply_boolean_mask(jt, jnp.asarray(m)))
    mcol_v = rng.random(90) < 0.5
    jmask = JColumn(jdt.BOOL8, data=jnp.asarray(m.astype(np.uint8)), validity=jnp.asarray(mcol_v))
    pmask = Column(pdt.BOOL8, data=torch.from_numpy(m.astype(np.uint8)),
                   validity=torch.from_numpy(mcol_v))
    _assert_tables_equal(pcopy.apply_boolean_mask(pt, pmask), jcopy.apply_boolean_mask(jt, jmask))


@pytest.mark.parametrize("start,end", [(0, 10), (5, 95), (-3, 4), (80, 200), (50, 40)])
def test_slice_table(rng, start, end):
    jt, pt = _make(rng, ["INT64", "STRING"], 90, null_cols=(0,))
    _assert_tables_equal(pcopy.slice_table(pt, start, end), jcopy.slice_table(jt, start, end))


def test_concatenate(rng):
    parts = [_make(rng, ["INT32", "STRING", "DECIMAL128"], n, null_cols=nc)
             for n, nc in ((30, (0,)), (0, ()), (17, (1,)), (5, ()))]
    _assert_tables_equal(pcopy.concatenate([p for _, p in parts]),
                         jcopy.concatenate([j for j, _ in parts]))
