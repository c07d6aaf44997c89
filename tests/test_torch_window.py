"""Port: ops/window against the JAX package. The same table (a seeded
numpy draw: a partition key, an order key with ties, INT32 / INT64 /
FLOAT64 sources with nulls) goes through both packages'
``window_aggregate`` for each of the 15 window functions, and the results
must agree bit for bit, with two stated exceptions:

- a FLOAT64 cumsum is a float64 scan minus the running total at the
  segment's entry; the backends may associate the scan differently, so
  it is held to 2^-40 of the running max of |global prefix| (the
  subtraction's own error scale);
- var / std / var_pop / stddev_pop sum float64 squares in another order
  than the reference; rtol 1e-9, the reference's own bound
  (tests/test_window.py).

Validity is exact everywhere. The classes mirror tests/test_window.py."""

import numpy as np
import pytest

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops.window import window_aggregate as jwindow

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import table_to_numpy
from spark_rapids_jni_tpu_torch.ops.window import window_aggregate

N = 400
FUNCTIONS = ["row_number", "rank", "dense_rank", "lag", "lead", "sum", "mean", "min", "max",
             "count", "var", "std", "var_pop", "stddev_pop", "cumsum"]
VAR_STD = ("var", "std", "var_pop", "stddev_pop")
SOURCES = ["INT32", "INT64", "FLOAT64"]
CUMSUM_REL = 2.0**-40


def _draw(seed, n=N, parts=7, null_parts=False):
    """Host columns: p (INT32 partition), o (INT32 order, ties on purpose)
    and one source of each type, every source with nulls."""
    rng = np.random.default_rng(seed)
    cols = {
        "p": (rng.integers(0, parts, n).astype(np.int32),
              rng.random(n) >= 0.05 if null_parts else None),
        "o": (rng.integers(0, 50, n).astype(np.int32), None),
        "INT32": (rng.integers(-1000, 1000, n).astype(np.int32), rng.random(n) >= 0.15),
        "INT64": (rng.integers(-(10**12), 10**12, n), rng.random(n) >= 0.15),
        "FLOAT64": ((rng.standard_normal(n) * 10.0 ** rng.integers(-3, 6, n)).round(4),
                    rng.random(n) >= 0.15),
    }
    return cols


def _tables(cols):
    """(port Table on the CPU, JAX Table) holding the same bits."""
    types = {"p": "INT32", "o": "INT32", "INT32": "INT32", "INT64": "INT64",
             "FLOAT64": "FLOAT64"}
    pcols, jcols = [], []
    for name, (data, valid) in cols.items():
        pcols.append(Column.from_numpy(data, getattr(pdt, types[name]), valid, device="cpu"))
        jc = JColumn.from_numpy(data, getattr(jdt, types[name]))
        jcols.append(jc if valid is None else JColumn(jc.dtype, data=jc.data,
                                                      validity=jnp.asarray(valid)))
    return Table(pcols, list(cols)), JTable(jcols, list(cols))


def _jax_arrays(jt: JTable):
    return ([np.asarray(c.data) for c in jt.columns],
            [None if c.validity is None else np.asarray(c.validity) for c in jt.columns])


def _global_prefix_scale(cols, src, partition_by, order_by):
    """Per row, the running max of |global prefix| of a FLOAT64 cumsum:
    the sorted buffer's plain cumsum (nulls as 0), sorted as the window
    sorts (partition keys nulls first, then the order keys, stable)."""
    keys = []
    for name in partition_by:
        data, valid = cols[name]
        keys.append(np.where(valid, data.astype(np.int64), -1) if valid is not None else data)
    for name, asc in order_by:
        keys.append(cols[name][0] if asc else -cols[name][0].astype(np.int64))
    n = len(cols[src][0])
    order = np.lexsort(keys[::-1]) if keys else np.arange(n)
    data, valid = cols[src]
    prefix = np.cumsum(np.where(valid, data, 0.0)[order])
    scale = np.empty(n)
    scale[order] = np.maximum.accumulate(np.abs(prefix))
    return scale


def _compare(got: Table, want: JTable, cols=None, src=None, partition_by=(), order_by=()):
    assert got.names == want.names and got.num_rows == want.num_rows
    assert [c.dtype.id.name for c in got.columns] == [c.dtype.id.name for c in want.columns]
    arrays, valids = table_to_numpy(got)
    warrays, wvalids = _jax_arrays(want)
    for name, jc, a, v, w, wv in zip(got.names, want.columns, arrays, valids, warrays, wvalids):
        assert (v is None) == (wv is None), name
        if v is not None:
            np.testing.assert_array_equal(v, wv, err_msg=name)
        how = name.split(":")[0]
        if how in VAR_STD:
            np.testing.assert_allclose(a.view(np.float64), w.view(np.float64), rtol=1e-9,
                                       err_msg=name)
        elif how == "cumsum" and jc.dtype.id == jdt.TypeId.FLOAT64:
            scale = _global_prefix_scale(cols, src, partition_by, order_by)
            err = np.abs(a.view(np.float64) - w.view(np.float64))
            assert (err <= CUMSUM_REL * scale).all(), (name, err.max())
        else:
            np.testing.assert_array_equal(a.view(np.uint8), w.view(np.uint8), err_msg=name)


def _run(cols, partition_by, order_by, aggs):
    pt, jt = _tables(cols)
    return window_aggregate(pt, partition_by, order_by, aggs), jwindow(jt, partition_by,
                                                                        order_by, aggs)


_COLS = {}


def _cols(seed, **kw):
    key = (seed, tuple(sorted(kw.items())))
    if key not in _COLS:
        _COLS[key] = _draw(seed, **kw)
    return _COLS[key]


# -- every function over every source type ----------------------------------------


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("how", FUNCTIONS)
def test_function_matches_reference(how, src):
    cols = _cols(3)
    part, order = ["p"], [("o", True)]
    got, want = _run(cols, part, order, [(src, how, f"{how}:{src}")])
    _compare(got, want, cols, src, part, order)


# -- the classes of tests/test_window.py ----------------------------------------------


class TestRanks:
    def test_row_number_rank_dense_rank(self):
        got, want = _run(_cols(5), ["p"], [("o", True)],
                         [("o", "row_number", "rn"), ("o", "rank", "rk"),
                          ("o", "dense_rank", "dk")])
        _compare(got, want)

    def test_descending_order(self):
        got, want = _run(_cols(5), ["p"], [("o", False)], [("o", "rank", "rk")])
        _compare(got, want)

    def test_null_partition_keys_group_together(self):
        cols = _cols(6, null_parts=True)
        got, want = _run(cols, ["p"], [("o", True), ("INT32", False)],
                         [("o", "rank", "rk"), ("o", "dense_rank", "dk"),
                          ("INT64", "lag", "lg"), ("FLOAT64", "sum", "s")])
        _compare(got, want)


class TestPartitionAggs:
    def test_sum_mean_count_exact_f64(self):
        got, want = _run(_cols(7), ["p"], [],
                         [("FLOAT64", "sum", "s"), ("FLOAT64", "mean", "m"),
                          ("FLOAT64", "count", "c")])
        _compare(got, want)

    def test_min_max(self):
        got, want = _run(_cols(7), ["p"], [],
                         [("FLOAT64", "min", "lo"), ("FLOAT64", "max", "hi"),
                          ("INT64", "min", "ilo"), ("INT32", "max", "ihi")])
        _compare(got, want)

    def test_var_std_family(self):
        got, want = _run(_cols(7), ["p"], [],
                         [("FLOAT64", h, f"{h}:FLOAT64") for h in VAR_STD])
        _compare(got, want)


class TestFramesAndShifts:
    @pytest.mark.parametrize("src", SOURCES)
    def test_cumsum_unique_order(self, src):
        # a unique order key: the scan's order is the partition's own
        cols = dict(_cols(8))
        cols["o"] = (np.random.default_rng(1).permutation(N).astype(np.int32), None)
        part, order = ["p"], [("o", True)]
        got, want = _run(cols, part, order, [(src, "cumsum", f"cumsum:{src}")])
        _compare(got, want, cols, src, part, order)

    def test_lag_lead(self):
        got, want = _run(_cols(8), ["p"], [("o", True)],
                         [("INT64", "lag", "lg"), ("INT64", "lead", "ld"),
                          ("FLOAT64", "lag", "flg"), ("INT32", "lead", "ild")])
        _compare(got, want)


class TestEdges:
    def test_single_partition(self):
        cols = _cols(9)
        order = [("o", True)]
        aggs = [(s, h, f"{h}:{s}") for s in ("FLOAT64", "INT32")
                for h in ("row_number", "rank", "cumsum", "sum", "var")]
        got, want = _run(cols, [], order, aggs)
        _compare(got, want, cols, "FLOAT64", [], order)

    @pytest.mark.parametrize("src", SOURCES)
    def test_empty_table(self, src):
        cols = {k: (v[0][:0], None if v[1] is None else v[1][:0]) for k, v in _cols(9).items()}
        aggs = [(src, h, f"{h}:{src}") for h in FUNCTIONS]
        part, order = ["p"], [("o", True)]
        got, want = _run(cols, part, order, aggs)
        _compare(got, want, cols, src, part, order)

    def test_unknown_function_raises(self):
        pt, _ = _tables(_cols(9))
        with pytest.raises(ValueError, match="unknown window function"):
            window_aggregate(pt, ["p"], [], [("FLOAT64", "median", "m")])


class TestSatelliteGuards:
    @pytest.mark.parametrize("how", ["rank", "dense_rank", "lag", "lead", "cumsum"])
    def test_order_defined_functions_require_order_by(self, how):
        pt, _ = _tables(_cols(9))
        with pytest.raises(ValueError, match="order_by"):
            window_aggregate(pt, ["p"], [], [("FLOAT64", how, "x")])

    def test_var_std_reject_non_numeric(self):
        n = 16
        t = Table([Column.from_numpy(np.zeros(n, np.int32), pdt.INT32, device="cpu"),
                   Column.from_numpy(np.ones(n, np.uint8), pdt.BOOL8, device="cpu")], ["p", "b"])
        for how in VAR_STD:
            with pytest.raises(ValueError, match="numeric"):
                window_aggregate(t, ["p"], [], [("b", how, "x")])


def test_f64_cumsum_small_partition_after_a_large_one_follows_the_reference():
    """A fault of the reference, kept for parity: a FLOAT64 cumsum is the
    GLOBAL scan minus the running total at the segment's entry, so a
    partition of small values sorted after a partition with a large sum
    loses its low bits (its cumsum is not the partition's own)."""
    vals = np.array([1e16, 0.1, 0.2, 0.3])
    cols = {"p": (np.array([0, 1, 1, 1], np.int32), None),
            "o": (np.arange(4, dtype=np.int32), None),
            "FLOAT64": (vals, np.ones(4, bool))}
    part, order = ["p"], [("o", True)]
    got, want = _run(cols, part, order, [("FLOAT64", "cumsum", "cumsum:FLOAT64")])
    _compare(got, want, cols, "FLOAT64", part, order)
    out = got.column("cumsum:FLOAT64").to_numpy().view(np.float64)
    assert out[1:].tolist() != np.cumsum(vals[1:]).tolist()
    assert out[1:].tolist() == [0.0, 0.0, 0.0]  # 1e16 + 0.1 rounds back to 1e16

