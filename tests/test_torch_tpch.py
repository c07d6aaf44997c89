"""Port: models/datagen, models/tpch and models/compiled against the JAX
package. The same seed gives the same table bits in both packages; q1
and q6 on the operator tier and through the compiled pipeline give the
same result bits as the reference's, at a few thousand rows, on the
adversarial magnitudes of the reference's own test (prices spanning 18
decades), and the compiled tier equals the operator tier bit for bit.
Exact sums are also held against rational oracles (``fractions``). q6's
checks are in ``test_torch_tpch_q6.py``, which takes its lineitem from
here."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.models import compiled as jcomp
from spark_rapids_jni_tpu.models import datagen as jgen
from spark_rapids_jni_tpu.models import tpch as jtpch

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import table_to_numpy
from spark_rapids_jni_tpu_torch.models import compiled as pcomp
from spark_rapids_jni_tpu_torch.models import datagen as pgen
from spark_rapids_jni_tpu_torch.models import tpch as ptpch


def _assert_tables_equal(pt: Table, jt: JTable):
    assert pt.names == jt.names and pt.num_rows == jt.num_rows
    arrays, valids = table_to_numpy(pt)
    for name, jc, a, v in zip(pt.names, jt.columns, arrays, valids):
        want_v = None if jc.validity is None else np.asarray(jc.validity)
        assert (v is None) == (want_v is None), name
        if v is not None:
            np.testing.assert_array_equal(v, want_v, err_msg=name)
        if jc.dtype.id == jdt.TypeId.STRING:
            np.testing.assert_array_equal(a[0], np.asarray(jc.offsets), err_msg=name)
            np.testing.assert_array_equal(a[1], np.asarray(jc.chars), err_msg=name)
        else:
            np.testing.assert_array_equal(a.view(np.uint8), np.asarray(jc.data).view(np.uint8),
                                          err_msg=name)


# -- datagen ------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(0, 1), (1, 2), (3000, 5), (10_007, 42)])
def test_gen_lineitem_bit_identical(n, seed):
    _assert_tables_equal(ptpch.gen_lineitem(n, seed=seed, device="cpu"),
                         jtpch.gen_lineitem(n, seed=seed))


TYPE_NAMES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64",
              "FLOAT32", "FLOAT64", "BOOL8", "TIMESTAMP_DAYS", "DECIMAL128", "STRING"]


def _types(mod):
    return [mod.decimal128(-2) if t == "DECIMAL128" else getattr(mod, t) for t in TYPE_NAMES]


@pytest.mark.parametrize("dist", ["UNIFORM", "NORMAL", "GEOMETRIC"])
@pytest.mark.parametrize("nulls", [0.0, 0.3])
def test_create_random_table_bit_identical(dist, nulls):
    def profiles(gen):
        return {i: gen.Profile(distribution=getattr(gen.Distribution, dist),
                               null_probability=nulls, min_length=1, max_length=12)
                for i in range(len(TYPE_NAMES))}

    got = pgen.create_random_table(_types(pdt), 500, seed=9, profiles=profiles(pgen),
                                   names=TYPE_NAMES, device="cpu")
    want = jgen.create_random_table(_types(jdt), 500, seed=9, profiles=profiles(jgen),
                                    names=TYPE_NAMES)
    _assert_tables_equal(got, want)


def test_create_random_table_default_profiles_and_ranges():
    got = pgen.create_random_table(_types(pdt), 300, seed=11, device="cpu")
    _assert_tables_equal(got, jgen.create_random_table(_types(jdt), 300, seed=11))
    p = {0: pgen.Profile(lower=5, upper=9, null_probability=0.3)}
    t = pgen.create_random_table([pdt.INT32], 1000, seed=1, profiles=p, device="cpu")
    vals = t.column(0).to_numpy()
    assert vals.min() >= 5 and vals.max() <= 9
    assert 200 < int((~t.column(0).validity).sum()) < 400


def test_cycle_dtypes():
    out = pgen.cycle_dtypes([pdt.INT8, pdt.INT64], 5)
    assert [d.id for d in out] == [pdt.INT8.id, pdt.INT64.id, pdt.INT8.id, pdt.INT64.id,
                                   pdt.INT8.id]


# -- q1 / q6 ------------------------------------------------------------------------

_LINEITEM = {}


def _lineitem(n, seed):
    if (n, seed) not in _LINEITEM:
        _LINEITEM[(n, seed)] = (jtpch.gen_lineitem(n, seed=seed),
                                ptpch.gen_lineitem(n, seed=seed, device="cpu"))
    return _LINEITEM[(n, seed)]


@pytest.mark.parametrize("n,seed,delta", [(3000, 5, 90), (3000, 5, 60), (3000, 5, -3000),
                                          (7001, 22, 120)])
def test_q1_bit_identical(n, seed, delta):
    jl, pl = _lineitem(n, seed)
    _assert_tables_equal(ptpch.q1(pl, delta_days=delta), jtpch.q1(jl, delta_days=delta))


@pytest.mark.parametrize("n,seed", [(8000, 22)])
def test_q1_fused_bit_identical(n, seed):
    jl, pl = _lineitem(n, seed)
    got = pcomp.q1_fused(pl)
    want = jcomp.q1_fused(jl)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8), err_msg=k)


def _q1_op_dense(out: Table):
    """The operator tier's q1 rows as the fused tier's dense [6] arrays."""
    slot = out.column("l_returnflag").to_numpy() * 2 + out.column("l_linestatus").to_numpy()
    res = {}
    for op, fused in [("qty_sum", "qty_sum"), ("price_sum", "price_sum"),
                      ("disc_price_sum", "disc_price_sum"), ("charge_sum", "charge_sum"),
                      ("qty_mean", "qty_mean"), ("price_mean", "price_mean"),
                      ("disc_mean", "disc_mean")]:
        dense = np.zeros(6, np.float64)
        dense[slot] = out.column(op).to_numpy().view(np.float64)
        res[fused] = dense
    cnt = np.zeros(6, np.int64)
    cnt[slot] = out.column("qty_count_all").to_numpy()
    res["count"] = cnt
    return res


@pytest.mark.parametrize("n,seed", [(3000, 5), (7001, 22), (30_000, 21)])
def test_fused_equals_op_tier_bit_for_bit(n, seed):
    _, pl = _lineitem(n, seed)
    op = _q1_op_dense(ptpch.q1(pl))
    fused = pcomp.q1_fused(pl)
    for k in op:
        np.testing.assert_array_equal(fused[k].view(np.uint8), op[k].view(np.uint8), err_msg=k)
    assert pcomp.q6_fused(pl) == ptpch.q6(pl)


def _adversarial(n=8000, seed=99):
    """The reference's adversarial q1 input (tests/test_models.py): prices
    spanning ~18 decades, in both packages."""
    jl, pl = jtpch.gen_lineitem(n, seed=seed), ptpch.gen_lineitem(n, seed=seed, device="cpu")
    rng = np.random.default_rng(7)
    price = rng.uniform(1.0, 10.0, n) * (10.0 ** rng.integers(-8, 10, n).astype(np.float64))
    idx = jl.names.index("l_extendedprice")
    jcols, pcols = list(jl.columns), list(pl.columns)
    jcols[idx] = JColumn.from_numpy(price, jdt.FLOAT64)
    pcols[idx] = Column.from_numpy(price, pdt.FLOAT64, device="cpu")
    return JTable(jcols, jl.names), Table(pcols, pl.names)


def test_q1_adversarial_magnitudes_bit_identical_and_exact():
    jl, pl = _adversarial()
    got = ptpch.q1(pl)
    _assert_tables_equal(got, jtpch.q1(jl))
    # each sum is the correctly rounded float64 of the exact sum of the
    # row products (each product one float64 rounding)
    ship = pl.column("l_shipdate").to_numpy()
    keep = ship <= ptpch.D_1998_12_01 - 90
    price = pl.column("l_extendedprice").to_numpy().view(np.float64)[keep]
    disc = pl.column("l_discount").to_numpy().view(np.float64)[keep]
    rf = pl.column("l_returnflag").to_numpy()[keep]
    ls = pl.column("l_linestatus").to_numpy()[keep]
    disc_price = price * (1.0 - disc)
    sums = got.column("disc_price_sum").to_numpy().view(np.float64)
    means = got.column("price_mean").to_numpy().view(np.float64)
    for i, (r, s) in enumerate(zip(got.column("l_returnflag").to_numpy(),
                                   got.column("l_linestatus").to_numpy())):
        members = (rf == r) & (ls == s)
        exact = sum(Fraction(float(v)) for v in disc_price[members])
        assert sums[i] == float(exact)
        assert means[i] == float(sum(Fraction(float(v)) for v in price[members])
                                 / int(members.sum()))


def test_fused_adversarial_equals_op_tier():
    jl, pl = _adversarial(8000, seed=3)
    fused = pcomp.q1_fused(pl)
    op = _q1_op_dense(ptpch.q1(pl))
    want = jcomp.q1_fused(jl)
    for k in op:
        np.testing.assert_array_equal(fused[k].view(np.uint8), op[k].view(np.uint8), err_msg=k)
        np.testing.assert_array_equal(fused[k].view(np.uint8), want[k].view(np.uint8), err_msg=k)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptpch.gen_lineitem(10)
