"""The check fails what it has to fail. A run is driven on the CPU at a
small size (the look for a card skipped) with the timed path broken
underneath, once a fault the cell can have, and ``correct`` has to come
out false; the control (the reference in the program's place, in the
precision below the configuration's) has to fail a limit too. The cells
run one chip and hold no state from item to item, so a state returned
unchanged and a missing exchange between chips are not faults they can
have."""

import time

import pytest
import torch

from portbench import harness
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.models import tpch
from spark_rapids_jni_tpu_torch.ops import aggregate
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

CPU = torch.device("cpu")


def _run(cell, seed=2**31 + 17):
    return harness.run_cell(cell, seed, 0.2, False, CPU, time.perf_counter())


def _failed(res):
    return sorted(k for k, c in res["checks"].items() if not c["value"] <= c["limit"])


def _altered_rows(real):
    def fake(table):
        out = real(table)
        out[0].child.data[17] ^= 1
        return out
    return fake


def _altered_decode(real):
    def fake(rows, dtypes):
        t = real(rows, dtypes)
        cols = list(t.columns)
        data = cols[5].data.clone()
        data[3] += 1
        cols[5] = Column(cols[5].dtype, data=data, validity=cols[5].validity)
        return Table(cols, t.names)
    return fake


def _half_groupby(real):
    def fake(keys, vals, num_keys, *a, **k):
        h = keys.shape[0] // 2
        sums, counts = real(keys[:h], vals[:h], num_keys, *a, **k)
        return sums * 2, counts * 2  # the rest's mean times the whole count
    return fake


def _half_query(real):
    def fake(lineitem, *a, **k):
        h = lineitem.num_rows // 2
        return real(Table([Column(c.dtype, data=c.data[:h]) for c in lineitem.columns],
                          lineitem.names), *a, **k)
    return fake


def _altered_query(real):
    def fake(lineitem, *a, **k):
        out = real(lineitem, *a, **k)
        cols = list(out.columns)
        i = out.names.index("price_sum")
        data = cols[i].data.clone()
        data[0] += 1  # one ulp of the float64 in its int64 bits
        cols[i] = Column(cols[i].dtype, data=data)
        return Table(cols, out.names)
    return fake


FAULTS = [
    ("rowconv_fixed212.roundtrip", rc, "convert_to_rows", _altered_rows, "blob_bytes_off"),
    ("rowconv_fixed212.roundtrip", aggregate, "groupby_sum_bounded", _half_groupby, "counts_off"),
    ("rowconv_fixed212.decode", rc, "convert_from_rows", _altered_decode, "values_off"),
    ("rowconv_fixed212.decode", aggregate, "groupby_sum_bounded", _half_groupby, "counts_off"),
    ("tpch_sf1.q1", tpch, "q1", _half_query, "kept_rows_off"),
    ("tpch_sf1.q1", tpch, "q1", _altered_query, "values_off"),
]


@pytest.mark.parametrize("name,module,attr,fault,number", FAULTS,
                         ids=[f"{f[0]}-{f[3].__name__.strip('_')}" for f in FAULTS])
def test_a_broken_path_is_not_correct(small_cell, monkeypatch, name, module, attr, fault, number):
    cell = small_cell(name)
    assert _run(cell)["correct"]
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    res = _run(cell)
    assert res["correct"] is False
    assert number in _failed(res), res["checks"]


@pytest.mark.parametrize("name,number", [("rowconv_fixed212.roundtrip", "sum_gap"),
                                         ("rowconv_fixed212.decode", "sum_gap"),
                                         ("tpch_sf1.q1", "values_off")])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_the_control_is_not_correct(small_cell, name, number, seed):
    cell = small_cell(name)
    dataset, item = harness.load_module(cell["dataset"]), harness.load_module(cell["item"])
    st = item.prepare(cell["cfg"], cell["mix"], dataset.make(cell["cfg"], seed, CPU), CPU)
    got = item.judge(st, item.control(st), [])
    assert got[number] > cell["limits"][number], got
