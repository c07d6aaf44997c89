"""The reference's layout, encoder, decoder, group-by and q1 agree with
``chip_smoke.py``'s oracles and the program's layout at small sizes."""

import ast

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import harness
from portbench.datasets import jcudf_table
from portbench.reference import groupby, jcudf, tpch
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

ROWS = 1500


def _smoke_table(seed):
    dtypes = chip_smoke._schema(pdt)
    arrays, valids = chip_smoke._host_table(dtypes, ROWS, seed)
    return dtypes, arrays, valids


def _upstream_types():
    """The nine types the repo's record of the upstream benchmark cycles
    (``benchmarks/microbench.py``), read from its source: importing it
    would load JAX."""
    src = (harness.ROOT / "benchmarks" / "microbench.py").read_text()
    node = next(n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "_NINE_INT_TYPES")
    return [e.attr for e in node.value.elts]


def test_schema_is_the_upstream_record(bench):
    cfg = harness.resolve(bench, "rowconv_fixed212.roundtrip")["cfg"]
    nine = _upstream_types()
    assert jcudf_table.schema(cfg) == [nine[i % 9] for i in range(212)]
    data = jcudf_table.make(dict(cfg, rows=64), 3, torch.device("cpu"))
    assert data["valids"] == [None] * 212


def test_layout_is_the_programs(bench):
    cfg = harness.resolve(bench, "rowconv_fixed212.roundtrip")["cfg"]
    for types in (jcudf_table.schema(cfg), [d.id.name for d in chip_smoke._schema(pdt)]):
        want = rc.compute_row_layout([getattr(pdt, t) for t in types])
        got = jcudf.layout(types)
        assert got.starts == want.col_starts
        assert got.validity_offset == want.validity_offset
        assert got.row_size == want.row_size_fixed
    assert jcudf.layout(jcudf_table.schema(cfg)).row_size == 784


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_encoder_is_chip_smokes_oracle(seed):
    dtypes, arrays, valids = _smoke_table(seed)
    lay = jcudf.layout([d.id.name for d in dtypes])
    cols = [torch.from_numpy(np.ascontiguousarray(a).view(jcudf_np(d))) for a, d in zip(arrays, dtypes)]
    vt = [None if v is None else torch.from_numpy(v) for v in valids]
    got = jcudf.encode(lay, cols, vt, 0, ROWS).numpy()
    want = chip_smoke._oracle_rows(rc.compute_row_layout(dtypes), arrays, valids, ROWS)
    np.testing.assert_array_equal(got, want)
    dec_cols, dec_valid = jcudf.decode(lay, [d.id.name for d in dtypes], torch.from_numpy(got))
    for c, a, v, dv in zip(dec_cols, cols, valids, dec_valid):
        assert torch.equal(c, a)
        assert torch.equal(dv, torch.ones(ROWS, dtype=torch.bool) if v is None else torch.from_numpy(v))


def jcudf_np(d):
    """The numpy view of a column's storage type."""
    return torch.empty(0, dtype=jcudf.STORAGE[d.id.name]).numpy().dtype


def test_encoder_is_the_programs_encoder():
    dtypes, arrays, valids = _smoke_table(11)
    table = Table([Column.from_numpy(a, d, validity=v, device="cpu")
                   for a, d, v in zip(arrays, dtypes, valids)])
    (rows,) = rc.convert_to_rows(table)
    lay = jcudf.layout([d.id.name for d in dtypes])
    cols = [c.data for c in table.columns]
    got = jcudf.encode(lay, cols, [c.validity for c in table.columns], 0, ROWS).view(-1)
    assert torch.equal(rows.child.data.view(torch.uint8), got)


def test_batches_split_as_the_program_does(bench):
    cfg = harness.resolve(bench, "rowconv_fixed212.roundtrip")["cfg"]
    lay = jcudf.layout(jcudf_table.schema(cfg))
    n = cfg["rows"]
    want = rc._batch_boundaries(np.full((n,), lay.row_size, dtype=np.int64))
    assert jcudf.batch_rows(lay, n) == [(r0, r1) for r0, r1, _ in want]
    assert len(want) == 2


def test_bounded_sum_is_chip_smokes_check():
    _, arrays, _ = _smoke_table(5)
    keys, vals = torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1])
    sums, counts, mags = groupby.bounded_sum(keys, vals, chip_smoke.NUM_KEYS)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(arrays[0], minlength=chip_smoke.NUM_KEYS))
    want = np.bincount(arrays[0], weights=arrays[1].astype(np.float64), minlength=chip_smoke.NUM_KEYS)
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-12, atol=1e-9)
    assert groupby.sum_gap(sums, torch.from_numpy(want), mags) < 1e-12
    low, _, _ = groupby.bounded_sum(keys, vals, chip_smoke.NUM_KEYS, torch.bfloat16)
    assert groupby.sum_gap(low, sums, mags) > 1e-4


@pytest.mark.parametrize("seed", [1, 2**31 + 77])
def test_q1_is_chip_smokes_oracle(seed):
    h = tpch.gen_lineitem(30_000, seed)
    names = [n for n, *_ in tpch.LINEITEM]
    kinds = {np.dtype(np.float64): pdt.FLOAT64, np.dtype(np.int8): pdt.INT8,
             np.dtype(np.int32): pdt.TIMESTAMP_DAYS}
    li = Table([Column.from_numpy(h[n], kinds[h[n].dtype], device="cpu") for n in names], names)
    want, _, n_q1, _ = chip_smoke._tpch_oracle(li)
    got, kept = tpch.q1_exact(h)
    assert kept == n_q1
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    x = h["l_extendedprice"]
    g = np.arange(x.shape[0]) % 6
    assert tpch.exact_sums(x, g, 6) == chip_smoke._exact_sums(x, g, 6)


def test_q1_lower_differs_from_exact():
    h = tpch.gen_lineitem(30_000, 9)
    exact, kept = tpch.q1_exact(h)
    low, kept_low = tpch.q1_lower(h, torch.float32, "cpu")
    assert kept == kept_low
    np.testing.assert_array_equal(low["count"], exact["count"])
    assert any(not np.array_equal(low[k], exact[k]) for k in exact if k != "count")


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_lineitem_follows_the_specification(seed):
    n = 60_000
    h = tpch.gen_lineitem(n, seed)
    assert all(h[name].dtype == dtype and h[name].shape == (n,) for name, dtype in tpch.LINEITEM)
    qty = h["l_quantity"]
    assert np.array_equal(qty, np.rint(qty)) and qty.min() == 1 and qty.max() == 50
    for name, top in (("l_discount", 10), ("l_tax", 8)):
        k = np.rint(h[name] * 100)
        assert np.array_equal(h[name], k / 100) and k.min() == 0 and k.max() == top
    unit = h["l_extendedprice"] / qty  # the part's retail price
    cents = np.rint(unit * 100).astype(np.int64)
    assert cents.min() >= 90_000 and cents.max() <= 90_000 + 20_000 + 99_900
    np.testing.assert_array_equal(h["l_extendedprice"], (qty.astype(np.int64) * cents) / 100.0)
    assert np.array_equal(tpch.retail_price_cents(np.array([1, 1000, 199_999])),
                          [90_100, 90_100, 90_000 + 19_999 + 99_900])
    ship, rf, ls = h["l_shipdate"], h["l_returnflag"], h["l_linestatus"]
    assert ship.min() >= 1 and ship.max() <= tpch.D_1998_08_02 + 121
    np.testing.assert_array_equal(ls, ship > tpch.D_1995_06_17)
    assert (rf[ship > tpch.D_1995_06_17] == 1).all()  # shipped after: received after, N
    assert set(rf[ship <= tpch.D_1995_06_17 - 30].tolist()) == {0, 2}  # received by then: A or R
    got, kept = tpch.q1_exact(h)
    share = got["count"] / kept
    assert (got["count"] > 0).tolist() == [True, False, True, True, True, False]
    np.testing.assert_allclose(share[[0, 3, 4]], [0.25, 0.493, 0.25], atol=0.02)
    assert 0.003 < share[2] < 0.012  # N-F, the receipts after a ship on or before the day
