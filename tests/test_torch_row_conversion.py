"""Port: fixed-width JCUDF row transcode
(spark_rapids_jni_tpu_torch.ops.row_conversion) against the JAX package on
the same seeded tables: row blobs and offsets byte-identical, decoded
columns and validity bit-identical. The port runs on CPU tensors, so B6/B7
run as their plain versions."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import Column, dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

# the _random_table schema of tests/test_lane_relayout.py plus the other
# integer types and DECIMAL128
SCHEMA = ["INT8", "INT64", "INT16", "FLOAT64", "UINT32", "BOOL8", "FLOAT32", "UINT16",
          "INT32", "UINT8", "UINT64", "DECIMAL128"]


def _dtypes(names):
    j = [jdt.decimal128(-2) if nm == "DECIMAL128" else getattr(jdt, nm) for nm in names]
    p = [pdt.decimal128(-2) if nm == "DECIMAL128" else getattr(pdt, nm) for nm in names]
    return j, p


def _make(rng, names, n, nulls_every=3):
    """Seeded storage arrays + validity -> (JAX Table, port Table, dtypes)."""
    jd, pd = _dtypes(names)
    arrays, valids = [], []
    for i, d in enumerate(jd):
        if d.id == jdt.TypeId.BOOL8:
            a = rng.integers(0, 2, n).astype(bool)
        elif d.id == jdt.TypeId.FLOAT32:
            a = rng.standard_normal(n).astype(np.float32)
        elif d.id == jdt.TypeId.FLOAT64:
            a = rng.standard_normal(n).view(np.uint64)
        elif d.id == jdt.TypeId.DECIMAL128:
            a = rng.integers(0, 2**32, (n, 4), dtype=np.uint32)
        else:
            info = np.iinfo(d.np_dtype)
            a = rng.integers(info.min, info.max, n, dtype=d.np_dtype, endpoint=True)
        arrays.append(a)
        valids.append(rng.integers(0, 2, n).astype(bool) if i % nulls_every == 0 else None)
    jt = JTable([JColumn(d, data=jnp.asarray(a), validity=None if v is None else jnp.asarray(v))
                 for d, a, v in zip(jd, arrays, valids)])
    pt = carry_table(arrays, pd, valids, device="cpu")
    return jt, pt, jd, pd


def _blob(col):
    return np.asarray(col.child.data).view(np.uint8)


def _assert_rows_equal(jrows, prows):
    assert len(jrows) == len(prows)
    for j, p in zip(jrows, prows):
        np.testing.assert_array_equal(p.child.data.numpy().view(np.uint8), _blob(j))
        np.testing.assert_array_equal(p.offsets.numpy(), np.asarray(j.offsets))
        assert p.offsets.dtype == torch.int32


def _assert_tables_equal(jtab, ptab):
    assert jtab.num_columns == ptab.num_columns and jtab.num_rows == ptab.num_rows
    for i, (a, b) in enumerate(zip(jtab.columns, ptab.columns)):
        x, y = np.asarray(a.data), b.to_numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8), err_msg=f"column {i}")
        np.testing.assert_array_equal(b.valid_mask().numpy(), np.asarray(a.valid_mask()))


@pytest.mark.parametrize("n", [1, 7, 8, 257, 1000])
def test_convert_to_rows_blob_identical(rng, n):
    jt, pt, _, _ = _make(rng, SCHEMA, n)
    _assert_rows_equal(jrc.convert_to_rows(jt), prc.convert_to_rows(pt))


@pytest.mark.parametrize("n", [1, 7, 8, 257, 1000])
def test_convert_from_rows_bit_identical(rng, n):
    jt, pt, jd, pd = _make(rng, SCHEMA, n)
    jrows = jrc.convert_to_rows(jt)
    prows = prc.convert_to_rows(pt)
    _assert_tables_equal(jrc.convert_from_rows(jrows[0], jd), prc.convert_from_rows(prows[0], pd))


def test_round_trip_restores_inputs(rng):
    jt, pt, _, pd = _make(rng, SCHEMA, 300)
    back = prc.convert_from_rows(prc.convert_to_rows(pt)[0], pd)
    for a, b in zip(pt.columns, back.columns):
        np.testing.assert_array_equal(b.to_numpy().view(np.uint8), a.to_numpy().view(np.uint8))
        np.testing.assert_array_equal(b.valid_mask().numpy(), a.valid_mask().numpy())


def test_decode_without_stride_marker_probes_offsets(rng):
    # rows made by the JAX package carry no producer stride: the port
    # checks the offsets on the device and takes the uniform path
    jt, _, jd, pd = _make(rng, SCHEMA, 64)
    jrows = jrc.convert_to_rows(jt)[0]
    offs = torch.from_numpy(np.asarray(jrows.offsets).copy())
    child = Column(pdt.INT8, data=torch.from_numpy(_blob(jrows).view(np.int8).copy()))
    prows = Column.list_from_parts(offs, child)
    _assert_tables_equal(jrc.convert_from_rows(jrows, jd), prc.convert_from_rows(prows, pd))


def test_decode_gathered_rows(rng):
    # rows with gaps between them: not uniform, so each row's fixed
    # section is gathered before the plane decode
    jt, _, jd, pd = _make(rng, ["INT8", "INT16", "INT64", "FLOAT32", "BOOL8"], 40)
    layout = jrc.compute_row_layout(jd)
    jrows = jrc.convert_to_rows(jt)[0]
    rs = layout.row_size_fixed
    src = _blob(jrows).reshape(40, rs)
    stride = rs + 8
    blob = np.zeros(40 * stride, np.uint8)
    blob.reshape(40, stride)[:, :rs] = src
    offs = (np.arange(41) * stride).astype(np.int32)
    jgap = JColumn.list_from_parts(
        jnp.asarray(offs), JColumn(jdt.INT8, data=jnp.asarray(blob.view(np.int8))))
    pgap = Column.list_from_parts(
        torch.from_numpy(offs), Column(pdt.INT8, data=torch.from_numpy(blob.view(np.int8).copy())))
    _assert_tables_equal(jrc.convert_from_rows(jgap, jd), prc.convert_from_rows(pgap, pd))


def test_single_column_table(rng):
    jt, pt, jd, pd = _make(rng, ["INT16"], 33, nulls_every=1)
    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    _assert_rows_equal(jrows, prows)
    _assert_tables_equal(jrc.convert_from_rows(jrows[0], jd), prc.convert_from_rows(prows[0], pd))


def test_empty_table(rng):
    jt, pt, jd, pd = _make(rng, SCHEMA, 0)
    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    _assert_rows_equal(jrows, prows)
    back = prc.convert_from_rows(prows[0], pd)
    assert back.num_rows == 0 and back.num_columns == len(SCHEMA)
    assert tuple(back.columns[-1].data.shape) == (0, 4)
    _assert_tables_equal(jrc.convert_from_rows(jrows[0], jd), back)


@pytest.mark.parametrize("names", [SCHEMA, ["INT8"], ["INT8", "INT64"], ["BOOL8"] * 17,
                                   ["INT16", "DECIMAL128", "INT8", "STRING", "FLOAT64"]])
def test_compute_row_layout_matches_jax(names):
    jd, pd = _dtypes(names)
    j, p = jrc.compute_row_layout(jd), prc.compute_row_layout(pd)
    assert dataclass_tuple(p) == dataclass_tuple(j)


def dataclass_tuple(layout):
    return (layout.col_starts, layout.col_sizes, layout.validity_offset, layout.fixed_end,
            layout.variable_cols, layout.row_size_fixed)


@pytest.mark.parametrize("sizes", [
    np.full(0, 8), np.full(1000, 792), np.full(3, (1 << 30) + 8), np.array([8, 1 << 31, 8]),
])
def test_batch_boundaries_match_jax(sizes):
    sizes = np.asarray(sizes, np.int64)
    try:
        want = jrc._batch_boundaries(sizes)
    except ValueError as e:
        with pytest.raises(ValueError, match="2GiB"):
            prc._batch_boundaries(sizes)
        assert "2GiB" in str(e)
        return
    assert prc._batch_boundaries(sizes) == want


def test_batch_split_matches_jax(rng, monkeypatch):
    # a small batch ceiling in both packages: the 2 GiB split runs at toy size
    monkeypatch.setattr(jrc, "MAX_BATCH_BYTES", 2000)
    monkeypatch.setattr(prc, "MAX_BATCH_BYTES", 2000)
    jt, pt, jd, pd = _make(rng, SCHEMA, 100)
    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    assert len(prows) > 1
    _assert_rows_equal(jrows, prows)
    for j, p in zip(jrows, prows):
        _assert_tables_equal(jrc.convert_from_rows(j, jd), prc.convert_from_rows(p, pd))


def test_entry_plan_matches_jax():
    jd, pd = _dtypes(SCHEMA)
    jl, pl = jrc.compute_row_layout(jd), prc.compute_row_layout(pd)
    assert prc._entry_plan(pl, pd) == jrc._entry_plan(jl, jd)


def test_grouped_decode_matches_jax(rng):
    jt, pt, jd, pd = _make(rng, SCHEMA, 200)
    jg = jrc.convert_from_rows_grouped(jrc.convert_to_rows(jt)[0], jd)
    pg = prc.convert_from_rows_grouped(prc.convert_to_rows(pt)[0], pd)
    assert list(pg.groups) == list(jg.groups) and len(pg) == len(jg)
    for key in jg.groups:
        want = np.asarray(jg.groups[key])
        got = pg.groups[key].numpy()
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=key)
    np.testing.assert_array_equal(pg.valid_t.numpy(), np.asarray(jg.valid_t))
    _assert_tables_equal(jg.to_table(), pg.to_table())
    for i in (0, 3, 11):
        x, y = np.asarray(jg.column(i).data), pg.column(i).to_numpy()
        np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8))


def test_grouped_decode_empty(rng):
    _, pt, _, pd = _make(rng, SCHEMA, 0)
    pg = prc.convert_from_rows_grouped(prc.convert_to_rows(pt)[0], pd)
    assert len(pg) == 0 and pg.to_table().num_rows == 0


def test_fixed_width_optimized_entries_match_jax(rng):
    names = SCHEMA[:9]
    jt, pt, jd, pd = _make(rng, names, 120)
    jrows = jrc.convert_to_rows_fixed_width_optimized(jt)
    prows = prc.convert_to_rows_fixed_width_optimized(pt)
    _assert_rows_equal(jrows, prows)
    _assert_tables_equal(jrc.convert_from_rows_fixed_width_optimized(jrows[0], jd),
                         prc.convert_from_rows_fixed_width_optimized(prows[0], pd))


@pytest.mark.parametrize("names,match", [
    (["INT8"] * 100, "< 100 columns"),
    (["DECIMAL128"] * 64 + ["INT8"], "1KB"),
    (["INT8", "STRING"], "fixed-width types"),
])
def test_fixed_width_optimized_limit_errors(names, match):
    jd, pd = _dtypes(names)
    with pytest.raises(ValueError, match=match):
        jrc._check_optimized(jd)
    with pytest.raises(ValueError, match=match):
        prc._check_optimized(pd)
    rows = Column.list_from_parts(torch.zeros(1, dtype=torch.int32),
                                  Column(pdt.INT8, data=torch.zeros(0, dtype=torch.int8)))
    with pytest.raises(ValueError, match=match):
        prc.convert_from_rows_fixed_width_optimized(rows, pd)


def test_string_schema_not_ported():
    rows = Column.list_from_parts(torch.zeros(1, dtype=torch.int32),
                                  Column(pdt.INT8, data=torch.zeros(0, dtype=torch.int8)))
    with pytest.raises(NotImplementedError, match="item 4"):
        prc.convert_from_rows(rows, [pdt.INT32, pdt.STRING])
    with pytest.raises(NotImplementedError, match="item 4"):
        prc.convert_from_rows_grouped(rows, [pdt.STRING])
    with pytest.raises(NotImplementedError, match="item 4"):
        Column(pdt.STRING)


def test_rejects_non_list_rows():
    with pytest.raises(ValueError, match="LIST"):
        prc.convert_from_rows(Column(pdt.INT8, data=torch.zeros(8, dtype=torch.int8)), [pdt.INT8])
