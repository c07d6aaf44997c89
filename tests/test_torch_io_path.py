"""Port: the IO slice as a whole and its harness. The harness writers
(``tests/torch_io_writers.py``) are read back by pyarrow and must give
the source arrays; both packages read the harness's lineitem file to the
same Table; and the footer filter -> ``read_table`` -> ``convert_to_rows``
path on it gives the JAX package's row blob byte for byte. Exact
throughout. ``chip_smoke.py``'s io checks, on the CPU at a small size,
are in ``test_torch_chip_smoke_io.py``."""

import io

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.io import orc_reader as jor
from spark_rapids_jni_tpu.io import parquet_footer as jpf
from spark_rapids_jni_tpu.io import parquet_reader as jpr
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.io import orc_reader as por
from spark_rapids_jni_tpu_torch.io import parquet_footer as ppf
from spark_rapids_jni_tpu_torch.io import parquet_reader as ppr
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

import torch_io_writers as writers
from torch_io_parity import assert_same_tables

SMALL = dict(row_group_bytes=60_000, page_bytes=8_000, dict_bytes=3_000)


def _pa_values(col, c):
    if c.kind == "string":
        offs, chars = c.values
        return [bytes(chars[offs[i]:offs[i + 1]]).decode() for i in range(len(c))]
    a = col.combine_chunks()
    if c.kind == "double":
        return a.to_numpy().view(np.uint64)
    if c.kind == "date":
        return a.to_numpy(zero_copy_only=False).astype("datetime64[D]").astype(np.int64)
    return a.to_numpy(zero_copy_only=False)


def _check_against_source(tab, cols):
    for c in cols:
        got = _pa_values(tab.column(c.name), c)
        if c.kind == "string":
            assert tab.column(c.name).to_pylist() == got
        else:
            assert np.array_equal(got, np.asarray(c.values).astype(got.dtype)), c.name


@pytest.fixture(scope="module")
def lineitem():
    return writers.lineitem_columns(4000, 61)


@pytest.mark.parametrize("codec", ["snappy", None])
def test_parquet_writer_reads_back_in_pyarrow(lineitem, codec):
    data = writers.write_parquet(lineitem, codec, **SMALL)
    md = pq.read_metadata(io.BytesIO(data))
    assert md.num_row_groups > 3 and md.num_rows == 4000
    encs = {md.row_group(0).column(i).path_in_schema: md.row_group(0).column(i).encodings
            for i in range(md.num_columns)}
    assert "PLAIN_DICTIONARY" in encs["l_shipmode"] and "PLAIN" in encs["l_comment"]
    assert md.row_group(0).column(0).compression == ("SNAPPY" if codec else "UNCOMPRESSED")
    tab = pq.read_table(io.BytesIO(data))
    assert tab.schema.field("l_returnflag").type == pa.int8()
    assert tab.schema.field("l_shipdate").type == pa.date32()
    _check_against_source(tab, lineitem)


def test_parquet_writer_writes_nulls(rng):
    n = 3000
    v = rng.random(n) >= 0.3
    cols = [writers.Col("x", "int32", rng.integers(-100, 100, n).astype(np.int32), v),
            writers.Col("d", "double", rng.standard_normal(n), ~v)]
    tab = pq.read_table(io.BytesIO(writers.write_parquet(cols, "snappy", **SMALL)))
    assert tab.column("x").to_pylist() == [int(a) if ok else None for a, ok in zip(cols[0].values, v)]
    assert tab.column("d").to_pylist() == [float(a) if not ok else None
                                          for a, ok in zip(cols[1].values, v)]


def test_orc_writer_reads_back_in_pyarrow(lineitem):
    data = writers.write_orc(lineitem, stripe_bytes=60_000, block=4096)
    f = paorc.ORCFile(io.BytesIO(data))
    assert f.nstripes > 3 and f.nrows == 4000 and f.compression == "ZLIB"
    tab = f.read()
    assert tab.schema.field("l_returnflag").type == pa.int8()
    _check_against_source(tab, lineitem)


def test_orc_writer_streams_decode_in_the_reference(rng):
    vals = rng.integers(-(2**40), 2**40, 1500)
    assert np.array_equal(jor._rle_v2(writers.rle_v2_direct(vals, True), 1500, True), vals)
    u = rng.integers(0, 5000, 700)
    assert np.array_equal(jor._rle_v2(writers.rle_v2_direct(u, False), 700, False), u)
    b = rng.integers(0, 256, 300).astype(np.uint8)
    assert np.array_equal(jor._byte_rle(writers.byte_rle_literals(b), 300), b)


def test_nested_writer_reads_back_in_pyarrow():
    nd = writers.nested_data(3000, 63)
    tab = pq.read_table(io.BytesIO(writers.write_parquet_nested(nd, "snappy", rows_per_page=400)))
    want_l, want_s = [], []
    for i in range(3000):
        if not nd.list_valid[i]:
            want_l.append(None)
        else:
            a, b = nd.list_offsets[i], nd.list_offsets[i + 1]
            want_l.append([int(nd.elem_values[k]) if nd.elem_valid[k] else None
                           for k in range(a, b)])
        if not nd.struct_valid[i]:
            want_s.append(None)
        else:
            s = bytes(nd.b_chars[nd.b_offsets[i]:nd.b_offsets[i + 1]]).decode()
            want_s.append({"a": int(nd.a_values[i]) if nd.a_valid[i] else None,
                           "b": s if nd.b_valid[i] else None})
    assert tab.column("l").to_pylist() == want_l
    assert tab.column("s").to_pylist() == want_s
    assert 0.03 < 1 - nd.list_valid.mean() < 0.08 and 0.03 < 1 - nd.elem_valid.mean() < 0.08


@pytest.fixture(scope="module")
def lineitem_parquet(lineitem):
    """The harness's SNAPPY lineitem file and both packages' read of it,
    once a module: the reference's reader compiles anew for each page's
    shape, which is most of these checks' time."""
    data = writers.write_parquet(lineitem, "snappy", **SMALL)
    return data, jpr.read_table(data), ppr.read_table(data, device="cpu")


def test_harness_lineitem_file_matches_the_reference(lineitem_parquet):
    _, jt, pt = lineitem_parquet
    assert_same_tables(jt, pt)
    assert pt.num_rows == 4000 and pt.num_columns == 9


def test_footer_read_rows_slice_matches_the_reference(lineitem, lineitem_parquet):
    """The slice: every split's footer filter, read_table, convert_to_rows,
    through both packages; the row blob and offsets byte for byte."""
    data, jt, pt = lineitem_parquet
    step = len(data) // 3 + 1
    for off in range(0, len(data), step):
        sj, sp = jpf.StructElement(), ppf.StructElement()
        for c in lineitem:
            sj.add_child(c.name, jpf.ValueElement())
            sp.add_child(c.name, ppf.ValueElement())
        pf = ppf.read_and_filter(data, off, step, sp)
        assert pf.serialize_thrift_file() == jpf.read_and_filter(data, off, step, sj).serialize_thrift_file()
    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    assert len(jrows) == len(prows) == 1
    assert np.array_equal(np.asarray(jrows[0].offsets), prows[0].offsets.numpy())
    assert np.array_equal(np.asarray(jrows[0].child.data).view(np.uint8),
                          prows[0].child.data.numpy().view(np.uint8))


def test_orc_read_rows_slice_matches_the_reference(lineitem):
    data = writers.write_orc(lineitem, stripe_bytes=60_000, block=4096)
    jrows = jrc.convert_to_rows(jor.read_table(data))
    prows = prc.convert_to_rows(por.read_table(data, device="cpu"))
    assert np.array_equal(np.asarray(jrows[0].child.data).view(np.uint8),
                          prows[0].child.data.numpy().view(np.uint8))
