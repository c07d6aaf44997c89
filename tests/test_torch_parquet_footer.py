"""Port: the thrift compact codec (``io/thrift_compact``) and the parquet
footer service (``io/parquet_footer``: ``read_and_filter``, the pruner,
the row-group split by midpoint, ``serialize_thrift_file``) against the
JAX package: the cases of ``tests/test_parquet_footer.py`` through both
packages, the serialized footers byte for byte equal."""

import io
import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.io import parquet_footer as jpf
from spark_rapids_jni_tpu.io import thrift_compact as jtc

from spark_rapids_jni_tpu_torch.io import parquet_footer as ppf
from spark_rapids_jni_tpu_torch.io import thrift_compact as ptc

import torch_io_writers as writers


def make_parquet(table: pa.Table, row_group_size=None) -> bytes:
    buf = io.BytesIO()
    pq.write_table(table, buf, row_group_size=row_group_size, compression="snappy")
    return buf.getvalue()


def footer_bytes(file_bytes: bytes) -> bytes:
    (flen,) = struct.unpack("<I", file_bytes[-8:-4])
    return file_bytes[-8 - flen : -8]


FLAT = pa.table({
    "a": pa.array(range(100), pa.int32()),
    "b": pa.array([f"s{i}" for i in range(100)]),
    "c": pa.array([i * 0.5 for i in range(100)]),
})
STRUCT3 = pa.table({
    "s": pa.array([{"x": i, "y": f"v{i}", "z": i * 1.0} for i in range(10)],
                  pa.struct([("x", pa.int64()), ("y", pa.string()), ("z", pa.float64())])),
    "plain": pa.array(range(10), pa.int64()),
})
STRUCT2 = pa.table({
    "s": pa.array([{"x": i, "y": i * 2} for i in range(5)],
                  pa.struct([("x", pa.int64()), ("y", pa.int64())])),
    "a": pa.array(range(5), pa.int32()),
})
LISTT = pa.table({"l": pa.array([[1, 2], [3], []], pa.list_(pa.int32())),
                  "o": pa.array([1, 2, 3], pa.int32())})
MAPT = pa.table({"m": pa.array([{"k1": 1}, {"k2": 2}, {}], pa.map_(pa.string(), pa.int32())),
                 "o": pa.array([1, 2, 3], pa.int32())})
_INNER = pa.struct([("a", pa.int32()), ("b", pa.string())])
DEEP = pa.table({"outer": pa.array([{"items": [{"a": 1, "b": "x"}]}] * 3,
                                   pa.struct([("items", pa.list_(_INNER))]))})


def _schema(m, kind):
    """The read schema of a case, built from module ``m``'s elements."""
    S, V, L, M = m.StructElement, m.ValueElement, m.ListElement, m.MapElement
    return {
        "a_c": lambda: S().add_child("a", V()).add_child("c", V()),
        "A": lambda: S().add_child("A", V()),
        "a": lambda: S().add_child("a", V()),
        "a_zz": lambda: S().add_child("a", V()).add_child("zz", V()),
        "s_x": lambda: S().add_child("s", S().add_child("x", V())),
        "s_nope": lambda: S().add_child("s", S().add_child("nope", V())),
        "l": lambda: S().add_child("l", L(V())),
        "m": lambda: S().add_child("m", M(V(), V())),
        "deep": lambda: S().add_child("outer", S().add_child("items", L(S().add_child("b", V())))),
    }[kind]()


# (table, row_group_size, schema, offset, length as a fraction of the file or
# an absolute int, ignore_case)
CASES = {
    "flat_two_columns": (FLAT, 30, "a_c", 0, 1.0, False),
    "case_no_folding": (FLAT, 30, "A", 0, 1.0, False),
    "case_folding": (FLAT, 30, "a", 0, 1.0, True),
    "case_folding_upper": (FLAT, 30, "A", 0, 1.0, True),
    "missing_column": (FLAT, 30, "a_zz", 0, 1.0, False),
    "split_zero_length": (FLAT, 30, "a", 0, 0, False),
    "split_negative_length": (FLAT, 30, "a", 0, -1, False),
    "split_first_half": (FLAT, 30, "a", 0, 0.5, False),
    "split_second_half": (FLAT, 30, "a", 0.5, 0.5, False),
    "split_middle": (FLAT, 30, "a", 0.25, 0.25, False),
    "struct_pruning": (STRUCT3, None, "s_x", 0, 1.0, False),
    "struct_to_zero_children": (STRUCT2, None, "s_nope", 0, 1.0, False),
    "list_pruning": (LISTT, None, "l", 0, 1.0, False),
    "map_pruning": (MAPT, None, "m", 0, 1.0, False),
    "struct_of_list_of_struct": (DEEP, None, "deep", 0, 1.0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_and_filter_matches_the_reference(case):
    table, rgs, kind, off, length, fold = CASES[case]
    data = make_parquet(table, row_group_size=rgs)
    n = len(data)
    off = int(off * n) if isinstance(off, float) else off
    length = int(length * n) if isinstance(length, float) else length
    jf = jpf.read_and_filter(data, off, length, _schema(jpf, kind), ignore_case=fold)
    pf = ppf.read_and_filter(data, off, length, _schema(ppf, kind), ignore_case=fold)
    assert pf.get_num_rows() == jf.get_num_rows()
    assert pf.get_num_columns() == jf.get_num_columns()
    got = pf.serialize_thrift_file()
    assert got == jf.serialize_thrift_file()
    # a data-less parquet file an independent reader accepts: its row
    # groups are the ones kept
    md = pq.read_metadata(io.BytesIO(got))
    assert sum(md.row_group(i).num_rows for i in range(md.num_row_groups)) == pf.get_num_rows()


@pytest.mark.parametrize("table", ["FLAT", "STRUCT3", "MAPT", "DEEP"])
def test_thrift_round_trip_matches_the_reference(table):
    raw = footer_bytes(make_parquet(globals()[table], row_group_size=30))
    p, j = ptc.write_struct(ptc.read_struct(raw)), jtc.write_struct(jtc.read_struct(raw))
    assert p == j
    assert ptc.write_struct(ptc.read_struct(p)) == p


def _every_wire_type(m):
    inner = m.ThriftStruct({1: (m.CT_I32, -5), 2: (m.CT_BINARY, b"x")})
    return m.ThriftStruct({
        1: (m.CT_TRUE, True), 2: (m.CT_FALSE, False), 3: (m.CT_BYTE, -7), 4: (m.CT_I16, 300),
        5: (m.CT_I32, -(2**31)), 6: (m.CT_I64, 2**62 + 3), 7: (m.CT_DOUBLE, -2.5),
        8: (m.CT_BINARY, b"\x00\xffbytes"),
        9: (m.CT_LIST, m.ThriftList(m.CT_I64, list(range(20)))),
        10: (m.CT_SET, m.ThriftList(m.CT_BINARY, [b"a", b"b"], is_set=True)),
        11: (m.CT_MAP, m.ThriftMap(m.CT_I32, m.CT_STRUCT, [(1, inner), (2, inner)])),
        12: (m.CT_STRUCT, inner),
        13: (m.CT_LIST, m.ThriftList(m.CT_TRUE, [True, False, True])),
        40: (m.CT_I32, 7),  # a field-id jump past 15: the long header form
    })


def test_thrift_writes_every_wire_type_like_the_reference():
    p, j = ptc.write_struct(_every_wire_type(ptc)), jtc.write_struct(_every_wire_type(jtc))
    assert p == j
    back = ptc.read_struct(p)
    assert ptc.write_struct(back) == p
    assert back.get(6) == 2**62 + 3 and back.get(13).values == [True, False, True]


@pytest.mark.parametrize("cut", [1, 5, 17])
def test_truncated_thrift_raises_like_the_reference(cut):
    raw = jtc.write_struct(_every_wire_type(jtc))[:cut]
    with pytest.raises(ValueError, match="thrift"):
        ptc.read_struct(raw)
    with pytest.raises(ValueError, match="thrift"):
        jtc.read_struct(raw)


@pytest.mark.parametrize("split", [0, 1, 2, 3])
def test_splits_of_a_harness_file_keep_the_midpoint_groups(split):
    """The harness writer's lineitem file, cut into four splits: each keeps
    the row groups whose midpoint it holds, as the reference does."""
    cols = writers.lineitem_columns(4000, 31)
    spans = []
    data = writers.write_parquet(cols, "snappy", row_group_bytes=60_000, page_bytes=8_000,
                                 spans=spans)
    step = -(-len(data) // 4)
    off = split * step
    sj = jpf.StructElement()
    sp = ppf.StructElement()
    for c in cols:
        sj.add_child(c.name, jpf.ValueElement())
        sp.add_child(c.name, ppf.ValueElement())
    jf = jpf.read_and_filter(data, off, step, sj)
    pf = ppf.read_and_filter(data, off, step, sp)
    want = [r for start, size, r in spans if off <= start + size // 2 < off + step]
    assert pf.get_num_rows() == jf.get_num_rows() == sum(want)
    assert pf.serialize_thrift_file() == jf.serialize_thrift_file()
    assert len(spans) > 4
