"""Port: the ORC reader (``io/orc_reader.read_table``) against the JAX
package's on pyarrow.orc-written files: every codec, the integer RLE
encodings (short repeat, direct, delta, patched base), int64 extremes,
direct and dictionary strings, stripes, dates, timestamps, decimals,
unions, nested lists, structs and maps, column selection, and the
harness writer's ZLIB file. Exact: both readers' Tables column by
column (``torch_io_parity``)."""

import datetime
import decimal
import io

import numpy as np
import pyarrow as pa
import pytest

orc = pytest.importorskip("pyarrow.orc")

import spark_rapids_jni_tpu  # noqa: F401,E402
from spark_rapids_jni_tpu.io import orc_reader as jor  # noqa: E402

from spark_rapids_jni_tpu_torch.io import codecs  # noqa: E402
from spark_rapids_jni_tpu_torch.io import orc_reader as por  # noqa: E402

import torch_io_writers as writers  # noqa: E402
from torch_io_parity import assert_same_tables  # noqa: E402


def write(table, **kw):
    buf = io.BytesIO()
    orc.write_table(table, buf, **kw)
    return buf.getvalue()


def both(data, columns=None):
    jt = jor.read_table(data, columns=columns)
    pt = por.read_table(data, columns=columns, device="cpu")
    assert_same_tables(jt, pt)
    return jt, pt


BASIC = pa.table({
    "i32": pa.array([1, -2, 3, None, 5], pa.int32()),
    "i64": pa.array([2**40, None, -7, 0, 9], pa.int64()),
    "i8": pa.array([1, None, -8, 127, -128], pa.int8()),
    "i16": pa.array([300, None, -8, 32767, -32768], pa.int16()),
    "f32": pa.array([1.5, 2.5, None, -0.25, 0.0], pa.float32()),
    "f64": pa.array([1e300, None, -2.25, 0.5, 3.125], pa.float64()),
    "s": pa.array(["hello", "", None, "spark", "tpu"], pa.string()),
    "b": pa.array([True, False, None, True, False], pa.bool_()),
})


@pytest.mark.parametrize("codec", ["uncompressed", "zlib", "snappy", "zstd", "lz4"])
def test_codecs_match_the_reference(codec):
    _, pt = both(write(BASIC, compression=codec))
    assert pt.column("s").to_pylist() == BASIC.column("s").to_pylist()


def test_snappy_chunks_decode_through_the_native_codec():
    before = codecs.CALLS["snappy"]
    both(write(BASIC, compression="snappy"))
    assert codecs.CALLS["snappy"] > before


def test_integer_run_encodings_match_the_reference(rng):
    n = 20000
    t = pa.table({
        "mono": pa.array(np.arange(n, dtype=np.int64) * 3 + 7),
        "rep": pa.array(np.repeat(rng.integers(-50, 50, 200), 100).astype(np.int32)),
        "rand": pa.array(rng.integers(-(2**40), 2**40, n).astype(np.int64)),
        "skew": pa.array(np.where(rng.integers(0, 100, n) == 0, rng.integers(0, 2**50, n),
                                  rng.integers(0, 100, n)).astype(np.int64)),
    })
    both(write(t))


def test_int64_extremes_match_the_reference():
    ext = [-(2**63), 2**63 - 1, 2**62 + 7, -(2**62 + 7), -1, 0, 1, None]
    both(write(pa.table({"v": pa.array(ext, pa.int64())})))
    both(write(pa.table({"minrun": pa.array([-(2**63)] * 64, pa.int64()),
                         "maxrun": pa.array([2**63 - 1] * 64, pa.int64())})))


def test_direct_and_dictionary_strings_match_the_reference(rng):
    n = 5000
    t = pa.table({
        "dict": pa.array([f"cat_{int(x)}" for x in rng.integers(0, 20, n)]),
        "direct": pa.array([f"row_{i}_{int(rng.integers(0, 1 << 30))}" for i in range(n)]),
    })
    both(write(t))


def test_stripes_match_the_reference(rng):
    n = 60000
    t = pa.table({"x": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
                  "y": pa.array([f"k{int(v) % 37}" for v in rng.integers(0, 1000, n)])})
    both(write(t, stripe_size=64 * 1024))


def test_dates_timestamps_and_decimals_match_the_reference():
    d = datetime.date
    ts = datetime.datetime
    dec = decimal.Decimal
    t = pa.table({
        "d": pa.array([d(1970, 1, 1), d(2024, 2, 29), None, d(1969, 12, 31)]),
        "ts": pa.array([ts(2020, 6, 1, 12, 34, 56, 789012), ts(2014, 12, 31, 23, 59, 59, 500000),
                        None, ts(1960, 2, 29, 1, 2, 3)], pa.timestamp("ns")),
        "small": pa.array([dec("1.23"), dec("-45.60"), None, dec("99999.99")],
                          pa.decimal128(7, 2)),
        "big": pa.array([dec("12345678901234567890123456.789"), dec("-0.999"), None, dec("1e20")],
                        pa.decimal128(38, 3)),
    })
    both(write(t))


def test_column_selection_matches_the_reference():
    _, pt = both(write(BASIC), columns=["s", "i32"])
    assert pt.names == ["i32", "s"]


def test_all_nulls_and_empty_match_the_reference():
    both(write(pa.table({"n": pa.array([None, None, None], pa.int32())})))
    both(write(pa.table({"a": pa.array([], pa.int64())})))


def test_bad_input_raises():
    with pytest.raises(por.OrcReadError, match="not an ORC file"):
        por.read_table(b"PAR1", device="cpu")
    with pytest.raises(por.OrcReadError, match="not in schema"):
        por.read_table(write(BASIC), columns=["nope"], device="cpu")


def test_union_as_tagged_struct_matches_the_reference():
    arr = pa.UnionArray.from_dense(pa.array([0, 1, 0, 1, 0], pa.int8()),
                                   pa.array([0, 0, 1, 1, 2], pa.int32()),
                                   [pa.array([7, 9, -3], pa.int64()),
                                    pa.array(["x", "yy"], pa.string())])
    _, pt = both(write(pa.table({"u": arr})))
    assert [v["tag"] for v in pt.columns[0].to_pylist()] == [0, 1, 0, 1, 0]


NESTED = {
    "list_of_ints": pa.table({"a": pa.array([[1, 2, 3], [], None, [4], [5, None, 7]],
                                            pa.list_(pa.int64()))}),
    "struct_flat": pa.table({"s": pa.array(
        [{"x": 1, "y": "a"}, {"x": None, "y": "b"}, None, {"x": 4, "y": None}],
        pa.struct([("x", pa.int32()), ("y", pa.string())]))}),
    "list_of_structs": pa.table({"ls": pa.array(
        [[{"k": 1, "v": 1.5}, {"k": 2, "v": None}], None, [], [{"k": None, "v": -2.25}]],
        pa.list_(pa.struct([("k", pa.int64()), ("v", pa.float64())])))}),
    "struct_of_list": pa.table({"sl": pa.array(
        [{"tags": ["a", "bb"], "n": 1}, {"tags": None, "n": 2}, {"tags": [], "n": None}, None],
        pa.struct([("tags", pa.list_(pa.string())), ("n", pa.int32())]))}),
    "list_of_list": pa.table({"ll": pa.array([[[1], [2, 3]], [], None, [None, [4, 5]]],
                                             pa.list_(pa.list_(pa.int32())))}),
    "map": pa.table({"m": pa.array([[("a", 1), ("b", 2)], [], None, [("z", None)]],
                                   pa.map_(pa.string(), pa.int64()))}),
}


@pytest.mark.parametrize("case", sorted(NESTED))
def test_nested_columns_match_the_reference(case):
    both(write(NESTED[case]))


@pytest.mark.parametrize("codec", ["zlib", "snappy", "zstd"])
def test_nested_compressed_matches_the_reference(codec):
    data = [[{"s": "x" * (i % 7), "i": i}] * (i % 3) for i in range(200)]
    t = pa.table({"c": pa.array(data, pa.list_(pa.struct([("s", pa.string()),
                                                          ("i", pa.int64())])))})
    both(write(t, compression=codec))


def test_nested_multi_stripe_matches_the_reference(rng):
    n = 5000
    data = [None if rng.random() < 0.1 else [int(v) for v in rng.integers(0, 100, rng.integers(0, 5))]
            for _ in range(n)]
    t = pa.table({"a": pa.array(data, pa.list_(pa.int64())),
                  "b": pa.array(np.arange(n, dtype=np.int64))})
    both(write(t, stripe_size=16 * 1024))


def test_harness_orc_file_matches_the_reference():
    cols = writers.lineitem_columns(4000, 47)
    data = writers.write_orc(cols, stripe_bytes=60_000, block=4096)
    _, pt = both(data)
    assert pt.num_rows == 4000
    assert pt.column("l_returnflag").dtype.id.name == "INT8"
    assert pt.column("l_shipdate").dtype.id.name == "INT32"
