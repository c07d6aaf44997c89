"""Port: the parquet reader (``io/parquet_reader.read_table``) against the
JAX package's on pyarrow-written files: flat types, nulls, dictionary and
PLAIN, v1 and v2 pages, every codec the reference reads, nested lists,
structs and maps, column selection, and the harness writers' files
(nested lists, structs and maps, and the harness's nested file, are in
``test_torch_parquet_reader_nested.py``, which reads through ``both``
here; the harness's lineitem file in ``test_torch_io_path.py``, which
reads it once for all its checks).
Exact: both readers' Tables column by column, every array's dtype, shape
and bytes (``torch_io_parity``), except where the reference is at fault
(an all-null or empty fixed-width chunk, an empty STRING chunk), which
the tests below pin."""

import io
import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.io import parquet_reader as jpr

from spark_rapids_jni_tpu_torch.io import codecs
from spark_rapids_jni_tpu_torch.io import parquet_reader as ppr

import torch_io_writers as writers
from torch_io_parity import assert_same_tables


def write(table, **kw):
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


def both(data, columns=None):
    jt = jpr.read_table(data, columns=columns)
    pt = ppr.read_table(data, columns=columns, device="cpu")
    assert_same_tables(jt, pt)
    return jt, pt


BASIC = pa.table({
    "i32": pa.array([1, -2, 3, None, 5], pa.int32()),
    "i64": pa.array([2**40, None, -7, 0, 9], pa.int64()),
    "f32": pa.array([1.5, 2.5, None, -0.25, 0.0], pa.float32()),
    "f64": pa.array([1e300, None, -2.25, 0.5, 3.125], pa.float64()),
    "s": pa.array(["hello", "", None, "spark", "tpu"], pa.string()),
    "b": pa.array([True, False, None, True, False], pa.bool_()),
})


@pytest.mark.parametrize("codec", ["NONE", "snappy", "zstd", "gzip", "lz4", "brotli"])
def test_codecs_match_the_reference(codec):
    _, pt = both(write(BASIC, compression=codec))
    assert pt.to_pydict() == BASIC.to_pydict()


@pytest.mark.parametrize("kw", [
    dict(use_dictionary=False, compression="NONE"),
    dict(use_dictionary=True),
    dict(data_page_version="2.0"),
    dict(data_page_version="2.0", use_dictionary=False),
    dict(data_page_version="2.0", compression="snappy"),
], ids=["plain", "dictionary", "v2", "v2_plain", "v2_snappy"])
def test_encodings_and_page_versions_match_the_reference(kw):
    both(write(BASIC, **kw))


def test_snappy_pages_decode_through_the_native_codec():
    before = codecs.CALLS["snappy"]
    both(write(BASIC, compression="snappy"))
    assert codecs.CALLS["snappy"] > before


def test_multiple_row_groups_and_wide_dictionaries(rng):
    n = 5000
    t = pa.table({
        "x": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "y": pa.array([f"k{int(v) % 50}" for v in rng.integers(0, 1000, n)]),
        "z": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.standard_normal(n))),
        "w": pa.array(rng.integers(-(2**31), 2**31, n).astype(np.int32)),
    })
    both(write(t, row_group_size=750))
    both(write(t, row_group_size=750, data_page_size=1024))  # many pages a chunk


def test_column_selection_matches_the_reference():
    jt, pt = both(write(BASIC), columns=["s", "i32"])
    assert pt.names == ["i32", "s"]


def test_missing_columns_raise_like_the_reference():
    data = write(BASIC)
    with pytest.raises(ppr.ParquetReadError, match="not in schema"):
        ppr.read_table(data, columns=["nope"], device="cpu")
    with pytest.raises(Exception, match="not in schema"):
        jpr.read_table(data, columns=["nope"])


def test_not_a_parquet_file_raises():
    with pytest.raises(ppr.ParquetReadError, match="not a parquet file"):
        ppr.read_table(b"PAR1 but not really", device="cpu")


def test_all_null_int32_column_matches_the_reference():
    _, pt = both(write(pa.table({"n": pa.array([None, None, None], pa.int32())})))
    assert pt.columns[0].to_pylist() == [None] * 3


@pytest.mark.parametrize("typ", ["int64", "float64"])
def test_all_null_wide_chunk_keeps_its_storage_unlike_the_reference(typ):
    """Reference fault: an all-null chunk of a 64-bit type comes back with
    int32 zeros as its data (``parquet_reader.py:831``); the port keeps
    the type's storage. Validity and values agree."""
    data = write(pa.table({"n": pa.array([None] * 4, getattr(pa, typ)())}))
    jc = jpr.read_table(data).columns[0]
    pc = ppr.read_table(data, device="cpu").columns[0]
    assert np.asarray(jc.data).dtype == np.int32
    assert pc.data.dtype == torch.int64 and pc.data.shape == (4,)
    assert not pc.data.any() and not np.asarray(jc.data).any()
    assert np.array_equal(pc.validity.numpy(), np.asarray(jc.validity))
    assert pc.to_pylist() == jc.to_pylist() == [None] * 4


def test_empty_table_keeps_its_storage_unlike_the_reference():
    data = write(pa.table({"a": pa.array([], pa.int64())}))
    jc = jpr.read_table(data).columns[0]
    pc = ppr.read_table(data, device="cpu").columns[0]
    assert len(pc) == len(jc) == 0
    assert pc.data.dtype == torch.int64 and np.asarray(jc.data).dtype == np.int32


def test_empty_string_chunk_reads_where_the_reference_raises():
    """Reference fault: a STRING chunk with no values raises AttributeError
    in the reference (its empty value list is fixed-width); the port gives
    an empty STRING column."""
    data = write(pa.table({"s": pa.array([], pa.string())}))
    with pytest.raises(Exception, match="shape"):
        jpr.read_table(data)
    pc = ppr.read_table(data, device="cpu").columns[0]
    assert len(pc) == 0 and pc.chars.numel() == 0 and pc.offsets.tolist() == [0]


def test_lz4_hadoop_framing_matches_the_reference():
    plain = b"spark-rapids-jni-tpu hadoop lz4 framing " * 40
    half = len(plain) // 2
    framed = b"".join(
        struct.pack(">II", len(part), len(comp)) + comp
        for part in (plain[:half], plain[half:])
        for comp in [pa.Codec("lz4_raw").compress(part).to_pybytes()])
    assert ppr._lz4_hadoop(framed, len(plain)) == jpr._lz4_hadoop(framed, len(plain)) == plain
    frame = pa.Codec("lz4").compress(plain).to_pybytes()  # the LZ4 frame format
    assert ppr._lz4_hadoop(frame, len(plain)) is None


def test_lzo_hadoop_framing():
    payload = b"hello lzo world!"
    block = bytes([len(payload) + 17]) + payload + bytes([0x11, 0, 0])
    framed = struct.pack(">II", len(payload), len(block)) + block
    assert ppr._lzo_hadoop(framed, len(payload)) == payload
    assert ppr._decompress(framed, "lzo", len(payload)) == payload
    with pytest.raises(ppr.ParquetReadError, match="LZO"):
        ppr._decompress(framed[:-2], "lzo", len(payload))


def test_zstd_without_the_native_codec_falls_back_to_pyarrow(monkeypatch):
    monkeypatch.setattr(codecs, "has_zstd", lambda: False)
    comp = pa.Codec("zstd").compress(b"abc" * 100).to_pybytes()
    assert ppr._decompress(comp, "zstd", 300) == b"abc" * 100


def test_zstd_without_native_codec_or_pyarrow_names_the_header(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *a, **k):
        if name == "pyarrow":
            raise ImportError("no pyarrow")
        return real(name, *a, **k)

    monkeypatch.setattr(codecs, "has_zstd", lambda: False)
    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ppr.ParquetReadError, match="zstd.h"):
        ppr._decompress(b"\x28\xb5\x2f\xfd", "zstd", 10)


# -- the device helpers: JAX clamps out-of-range gathers, the port clamps ----


def test_rle_expansion_matches_the_host_decoder(rng):
    vals = rng.integers(0, 50, 3000).astype(np.uint32)
    vals[100:700] = 7  # a long run: the writer packs it, a literal stays literal
    for width in (6, 7, 12):
        data = writers.rle_hybrid(vals, width)
        got = ppr._rle_expand_device(data, width, vals.size, torch.device("cpu"))
        assert np.array_equal(got.numpy(), vals.astype(np.int32))
        assert np.array_equal(got.numpy(), ppr._read_rle_bitpacked(data, width, vals.size))
    # an RLE run whose literal is far past the stream: its window index is
    # clamped (JAX clamps the reference's gather), the value is the literal
    run = writers._varint(200 << 1) + (4000).to_bytes(2, "little")
    got = ppr._rle_expand_device(run, 12, 200, torch.device("cpu"))
    assert got.tolist() == [4000] * 200


def test_dictionary_take_clamps_out_of_range_indices_like_jax():
    page = b"".join(len(v).to_bytes(4, "little") + v for v in (b"a", b"bb", b"ccc"))
    d = ppr._Dictionary(page, ppr._T_BYTE_ARRAY, 3, torch.device("cpu"))
    got = d.take(torch.tensor([0, 2, 9, -1], dtype=torch.int32))
    assert got.lens.tolist() == [1, 3, 3, 1]
    assert bytes(got.chars.numpy()) == b"acccccca"
