"""Port: the native codecs of the readers (``io/codecs``), built from the
repo's own C++ under ``native/src`` at first use. Exact bytes: snappy,
LZ4 block and zstd on pyarrow's streams, LZO1X on hand-assembled streams
(the JAX package's ``tests/test_lzo.py`` cases), the harness writer's
literal-only snappy, and the PLAIN BYTE_ARRAY length walk. These build
and run here (a host C++ compiler and libzstd are present): they do not
skip."""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_jni_tpu_torch import _build
from spark_rapids_jni_tpu_torch.io import codecs

import torch_io_writers as writers

PAYLOADS = {
    "empty": b"",
    "short": b"hello",
    "text": b"spark-rapids-jni-tpu columnar payload " * 300,
    "random": np.random.default_rng(3).integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    "runs": bytes(200_000) + b"\x01" * 5000,
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_snappy_decodes_pyarrow_streams(name):
    data = PAYLOADS[name]
    comp = pa.Codec("snappy").compress(data).to_pybytes()
    before = codecs.CALLS["snappy"]
    assert bytes(codecs.snappy_uncompress(comp, len(data))) == data
    assert bytes(codecs.snappy_uncompress(comp)) == data
    assert codecs.CALLS["snappy"] == before + 2


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_literal_only_snappy_of_the_writers_is_valid_snappy(name):
    data = PAYLOADS[name]
    lit = writers.snappy_literal(data)
    assert bytes(codecs.snappy_uncompress(lit, len(data))) == data
    assert pa.Codec("snappy").decompress(lit, decompressed_size=len(data)).to_pybytes() == data


def test_snappy_rejects_garbage_and_a_wrong_size():
    with pytest.raises(RuntimeError, match="snappy"):
        codecs.snappy_uncompress(b"\xff\xff\xff\xff\xff\x00garbage")
    comp = pa.Codec("snappy").compress(b"abcdef").to_pybytes()
    with pytest.raises(RuntimeError, match="page header says 7"):
        codecs.snappy_uncompress(comp, 7)


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_lz4_block_decodes_pyarrow_streams(name):
    data = PAYLOADS[name]
    comp = pa.Codec("lz4_raw").compress(data).to_pybytes()
    assert bytes(codecs.lz4_decompress_block(comp, len(data))) == data
    # a larger bound is fine: the block's own length is returned
    assert bytes(codecs.lz4_decompress_block(comp, len(data) + 100)) == data


def test_lz4_block_refuses_an_overflowing_output():
    data = PAYLOADS["text"]
    comp = pa.Codec("lz4_raw").compress(data).to_pybytes()
    with pytest.raises(RuntimeError, match="lz4"):
        codecs.lz4_decompress_block(comp, len(data) - 1)


def test_zstd_is_built_here():
    ok, log = _build.zstd_probe()
    assert ok, log
    assert codecs.has_zstd()


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_zstd_decodes_pyarrow_streams(name):
    data = PAYLOADS[name]
    comp = pa.Codec("zstd").compress(data).to_pybytes()
    assert codecs.zstd_frame_content_size(comp) in (len(data), -1)
    assert bytes(codecs.zstd_decompress(comp, len(data))) == data


def test_zstd_rejects_garbage():
    with pytest.raises(RuntimeError, match="zstd"):
        codecs.zstd_decompress(b"not a zstd frame at all", 100)


# -- LZO1X: the hand assembler of tests/test_lzo.py ---------------------------

EOF_MARKER = bytes([0x11, 0x00, 0x00])


def first_literals(payload: bytes) -> bytes:
    return bytes([len(payload) + 17]) + payload


def m2(dist: int, length: int, trail: bytes = b"") -> bytes:
    d = dist - 1
    return bytes([((length - 1) << 5) | ((d & 7) << 2) | len(trail), d >> 3]) + trail


def m3(dist: int, length: int, trail: bytes = b"") -> bytes:
    d = dist - 1
    return bytes([0x20 | (length - 2), ((d & 0x3F) << 2) | len(trail), d >> 6]) + trail


_P100 = bytes(np.random.default_rng(7).integers(0, 256, 100, dtype=np.uint8))
LZO = {
    "literals": (first_literals(b"hello lzo world!") + EOF_MARKER, b"hello lzo world!"),
    "empty": (EOF_MARKER, b""),
    "m2_overlap": (first_literals(b"abcd") + m2(4, 8) + EOF_MARKER, b"abcd" * 3),
    "m2_trailing": (first_literals(b"wxyz") + m2(4, 4, b"!?") + EOF_MARKER,
                    b"wxyz" * 2 + b"!?"),
    "m3_far": (first_literals(_P100) + m3(100, 10) + EOF_MARKER, _P100 + _P100[:10]),
}


@pytest.mark.parametrize("name", sorted(LZO))
def test_lzo1x_decodes_hand_assembled_streams(name):
    stream, want = LZO[name]
    assert bytes(codecs.lzo1x_decompress(stream, 1 << 20)) == want


def test_lzo1x_rejects_a_truncated_stream():
    with pytest.raises(RuntimeError, match="lzo"):
        codecs.lzo1x_decompress(first_literals(b"hello lzo world!")[:-3], 1 << 20)


# -- the PLAIN BYTE_ARRAY walk ------------------------------------------------


def _page(values):
    return b"".join(len(v).to_bytes(4, "little") + v for v in values)


@pytest.mark.parametrize("values", [[], [b""], [b"a", b"", b"spark" * 20], [b"x"] * 1000])
def test_byte_array_lens_walks_plain_pages(values):
    got = codecs.byte_array_lens(_page(values))
    assert got.dtype == np.int32 and got.tolist() == [len(v) for v in values]


@pytest.mark.parametrize("page", [b"\x05\x00\x00\x00abc", _page([b"ab"]) + b"\x01\x00"])
def test_byte_array_lens_refuses_malformed_pages(page):
    with pytest.raises(RuntimeError, match="malformed"):
        codecs.byte_array_lens(page)


# -- the build ------------------------------------------------------------------


def test_codec_library_builds_from_native_sources():
    srcs, flags = _build._host_inputs("codecs")
    names = [p.name for p in srcs]
    assert names[0] == "codecs.cc" and {"snappy.cc", "lz4.cc", "lzo.cc"} <= set(names)
    assert all(p.exists() for p in srcs)
    assert any(p.parent == _build.NATIVE_SRC for p in srcs)
    assert "zstd_codec.cc" in names and "-DCODECS_HAVE_ZSTD" in flags
    path = _build.lib_path("codecs")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libcodecs-")
    codecs.has_zstd()  # loads (and builds if needed)
    assert path.exists()


def test_no_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    _build.zstd_probe.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            codecs.snappy_uncompress(pa.Codec("snappy").compress(b"abc").to_pybytes())
    finally:
        _build.zstd_probe.cache_clear()


def test_missing_zstd_names_the_header(monkeypatch):
    monkeypatch.setattr(codecs, "has_zstd", lambda: False)
    monkeypatch.setattr(_build, "zstd_probe",
                        lambda: (False, "<stdin>:1:10: fatal error: zstd.h: No such file"))
    with pytest.raises(RuntimeError, match="zstd.h"):
        codecs.zstd_decompress(b"\x28\xb5\x2f\xfd", 10)
    with pytest.raises(RuntimeError, match="zstd.h"):
        codecs.zstd_frame_content_size(b"\x28\xb5\x2f\xfd")
