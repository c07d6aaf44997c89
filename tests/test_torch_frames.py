"""Port: the CRC contract (``utils/integrity``) and the columnar frames
(``columnar/frames``) against the JAX package. Exact: checksums, the
gate's state, and frames byte for byte the reference's for the same
table with checks on and off; each package decodes the other's frames to
the same bits; a corrupted frame raises DataCorruption in both."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar import frames as jfr
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.utils import errors as jerr
from spark_rapids_jni_tpu.utils import integrity as jint

from spark_rapids_jni_tpu_torch.columnar import Table, dtype as pdt
from spark_rapids_jni_tpu_torch.columnar import frames as pfr
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.utils import errors as perr
from spark_rapids_jni_tpu_torch.utils import integrity as pint

from torch_io_parity import assert_same_tables

PAYLOADS = [b"", b"a", b"spark-rapids-jni-tpu" * 7, bytes(range(256)) * 5]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_checksum_matches_the_reference(i):
    data = PAYLOADS[i]
    assert pint.checksum(data) == jint.checksum(data)
    assert pint.checksum(data, 12345) == jint.checksum(data, 12345)
    half = len(data) // 2
    assert pint.checksum(data[half:], pint.checksum(data[:half])) == pint.checksum(data)
    c = pint.checksum(data)
    assert pint.pack_crc(c) == jint.pack_crc(c)
    assert pint.unpack_crc(b"xx" + pint.pack_crc(c), 2) == jint.unpack_crc(b"xx" + jint.pack_crc(c), 2)


def test_checksum_name_matches_the_reference():
    assert pint.checksum_name() == jint.checksum_name()
    assert pint.CRC_LEN == jint.CRC_LEN == 4


def test_verify_raises_data_corruption_like_the_reference():
    data = b"payload bytes"
    good = pint.checksum(data)
    with pint.enabled(), jint.enabled():
        pint.verify(data, good, "x")
        jint.verify(data, good, "x")
        with pytest.raises(perr.DataCorruption) as pe:
            pint.verify(data, good ^ 1, "unit.where")
        with pytest.raises(jerr.DataCorruption) as je:
            jint.verify(data, good ^ 1, "unit.where")
        assert str(pe.value) == str(je.value)
    assert issubclass(perr.DataCorruption, perr.RetryableError)
    assert issubclass(perr.RetryableError, perr.DeviceError)
    assert issubclass(perr.DeviceError, RuntimeError)


def test_integrity_gate_follows_the_reference():
    assert pint.is_enabled()  # on by default, as the reference's knob defaults
    with pint.disabled():
        assert not pint.is_enabled()
        pint.verify(b"abc", 0, "x")  # a no-op while off
        with pint.enabled():
            assert pint.is_enabled()
        assert not pint.is_enabled()
    assert pint.is_enabled()
    pint.disable()
    try:
        assert not pint.is_enabled()
    finally:
        pint.enable()
    assert pint.is_enabled()


def test_integrity_adds_no_environment_knob():
    import inspect

    assert "os.environ" not in inspect.getsource(pint) and "getenv" not in inspect.getsource(pint)
    assert "SRJT_" not in inspect.getsource(pint)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

FLAT = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "FLOAT32",
        "FLOAT64", "BOOL8", "TIMESTAMP_DAYS", "TIMESTAMP_MICROSECONDS", "DECIMAL32",
        "DECIMAL64", "DECIMAL128", "STRING"]


def _dt(mod, name):
    scale = {"DECIMAL32": -2, "DECIMAL64": -4, "DECIMAL128": -6}.get(name)
    return mod.DType(mod.TypeId[name], scale) if scale is not None else getattr(mod, name)


def _tables(rng, n, names=FLAT, nulls_every=2):
    """(JAX Table, port Table) of the same seeded storage arrays."""
    jcols, arrays, dtypes, valids = [], [], [], []
    for i, nm in enumerate(names):
        jd, pd = _dt(jdt, nm), _dt(pdt, nm)
        v = rng.integers(0, 2, n).astype(bool) if i % nulls_every == 0 else None
        jv = None if v is None else jnp.asarray(v)
        if nm == "STRING":
            lens = rng.integers(0, 9, n).astype(np.int32)
            offs = np.zeros(n + 1, np.int32)
            np.cumsum(lens, out=offs[1:])
            chars = rng.integers(0, 256, int(offs[-1])).astype(np.uint8)
            jcols.append(JColumn.strings_from_parts(offs, chars, validity=jv))
            arrays.append((offs, chars))
        else:
            shape = (n, 4) if nm == "DECIMAL128" else (n,)
            width = 4 if nm == "DECIMAL128" else np.dtype(jd.np_dtype).itemsize
            raw = rng.integers(0, 256, int(np.prod(shape)) * width, dtype=np.uint8)
            a = raw.view(jd.np_dtype).reshape(shape)
            if nm == "BOOL8":
                a = (a & 1).astype(np.uint8)
            jcols.append(JColumn(jd, data=jnp.asarray(a), validity=jv))
            arrays.append(a)
        dtypes.append(pd)
        valids.append(v)
    return JTable(jcols), carry_table(arrays, dtypes, valids, device="cpu")


@pytest.mark.parametrize("checked", [True, False])
@pytest.mark.parametrize("n", [0, 1, 53])
def test_frames_are_the_reference_bytes_and_cross_decode(checked, n):
    jt, pt = _tables(np.random.default_rng(100 + n), n)
    gate = (pint.enabled, jint.enabled) if checked else (pint.disabled, jint.disabled)
    with gate[0](), gate[1]():
        pb, jb = pfr.encode_table(pt), jfr.encode_table(jt)
        assert pb == jb
        assert pfr.is_frame(pb) and pfr.is_checked(pb) == jfr.is_checked(jb) == checked
        assert_same_tables(jt, pfr.decode_table(jb, device="cpu"))
        assert_same_tables(jfr.decode_table(pb), pt)


@pytest.mark.parametrize("checked", [True, False])
def test_frames_of_row_batches_are_the_reference_bytes(checked):
    """LIST<INT8> JCUDF row batches cross as their byte child."""
    jt, pt = _tables(np.random.default_rng(5), 40, names=["INT32", "STRING", "FLOAT64"])
    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    jrt, prt = JTable(jrows), Table(prows)
    gate = (pint.enabled, jint.enabled) if checked else (pint.disabled, jint.disabled)
    with gate[0](), gate[1]():
        pb, jb = pfr.encode_table(prt), jfr.encode_table(jrt)
        assert pb == jb
        assert_same_tables(jfr.decode_table(pb), pfr.decode_table(jb, device="cpu"))


def test_struct_columns_do_not_cross_like_the_reference():
    from spark_rapids_jni_tpu_torch.columnar import Column

    kid = Column.from_numpy(np.arange(3, dtype=np.int32), device="cpu")
    pt = Table([Column.struct_from_parts([kid], ["a"])])
    jt = JTable([JColumn.struct_from_parts([JColumn.from_numpy(np.arange(3, dtype=np.int32))],
                                           ["a"])])
    with pytest.raises(ValueError, match="STRUCT"):
        pfr.encode_table(pt)
    with pytest.raises(ValueError, match="STRUCT"):
        jfr.encode_table(jt)


def _flip(buf: bytes, at: int) -> bytes:
    bad = bytearray(buf)
    bad[at] ^= 0x40
    return bytes(bad)


@pytest.mark.parametrize("where", ["payload", "header"])
def test_a_corrupted_frame_raises_data_corruption(where):
    jt, pt = _tables(np.random.default_rng(9), 30)
    with pint.enabled(), jint.enabled():
        buf = pfr.encode_table(pt)
        at = len(buf) - 3 if where == "payload" else 40
        bad = _flip(buf, at)
        with pytest.raises(perr.DataCorruption, match="CRC mismatch"):
            pfr.decode_table(bad, device="cpu")
        with pytest.raises(jerr.DataCorruption, match="CRC mismatch"):
            jfr.decode_table(bad)


def test_a_truncated_frame_raises_data_corruption():
    _, pt = _tables(np.random.default_rng(10), 30)
    buf = pfr.encode_table(pt)
    with pytest.raises(perr.DataCorruption):
        pfr.decode_parts(buf[:-5])
    with pytest.raises(jerr.DataCorruption):
        jfr.decode_parts(buf[:-5])


def test_unchecked_frames_verify_nothing_like_the_reference():
    jt, pt = _tables(np.random.default_rng(11), 30, names=["INT64"], nulls_every=5)
    with pint.disabled(), jint.disabled():
        buf = pfr.encode_table(pt)
    bad = _flip(buf, len(buf) - 1)
    with pint.enabled(), jint.enabled():
        got_p = pfr.decode_table(bad, device="cpu")
        got_j = jfr.decode_table(bad)
    assert_same_tables(got_j, got_p)
    assert not torch.equal(got_p.columns[0].validity, pt.columns[0].validity)  # the flipped byte


def test_bad_magic_is_not_a_frame():
    assert not pfr.is_frame(b"NOTAFRAME...") and not pfr.is_checked(b"xx")
    with pytest.raises(ValueError, match="bad magic"):
        pfr.decode_parts(b"NOTAFRAME" + bytes(40))


@pytest.mark.parametrize("checked", [True, False])
def test_leaves_match_the_reference(checked):
    rng = np.random.default_rng(12)
    leaves = [rng.standard_normal((3, 4)), np.arange(7, dtype=np.int16), np.zeros(0, np.uint8),
              rng.integers(0, 2, 5).astype(bool)]
    gate = (pint.enabled, jint.enabled) if checked else (pint.disabled, jint.disabled)
    with gate[0](), gate[1]():
        pb, jb = pfr.encode_leaves(leaves), jfr.encode_leaves(leaves)
        assert pb == jb
        for got in (pfr.decode_leaves(jb), jfr.decode_leaves(pb)):
            assert all(a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
                       for a, b in zip(got, leaves))


def test_decode_table_builds_on_the_device_asked_for():
    _, pt = _tables(np.random.default_rng(13), 8, names=["INT32", "STRING"])
    got = pfr.decode_table(pfr.encode_table(pt), device="cpu")
    assert all(c.device.type == "cpu" for c in got.columns)
