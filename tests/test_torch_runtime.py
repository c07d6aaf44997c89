"""Port: the native runtime's bindings (``spark_rapids_jni_tpu_torch/runtime.py``)
held against the JAX package's ``runtime``.

Where ``libsrjt.so`` exists, ``runtime.device_connect(device="cpu")``
drives the unmodified C ABI against the port's worker (through the
launcher the native client execs): the batched row encode, the decode,
``device_groupby_sum`` and both casts answer as the reference's runtime
does on the same inputs (its host engine, before the worker connects;
the sums within tests/test_pallas_kernels.py's bound), the worker's
STATS counts the requests, and the heartbeat answers. The host-only
bindings (codecs, the footer, host buffers, columnar handles) match the
reference's. Without the library every test here skips."""

import struct

import numpy as np
import pytest

import torch_serve_sides as S
from spark_rapids_jni_tpu import runtime as RR
from spark_rapids_jni_tpu.columnar import dtype as rdt
from spark_rapids_jni_tpu_torch import runtime as PR
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_jni_tpu_torch.interop import carry_table

if not (PR.native_available() and RR.native_available()):
    pytest.skip("native runtime not built", allow_module_level=True)

FIXED = ["INT32", "INT64", "FLOAT32", "INT8"]
STRS = ["12", " -7 ", "x", None, "99", "0042", "+5", "1.25"]


def _fixed(rng, n=64):
    return ([rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
             rng.integers(-(2**62), 2**62, n).astype(np.int64),
             rng.standard_normal(n).astype(np.float32),
             rng.integers(-128, 127, n).astype(np.int8)],
            [None, rng.integers(0, 2, n).astype(bool), None, None])


def _native_ops(rt, table, strings, keys, vals):
    """Run the native ops through ``rt``: the encode, the decode, both
    casts (non-ANSI and the ANSI error) and the group-by."""
    out = {}
    dtypes = [getattr(pdt if rt is PR else rdt, nm) for nm in FIXED]
    with rt.NativeTable.from_python(table) as nt:
        batches = rt.native_convert_to_rows_batched(nt)
        assert len(batches) == 1
        with batches[0] as rows:
            mod = pdt if rt is PR else rdt
            blob = rows.to_python(mod.DType(mod.TypeId.LIST), **_dev(rt))
            out["offsets"] = _host(blob.offsets).tobytes()
            out["blob"] = _host(blob.child.data).tobytes()
            with rt.native_convert_from_rows(rows, dtypes) as back:
                cols = [back.column(i) for i in range(back.num_columns)]
                decoded = [c.to_python(d, **_dev(rt)) for c, d in zip(cols, dtypes)]
                for c in cols:
                    c.close()
    out["decoded"] = [(_host(c.data).tobytes(), None if c.validity is None
                       else _host(c.validity).tobytes()) for c in decoded]
    with rt.NativeColumn.from_python(strings) as sc:
        i32 = (pdt if rt is PR else rdt).INT32
        with rt.native_cast_string_to_integer(sc, False, i32) as c:
            got = c.to_python(i32, **_dev(rt))
            out["cast_int"] = (_host(got.data).tobytes(), _host(got.validity).tobytes())
        try:
            rt.native_cast_string_to_integer(sc, True, i32)
        except rt.NativeCastError as e:
            out["cast_int_ansi"] = (e.row_with_error, e.string_with_error)
        dec = (pdt if rt is PR else rdt).decimal64(-3)  # precision 12 fits 64 bits
        with rt.native_cast_string_to_decimal(sc, False, 12, -3) as c:
            got = c.to_python(dec, **_dev(rt))
            out["cast_dec"] = (_host(got.data).tobytes(), _host(got.validity).tobytes())
    return out


def _dev(rt):
    return {"device": "cpu"} if rt is PR else {}


def _host(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(18)
    arrays, valids = _fixed(rng)
    from spark_rapids_jni_tpu.columnar import Column as RColumn, Table as RTable
    import jax.numpy as jnp

    rtab = RTable([RColumn(getattr(rdt, nm), data=jnp.asarray(a),
                           validity=None if v is None else jnp.asarray(v))
                   for nm, a, v in zip(FIXED, arrays, valids)])
    ptab = carry_table(arrays, [getattr(pdt, nm) for nm in FIXED], valids, device="cpu")
    strs = [STRS[i % len(STRS)] for i in range(64)]
    rstr = RColumn.from_pylist(strs, rdt.STRING)
    pstr = PColumn.from_pylist(strs, pdt.STRING, device="cpu")
    keys = rng.integers(-2, 512 + 2, 4096).astype(np.int64)
    vals = rng.standard_normal(4096).astype(np.float32)
    return rtab, ptab, rstr, pstr, keys, vals


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's answers, from its runtime before any worker
    connects (the native host engine) and its in-process group-by."""
    rtab, _, rstr, _, keys, vals = inputs
    assert RR.device_platform() == ""
    want = _native_ops(RR, rtab, rstr, keys, vals)
    payload = struct.pack("<IQ", 512, len(keys)) + keys.tobytes() + vals.tobytes()
    want["groupby"] = S.RS._dispatch(S.RS.OP_GROUPBY_SUM_F32, payload, "cpu")
    return want


@pytest.fixture(scope="module")
def connected(reference):
    backend = PR.device_connect(device="cpu", timeout_sec=120)
    yield backend
    PR.device_shutdown()


def test_device_connect_reaches_the_port_worker(connected):
    assert connected == "cpu" == PR.device_platform()
    assert PR.device_heartbeat()


@pytest.fixture
def worker_namespace():
    """The fold below writes the worker's counters into this process's
    registry as gauges; an in-process worker of an earlier file may have
    counted the same names there as counters."""
    S.scrub_worker_namespace(S.PORT)
    yield
    S.scrub_worker_namespace(S.PORT)


def test_native_ops_on_the_port_worker_match_the_reference(connected, inputs, reference,
                                                           worker_namespace):
    _, ptab, _, pstr, keys, vals = inputs
    # the handle registry is the process's: an earlier test in it may
    # have left handles live, so hold this test's own to none left over
    live = PR.live_columnar_handles()
    got = _native_ops(PR, ptab, pstr, keys, vals)
    for k, v in got.items():
        assert v == reference[k], k
    sums, counts = PR.device_groupby_sum(keys, vals, 512)
    S.assert_same_response("groupby", ("ok", sums.tobytes() + counts.tobytes()),
                           ("ok", reference["groupby"]))
    stats = PR.device_stats(fold=True)
    served = stats["worker"]["snapshot"]["counters"]
    for op in ("CONVERT_TO_ROWS", "CONVERT_FROM_ROWS", "CAST_TO_INTEGER", "CAST_TO_DECIMAL",
               "GROUPBY_SUM_F32"):
        assert served.get(f"sidecar.worker.requests.{op}", 0) >= 1, op
    assert stats["worker"]["backend"] == "cpu"
    assert PR.live_columnar_handles() == live


def test_host_bindings_match_the_reference():
    from torch_io_writers import snappy_literal

    data = bytes(range(200)) * 3
    comp = snappy_literal(data)
    assert PR.snappy_uncompress(comp) == RR.snappy_uncompress(comp) == data
    lz4 = bytes([0xA0]) + data[:10]  # one literal-only sequence
    assert PR.lz4_decompress_block(lz4, 10) == RR.lz4_decompress_block(lz4, 10) == data[:10]
    with pytest.raises(RuntimeError):
        PR.snappy_uncompress(b"\xff\xff\xff\xff\x0f garbage")
    for rt in (PR, RR):
        with rt.NativeHostBuffer(256) as b:
            b.write(b"srjt", 10)
            assert b.read(4, 10) == b"srjt" and b.address % 64 == 0
        assert rt.NativeHostBuffer.bytes_in_use() == 0
    assert PR.live_handles() == RR.live_handles()


def test_footer_matches_the_reference():
    from torch_io_writers import Col, write_parquet
    from spark_rapids_jni_tpu.io import parquet_footer as rpf
    from spark_rapids_jni_tpu_torch.io import parquet_footer as ppf

    rng = np.random.default_rng(5)
    buf = write_parquet([Col("a", "int32", rng.integers(0, 9, 500).astype(np.int32)),
                         Col("b", "double", rng.standard_normal(500).view(np.uint64))])
    seen = []
    for rt, pf in ((PR, ppf), (RR, rpf)):
        root = pf.StructElement()
        root.add_child("b", pf.ValueElement())
        with rt.NativeParquetFooter.read_and_filter(buf, 0, len(buf), root) as f:
            seen.append((f.get_num_rows(), f.get_num_columns(), f.serialize_thrift_file()))
    assert seen[0] == seen[1] and seen[0][:2] == (500, 1)


def test_columnar_handles_round_trip_like_the_reference(inputs):
    rtab, ptab, rstr, pstr, _, _ = inputs
    got, want = [], []
    for rt, tab, col, out in ((PR, ptab, pstr, got), (RR, rtab, rstr, want)):
        with rt.NativeTable.from_python(tab) as nt:
            out.append((nt.num_rows, nt.num_columns))
            with nt.column(1) as c:
                back = c.to_python(tab.columns[1].dtype, **_dev(rt))
                out.append((_host(back.data).tobytes(), _host(back.validity).tobytes()))
        with rt.NativeColumn.from_python(col) as c:
            back = c.to_python(col.dtype, **_dev(rt))
            out.append((_host(back.offsets).tobytes(), _host(back.chars).tobytes(),
                        _host(back.validity).tobytes()))
    assert got == want
