"""Port: ``chip_smoke.py``'s io checks pass on the CPU at a small size
(every file the io path writes read through the footer filter,
``read_table`` and ``convert_to_rows``; the flat reads, the rows, the
kernel calls and the nested read against their expectations) and catch
a wrong column. Exact throughout."""

import pytest
import torch

from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.io import parquet_reader as ppr

import chip_smoke
from test_torch_io_path import SMALL


@pytest.fixture
def small_chip_io(monkeypatch):
    monkeypatch.setattr(chip_smoke, "IO_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "IO_ROWS", 5000)
    monkeypatch.setattr(chip_smoke, "IO_NESTED_ROWS", 2000)
    monkeypatch.setattr(chip_smoke, "IO_SPLIT", 100_000)
    monkeypatch.setattr(chip_smoke, "IO_SIZES", dict(SMALL, stripe_bytes=60_000, block=8192,
                                                     rows_per_page=500))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return chip_smoke


def test_chip_smoke_io_checks_pass_on_the_cpu(small_chip_io):
    cs = small_chip_io
    cols, nd, files = cs._io_inputs(71)
    assert set(files) == {"lineitem.parquet.snappy", "lineitem.parquet.uncompressed",
                          "lineitem.orc.zlib", "nested.parquet.snappy"}
    names = [c.name for c in cols]
    for name, (buf, fmt, spans) in files.items():
        lineitem = name.startswith("lineitem")
        schema = cs._io_read_schema(name, cols)
        (footers, table, rows, fr, stage), seen = cs._io_capture(
            lambda: cs._io_path(buf, fmt, schema, lineitem))
        if fmt == "parquet":
            kept = cs._check_footers(footers, spans, len(cols[0]) if lineitem else 2000,
                                     len(cols) if lineitem else 2)
            assert sum(kept) >= 1
        if lineitem:
            expected = cs._io_expected(cols, fmt, pdt)
            cs._check_flat_read(table, expected, names)
            direct = cs._io_direct_rows(expected, names, "cpu")
            assert torch.equal(direct[0].child.data, rows[0].child.data)
            assert cs._check_io_calls(seen) == {k: 1 for k in cs.IO_KERNELS}
            got = cs._check_io_frames(table, fr)
            assert got["frame_bytes"] > got["frame_bytes_unchecked"] - 1
        else:
            cs._check_nested_read(table, nd)
        assert stage["read_ms"] > 0


def test_chip_smoke_io_checks_catch_a_wrong_column(small_chip_io):
    cs = small_chip_io
    cols, nd, files = cs._io_inputs(73)
    buf, fmt, _ = files["lineitem.parquet.snappy"]
    table = ppr.read_table(buf, device="cpu")
    expected = cs._io_expected(cols, fmt, pdt)
    expected[0] = (expected[0][0], expected[0][1].copy())
    expected[0][1][17] ^= 1
    with pytest.raises(AssertionError, match="l_quantity"):
        cs._check_flat_read(table, expected, [c.name for c in cols])
    nt = ppr.read_table(files["nested.parquet.snappy"][0], device="cpu")
    nd.elem_values[3] += 1
    with pytest.raises(AssertionError, match="nested l"):
        cs._check_nested_read(nt, nd)
