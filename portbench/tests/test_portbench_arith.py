"""The benchmark's arithmetic: percentiles, rates, rooflines,
intervals, the transcode's bytes and the sampling of items."""

import statistics

import pytest

from portbench import arith, harness
from portbench.datasets import jcudf_table
from portbench.reference import jcudf


@pytest.mark.parametrize("values", [[3.0], [5.0, 1.0], [float(i * i % 17) for i in range(1, 201)]])
def test_percentile_is_inclusive_interpolation(values):
    if len(values) > 1:
        qs = statistics.quantiles(values, n=100, method="inclusive")
        assert arith.percentile(values, 95) == pytest.approx(qs[94])
        assert arith.percentile(values, 50) == pytest.approx(statistics.median(values))
    assert arith.percentile(values, 100) == max(values)
    assert arith.percentile(values, 0) == min(values)


def test_percentile_needs_values():
    with pytest.raises(ValueError):
        arith.percentile([], 95)


def test_rate():
    assert arith.rate(4_194_304 * 200, 50.0) == pytest.approx(16_777_216.0)
    with pytest.raises(ValueError):
        arith.rate(1, 0)


def test_roofline_pct():
    assert arith.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert arith.peak_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert arith.peak_bytes_per_s("NVIDIA H200") == 4.8e12
    assert arith.peak_bytes_per_s("cpu") is None
    assert arith.roofline_pct(3.35e12, 2.0, "NVIDIA H100 80GB HBM3") == pytest.approx(50.0)
    assert arith.roofline_pct(1.0, 1.0, "cpu") is None


def test_merge_and_gaps():
    busy = arith.merge([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert busy == [(0, 3), (5, 8)]
    assert arith.gaps(busy, 0, 10) == [(3, 5), (8, 10)]
    assert arith.gaps(busy, -1, 6) == [(-1, 0), (3, 5)]
    assert arith.gaps([], 2, 4) == [(2, 4)]


def test_transcode_bytes_of_the_fixed212_batch(bench):
    cfg = harness.resolve(bench, "rowconv_fixed212.roundtrip")["cfg"]
    lay = jcudf.layout(jcudf_table.schema(cfg))
    n = cfg["rows"]
    got = jcudf.transcode_bytes(lay, n, 0)
    assert got == {"columns": 729 * n, "validity": 0, "rows": 784 * n, "offsets": 4 * (n + 2)}
    assert jcudf.transcode_bytes(lay, 16, 3)["validity"] == 6
    item = harness.load_module(harness.BENCH_DIR / "items" / "rowconv.py")
    st = {"data": {"layout": lay, "rows": n}}
    assert item.info(st)["transcode_bytes"] == sum(got.values())


def test_idle_share_against_the_window_latency():
    reader = harness.load_module(harness.BENCH_DIR / "layer_metrics" / "device.idle_pct.py")
    rec = {"device": {"busy_s": 0.9, "items": 10, "window_s": 2.0}, "latency_s": 0.1}
    assert reader.read(rec) == pytest.approx(10.0)
    assert reader.read(dict(rec, device=dict(rec["device"], items=0))) is None


def test_sampling_is_drawn_from_the_seed():
    picks = [i for i in range(3200) if harness.sampled(12345, i, 32)]
    assert picks == [i for i in range(3200) if harness.sampled(12345, i, 32)]
    assert 60 <= len(picks) <= 140
    assert picks != [i for i in range(3200) if harness.sampled(54321, i, 32)]
    assert all(harness.sampled(2**63 - 1, i, 1) for i in range(10))
