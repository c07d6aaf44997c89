"""The reduction of a profiler trace, on events made by hand: the
union of device activity, the device time under host ranges, idle gaps
named by the range the host was in, the hand-kernel launch count."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from portbench import trace


class Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _cpu(name, start, end, parent=None, device_us=0.0, user=True):
    return NS(name=name, device_type=DeviceType.CPU, is_user_annotation=user,
              time_range=Range(start, end), cpu_parent=parent, device_time_total=device_us)


def _dev(name, start, end):
    return NS(name=name, device_type=DeviceType.CUDA, is_user_annotation=False,
              time_range=Range(start, end))


def test_kernel_base_names():
    assert trace._base("(anonymous namespace)::expand_kernel(unsigned int const*, long)") \
        == "expand_kernel"
    assert trace._base("void (anonymous namespace)::groupby_outer_kernel<long>(long const*)") \
        == "groupby_outer_kernel"
    assert trace._base("void at::native::vectorized_elementwise_kernel<2, x>(int)") \
        == "vectorized_elementwise_kernel"


def test_reduce_with_host_ranges():
    stretch = _cpu(trace.STRETCH, 0, 1000)
    agg = _cpu("groupby_aggregate", 100, 600, stretch, device_us=300.0)
    inner = _cpu("groupby_aggregate", 200, 300, agg, device_us=50.0)
    host_work = _cpu("convert_to_rows", 650, 900, stretch)
    events = [stretch, agg, inner, host_work,
              _dev("expand_kernel(int)", 0, 100), _dev("void at::native::copy<1>(int)", 50, 400),
              _dev("other", 950, 1000), _dev("groupby_aggregate", 100, 600)]
    red = trace._reduce(events, {"expand_kernel"}, window_s=99.0)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx(450e-6)
    assert red["device_s"] == pytest.approx(500e-6)
    assert red["hand_launches"] == 1
    assert red["range_device_s"]["groupby_aggregate"] == pytest.approx(300e-6)
    gaps = dict(red["idle_gaps"])
    assert gaps["convert_to_rows"] == pytest.approx(550e-6)
    assert red["device_ops"][0] == ("copy<1>(int)", pytest.approx(350e-6))


def test_reduce_device_only():
    events = [_dev("a", 10, 20), _dev("b", 15, 40), _dev("c", 60, 70)]
    red = trace._reduce(events, set(), window_s=100e-6)
    assert red["window_s"] == 100e-6
    assert red["busy_s"] == pytest.approx(40e-6)
    assert "idle_gaps" not in red and "range_device_s" not in red
    assert trace._reduce([], set(), window_s=1.0) is None


def test_a_stretch_still_short_fails(monkeypatch):
    """A trace that keeps coming back short of hand-kernel launches is
    taken again, then fails the run rather than read low."""
    calls = {"counts": 0, "reduce": 0}

    def counts():
        calls["counts"] += 1
        return {"hopper_kernels.k": calls["counts"]}  # one launch a stretch

    def reduce(events, hand, window_s):
        calls["reduce"] += 1
        return {"hand_launches": 0, "window_s": window_s, "busy_s": 1e-6}

    monkeypatch.setattr(trace, "launch_counts", counts)
    monkeypatch.setattr(trace, "_reduce", reduce)
    with pytest.raises(RuntimeError, match="short of 1 hand-kernel"):
        trace.profile_stretch(lambda n: None, 2, {"k"}, lambda: None, host=True)
    assert calls["reduce"] == trace.RETAKES
