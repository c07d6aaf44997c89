"""Port: tracing and the flight recorder
(``spark_rapids_jni_tpu_torch/utils/tracing.py``, ``trace_sink.py``) held
against the JAX package's: wire blobs are byte-identical, ``render_trace``
text matches, nested boundaries give span trees of the same shape, and
the profiler ranges are the card's (``record_function``; NVTX only once
CUDA is initialised)."""

import json

import pytest
import torch

from spark_rapids_jni_tpu.utils import dispatch as rdisp
from spark_rapids_jni_tpu.utils import metrics as rmet
from spark_rapids_jni_tpu.utils import trace_sink as rsink
from spark_rapids_jni_tpu.utils import tracing as rtr
from spark_rapids_jni_tpu_torch.utils import dispatch as pdisp
from spark_rapids_jni_tpu_torch.utils import metrics as pmet
from spark_rapids_jni_tpu_torch.utils import trace_sink as psink
from spark_rapids_jni_tpu_torch.utils import tracing as ptr

PORT = dict(tr=ptr, sink=psink, disp=pdisp, met=pmet)
REF = dict(tr=rtr, sink=rsink, disp=rdisp, met=rmet)


@pytest.fixture(autouse=True)
def _fresh():
    for p in (PORT, REF):
        p["sink"].reset_for_tests()
        p["met"].reset()
    yield
    for p in (PORT, REF):
        p["tr"].set_enabled(False)
        p["sink"].reset_for_tests()
        p["sink"].set_log_path(None)
        p["met"].reset()


@pytest.mark.parametrize("tid,parent,sampled", [(1, 2, True), ((1 << 64) - 1, 7, False),
                                                (0xDEADBEEF, 1 << 63, True)])
def test_wire_blobs_are_byte_identical(tid, parent, sampled):
    a = ptr._TRACE_BLOB.pack(tid, parent, int(sampled))
    b = rtr._TRACE_BLOB.pack(tid, parent, int(sampled))
    assert a == b and len(a) == ptr.TRACE_CTX_LEN == rtr.TRACE_CTX_LEN == 17
    assert ptr.decode_wire_context(a) == rtr.decode_wire_context(b) == (tid, parent, sampled)


def test_wire_context_of_an_active_span():
    assert ptr.wire_context() is None  # disarmed
    with ptr.enabled():
        qt = ptr.start_trace("q")
        with qt.activate():
            with ptr.span("child") as sp:
                blob = ptr.wire_context()
        qt.finish()
    tid, parent, sampled = ptr.decode_wire_context(blob)
    assert (tid, parent, sampled) == (qt.ctx.trace_id, sp.span_id, True)


def _record():
    spans = [
        {"span": "a", "parent": None, "name": "op.outer", "ts": 1.0, "dur_us": 2500.0,
         "pid": 11, "status": "ok", "annotations": {"tier": "cuda", "retry_attempts": 2}},
        {"span": "b", "parent": "a", "name": "op.inner", "ts": 1.1, "dur_us": 900.0,
         "pid": 11, "status": "error", "annotations": {"error": "RetryableError"}},
        {"span": "c", "parent": "a", "name": "op.inner", "ts": 1.05, "dur_us": 2.0e6, "pid": 11},
        {"span": "d", "parent": "zz", "name": "orphan", "ts": 0.5, "dur_us": 1.0, "pid": 12},
    ]
    return {"trace": "00ff", "name": "op.outer", "status": "failed", "duration_s": 2.5,
            "flushed": True, "spans": spans, "dropped_spans": 3,
            "metrics_delta": {"op.outer.calls": 1, "retry.retries": 2, "x": -4}}


def test_render_trace_text_matches():
    rec = _record()
    assert psink.render_trace(rec) == rsink.render_trace(rec)
    assert psink.render_trace({"spans": []}) == rsink.render_trace({"spans": []})


def _shape(rec):
    """A trace's span tree by names, parents resolved, children sorted."""
    by_id = {s["span"]: s for s in rec["spans"]}

    def path(s):
        out = [s["name"]]
        while s.get("parent") in by_id:
            s = by_id[s["parent"]]
            out.append(s["name"])
        return tuple(reversed(out))
    return sorted((path(s), s["status"]) for s in rec["spans"])


def _nested(p):
    disp = p["disp"]

    @disp.op_boundary("t.leaf")
    def leaf(x):
        if x < 0:
            raise ValueError("negative")
        return x

    @disp.op_boundary("t.mid")
    def mid(x):
        return leaf(x) + leaf(x + 1)

    @disp.op_boundary("t.top")
    def top(x):
        try:
            mid(-5)
        except ValueError:
            pass
        return mid(x)
    with p["tr"].enabled():
        with p["met"].enabled():
            assert top(3) == 7
    rec = p["sink"].recorder().last(1)[0]
    return _shape(rec), rec["status"], rec["name"], sorted(rec["metrics_delta"].items())


def test_nested_boundaries_give_the_same_span_tree():
    a, b = _nested(PORT), _nested(REF)
    assert a == b
    shape = a[0]
    assert (("op.t.top",), "ok") in shape
    assert sum(1 for path, _ in shape if path[-1] == "op.t.leaf") == 3
    assert (("op.t.top", "op.t.mid", "op.t.leaf"), "error") in shape


def test_flight_recorder_flushes_failures_to_the_span_log(tmp_path):
    base = tmp_path / "spans.jsonl"
    psink.set_log_path(str(base))

    @pdisp.op_boundary("t.fail")
    def fail():
        raise ValueError("no")
    with ptr.enabled():
        with pytest.raises(ValueError):
            fail()
    psink.close_log()
    lines = [json.loads(x) for x in open(psink.resolved_log_path())]
    kinds = [r["kind"] for r in lines]
    assert kinds == ["span", "trace"] and lines[1]["status"] == "failed"
    assert "op.t.fail" in psink.explain_last()
    st = psink.stats_section()
    assert st["flushed"] == 1 and st["recorder"]["recorded"] == 1


def test_sampling_zero_declines_roots(monkeypatch):
    monkeypatch.setenv("SRJTORCH_TRACE_SAMPLE", "0")
    with ptr.enabled():
        qt = ptr.start_trace("q")
        assert qt is not None and not qt.ctx.sampled
        with qt.activate():
            with ptr.op_span("inner") as sp:
                assert sp is ptr._NULL_SPAN
        qt.finish()
    assert pmet.registry().value("trace.unsampled") == 1
    assert psink.recorder().last(1) == []


def test_func_range_opens_record_function_and_no_nvtx_on_cpu(monkeypatch):
    pushes = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: pushes.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: pushes.append("pop"))
    assert not torch.cuda.is_initialized()
    with ptr.func_range("t.off"):  # disarmed: nothing at all
        pass
    with ptr.enabled():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with ptr.func_range("t.range"):
                torch.ones(4).sum()
    assert pushes == []
    assert "t.range" in {e.key for e in prof.key_averages()}


def test_func_range_pushes_nvtx_once_cuda_is_initialised(monkeypatch):
    pushes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: pushes.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: pushes.append("pop"))
    with ptr.enabled():
        with pytest.raises(KeyError):
            with ptr.func_range("t.nvtx"):
                raise KeyError("x")
    assert pushes == ["t.nvtx", "pop"]  # popped in a finally


def test_profile_to_writes_a_chrome_trace(tmp_path):
    with ptr.profile_to(str(tmp_path / "off")):  # disarmed: unprofiled
        pass
    assert not (tmp_path / "off").exists()
    with ptr.enabled():
        with ptr.profile_to(str(tmp_path / "on")):
            with ptr.func_range("t.profiled"):
                torch.arange(8).sum()
    files = list((tmp_path / "on").glob("trace.*.json"))
    assert len(files) == 1 and "t.profiled" in files[0].read_text()
