"""Port: ``op_boundary`` (``spark_rapids_jni_tpu_torch/utils/dispatch.py``)
held against the JAX package's: every ported public op crosses a boundary
of the reference's name, a table of exception texts classifies the same
way, nested boundaries make one retry loop and one deadline scope, and
the disarmed boundary reads no clock and calls no torch."""

import importlib
import time

import pytest
import torch

from spark_rapids_jni_tpu.utils import deadline as rd
from spark_rapids_jni_tpu.utils import dispatch as rdisp
from spark_rapids_jni_tpu.utils import errors as rerr
from spark_rapids_jni_tpu.utils import faultinj as rf
from spark_rapids_jni_tpu.utils import metrics as rmet
from spark_rapids_jni_tpu.utils import retry as rr
from spark_rapids_jni_tpu_torch.utils import deadline as pd
from spark_rapids_jni_tpu_torch.utils import dispatch as pdisp
from spark_rapids_jni_tpu_torch.utils import errors as perr
from spark_rapids_jni_tpu_torch.utils import faultinj as pf
from spark_rapids_jni_tpu_torch.utils import metrics as pmet
from spark_rapids_jni_tpu_torch.utils import retry as pr

PORT = dict(disp=pdisp, err=perr, fi=pf, met=pmet, retry=pr, dl=pd)
REF = dict(disp=rdisp, err=rerr, fi=rf, met=rmet, retry=rr, dl=rd)


@pytest.fixture(autouse=True)
def _clean():
    for p in (PORT, REF):
        p["met"].reset()
        p["retry"].reset_stats()
    yield
    for p in (PORT, REF):
        p["fi"].disable()
        p["retry"].disable()
        p["met"].disable()
        p["met"].reset()
        p["retry"].reset_stats()


# (module, attribute, the reference's boundary name): the 45 public ops
OPS = [
    ("ops.row_conversion", "convert_to_rows", "convert_to_rows"),
    ("ops.row_conversion", "convert_from_rows", "convert_from_rows"),
    ("ops.row_conversion", "convert_from_rows_grouped", "convert_from_rows_grouped"),
    ("ops.row_conversion", "convert_to_rows_fixed_width_optimized",
     "convert_to_rows_fixed_width_optimized"),
    ("ops.row_conversion", "convert_from_rows_fixed_width_optimized",
     "convert_from_rows_fixed_width_optimized"),
    ("ops.decimal_utils", "multiply128", "multiply128"),
    ("ops.decimal_utils", "divide128", "divide128"),
    ("ops.sort", "sort_by_key", "sort_by_key"),
    ("ops.window", "window_aggregate", "window_aggregate"),
    ("ops.cast_string", "string_to_integer", "string_to_integer"),
    ("ops.cast_string", "string_to_decimal", "string_to_decimal"),
] + [("ops.strings", f, f"strings.{f}") for f in
     ("length", "upper", "lower", "substring", "concat", "concat_ws", "contains",
      "startswith", "endswith", "strip", "instr")] + [
    ("ops.zorder", "interleave_bits", "interleave_bits"),
    ("ops.aggregate", "groupby_aggregate", "groupby_aggregate"),
] + [("ops.regex", f, f"strings.{f}") for f in
     ("contains_re", "matches_re", "extract_re", "split_re", "replace_re")] + [
    ("ops.join", f, f) for f in
    ("inner_join", "left_join", "full_join", "left_semi_join", "left_anti_join")] + [
    ("parallel.join_distributed", "distributed_inner_join", "distributed_inner_join"),
    ("parallel.shuffle", "hash_partition", "hash_partition"),
    ("parallel.shuffle", "all_to_all_exchange", "all_to_all_exchange"),
    ("parallel.shuffle", "exchange_by_key", "exchange_by_key"),
    ("parallel.sort_distributed", "distributed_sort", "distributed_sort"),
    ("parallel.table_ops", "exchange_table", "exchange_table"),
    ("parallel.table_ops", "distributed_groupby_table", "distributed_groupby_table"),
    ("parallel.table_ops", "distributed_join_table", "distributed_join_table"),
    ("io.parquet_reader", "read_table", "read_table"),
    ("io.orc_reader", "read_table", "orc_read_table"),
    ("pipeline", "compiled_pipeline", "compiled_pipeline"),
]


def _op(pkg: str, mod: str, attr: str):
    m = importlib.import_module(f"{pkg}.{mod}")
    if attr == "compiled_pipeline":
        plan = m.PlanSpec(aggregates=(m.Agg("x", "sum"),))
        return m.compile_plan(plan)
    return getattr(m, attr)


def test_the_port_wraps_45_ops():
    assert len(OPS) == 45 and len({o[2] for o in OPS}) == 45


@pytest.mark.parametrize("mod,attr,name", OPS, ids=[o[2] for o in OPS])
def test_op_crosses_the_references_boundary(mod, attr, name):
    # a fatal rule on the boundary's name fires before the body runs, so
    # the error names the boundary each package's op crosses
    names = []
    for pkg, p in (("spark_rapids_jni_tpu_torch", PORT), ("spark_rapids_jni_tpu", REF)):
        fn = _op(pkg, mod, attr)
        p["fi"].configure({"faults": {name: {"type": "fatal"}}})
        with pytest.raises(p["err"].FatalDeviceError) as ei:
            fn(None, deadline_s=5.0, memory_bytes=1)
        names.append(str(ei.value))
    assert names[0] == names[1] == f"injected fatal fault in {name}"


_TEXTS = [
    "CUDA launch of probe_paged failed: cudaError 9",
    "RESOURCE_EXHAUSTED: while allocating",
    "UNAVAILABLE: socket",
    "DEADLINE_EXCEEDED: collective",
    "the device is DEAD",
    "DEADLINE_EXCEEDED but the DEAD device",
    "device is in an invalid state",
    "Connection reset by peer",
    "CRC mismatch in frame",
    "Overloaded: queue full",
    "client has been shut down",
    "something unknown",
]


def _boundary_outcome(p, exc):
    @p["disp"].op_boundary("t.classify")
    def body():
        raise exc
    try:
        body()
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return type(e).__name__, str(e), e.__cause__ is exc
    return None


@pytest.mark.parametrize("text", _TEXTS)
def test_classification_table_matches(text):
    a = _boundary_outcome(PORT, RuntimeError(text))
    b = _boundary_outcome(REF, RuntimeError(text))
    assert a == b
    assert a[1] == text  # the text comes through intact


def test_card_oom_text_classifies_as_resource_exhausted():
    # the card's allocator OOM is the counterpart of XLA's RESOURCE_EXHAUSTED:
    # the port classifies it as the reference classifies that marker
    a = _boundary_outcome(PORT, RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    b = _boundary_outcome(REF, RuntimeError("RESOURCE_EXHAUSTED: Tried to allocate 2.00 GiB"))
    assert a[0] == b[0] == "RetryableError"


@pytest.mark.parametrize("exc", [ValueError("v"), TypeError("t"), KeyError("k"),
                                 IndexError("i")])
def test_host_errors_pass_through(exc):
    assert _boundary_outcome(PORT, exc) == _boundary_outcome(REF, exc) == (
        type(exc).__name__, str(exc), False)


def test_own_api_errors_pass_through():
    from spark_rapids_jni_tpu_torch.ops.cast_string import CastError

    out = _boundary_outcome(PORT, CastError(3, "bad row"))
    assert out[0] == "CastError" and out[2] is False


def test_refused_launch_is_fatal_and_attempted_once():
    calls = []

    @pdisp.op_boundary("t.launch")
    def body():
        calls.append(1)
        raise RuntimeError("CUDA launch of expand_u32_planes failed: cudaError 9")
    with pr.enabled(max_attempts=4, base_delay_ms=0):
        with pytest.raises(perr.FatalDeviceError,
                           match="CUDA launch of expand_u32_planes failed: cudaError 9"):
            body()
    assert calls == [1] and pr.stats()["fatal"] == 1 and pr.stats()["retries"] == 0


def test_card_oom_is_retryable_and_retried():
    calls = []

    @pdisp.op_boundary("t.oom")
    def body():
        calls.append(1)
        if len(calls) < 3:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")
        return "ok"
    with pytest.raises(perr.RetryableError, match="CUDA out of memory"):
        body()
    with pr.enabled(max_attempts=4, base_delay_ms=0):
        assert body() == "ok"
    assert len(calls) == 3 and pr.stats()["retries"] == 1


def _nested_retry(p):
    calls = {"outer": 0, "inner": 0}

    @p["disp"].op_boundary("t.inner")
    def inner():
        calls["inner"] += 1
        raise p["err"].RetryableError("transient")

    @p["disp"].op_boundary("t.outer")
    def outer():
        calls["outer"] += 1
        return inner()
    with p["retry"].enabled(max_attempts=3, base_delay_ms=0, seed=1):
        with p["met"].enabled():
            with pytest.raises(p["err"].RetryableError):
                outer()
    # Zero entries dropped: metrics.reset() keeps names other tests registered.
    snap = {k: v for k, v in p["met"].counters_snapshot().items()
            if k.startswith(("op.t.", "retry.")) and v}
    return calls, p["retry"].stats(), snap


def test_nested_boundaries_make_one_retry_loop():
    a, b = _nested_retry(PORT), _nested_retry(REF)
    assert a == b
    assert a[0] == {"outer": 3, "inner": 3}  # 3 attempts, not 3 ** 2


def _nested_deadline(p):
    seen = []

    @p["disp"].op_boundary("t.in")
    def inner():
        seen.append(p["dl"].current().budget_s)
        return p["dl"].current()

    @p["disp"].op_boundary("t.out")
    def outer():
        d = p["dl"].current()
        seen.append(d.budget_s)
        return d is inner(deadline_s=100.0) or inner() is d
    assert outer(deadline_s=30.0)
    assert p["dl"].current() is None
    return seen[0], seen[1] <= 30.0


def test_deadline_keyword_is_honoured():
    assert _nested_deadline(PORT) == _nested_deadline(REF) == (30.0, True)


def test_hang_under_deadline_keyword():
    pf.configure({"faults": {"t.hang": {"type": "hang", "delayMs": 5000}}})

    @pdisp.op_boundary("t.hang")
    def body():
        return 1
    t0 = time.perf_counter()
    with pytest.raises(perr.DeadlineExceeded, match="hang fault in t.hang"):
        body(deadline_s=0.1)
    assert time.perf_counter() - t0 < 0.6


def test_memory_bytes_is_popped():
    @pdisp.op_boundary("t.kw")
    def body(**kw):
        return kw
    assert body(a=1, memory_bytes=123, deadline_s=9.0) == {"a": 1}


def test_disarmed_boundary_reads_no_clock_and_calls_no_torch(monkeypatch):
    class NoClock:
        def perf_counter(self):
            raise AssertionError("clock read while disarmed")

    def boom(*a, **k):
        raise AssertionError("torch call while disarmed")
    monkeypatch.setattr(pdisp, "time", NoClock())
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "is_initialized", boom)

    @pdisp.op_boundary("t.quiet")
    def body(x):
        return x + 1
    assert not (pmet.is_enabled() or pr.is_enabled())
    assert body(1) == 2


def test_armed_boundary_records_calls():
    @pdisp.op_boundary("t.rec")
    def body(x):
        return x
    with pmet.enabled():
        for i in range(5):
            body(i)
    snap = pmet.snapshot()
    assert snap["counters"]["op.t.rec.calls"] == 5
    assert snap["histograms"]["op.t.rec.wall_us"]["count"] == 5


def test_tier_names_map_the_references():
    assert pdisp.TIER_NAMES == {"pallas": "cuda", "xla": "torch", "degrade": "degrade"}
    before = pmet.registry().value("dispatch.tier.cuda")
    pdisp.note_tier("cuda", "t.op")
    pdisp.note_tier("torch", "t.op")
    assert pmet.registry().value("dispatch.tier.cuda") == before + 1
    assert pmet.registry().value("dispatch.tier.torch") >= 1
