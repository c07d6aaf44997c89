"""Port: the fault injector (``spark_rapids_jni_tpu_torch/utils/faultinj.py``)
held against the JAX package's: for every rule form the fire sequence
over 200 dispatches of 5 op names is identical, each kind raises the
counterpart class, and the producer-side hooks corrupt and tear the same
bytes."""

import json
import time

import pytest

from spark_rapids_jni_tpu.utils import deadline as rd
from spark_rapids_jni_tpu.utils import errors as rerr
from spark_rapids_jni_tpu.utils import faultinj as rf
from spark_rapids_jni_tpu_torch.utils import deadline as pd
from spark_rapids_jni_tpu_torch.utils import errors as perr
from spark_rapids_jni_tpu_torch.utils import faultinj as pf

OPS = ["convert_to_rows", "convert_from_rows", "exchange.serve", "exchange.frame",
       "inner_join"]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    pf.disable()
    rf.disable()


def _fires(mod, cfg, calls=200):
    mod.configure(cfg)
    seq = []
    for i in range(calls):
        op = OPS[i % len(OPS)]
        try:
            mod.maybe_inject(op)
            seq.append(0)
        except Exception as e:  # noqa: BLE001 - the class is the observation
            seq.append(type(e).__name__)
    mod.disable()
    return seq


RULES = {
    "exact": {"seed": 7, "faults": {"convert_to_rows": {"type": "retryable", "percent": 50}}},
    "prefix": {"seed": 8, "faults": {"exchange.*": {"type": "fatal", "percent": 30},
                                     "exchange.se.*": {"type": "retryable", "percent": 90}}},
    "wildcard": {"seed": 9, "faults": {"*": {"type": "exception", "percent": 20},
                                       "inner_join": {"type": "retryable", "percent": 60}}},
    "tag": {"seed": 10, "faults": {"convert_from_rows@w1": {"type": "fatal", "percent": 40},
                                   "convert_from_rows": {"type": "retryable", "percent": 40},
                                   "exchange.*@r2": {"type": "retryable", "percent": 70},
                                   "*@w9": {"type": "fatal", "percent": 100}}},
    "after": {"seed": 11, "faults": {"*": {"type": "retryable", "percent": 80, "after": 17}}},
    "ramp": {"seed": 12, "faults": {"inner_join": {"type": "retryable", "percent": 100,
                                                   "ramp": 20, "after": 3}}},
    "budget": {"seed": 13, "faults": {"*": {"type": "retryable", "percent": 50,
                                            "interceptionCount": 9}}},
    "unseeded_exact": {"faults": {"convert_to_rows": {"type": "retryable", "percent": 100}}},
}


@pytest.mark.parametrize("form", sorted(RULES))
def test_fire_sequence_matches(form, monkeypatch):
    monkeypatch.setenv("SRJTORCH_FAULTINJ_WORKER", "w1")
    monkeypatch.setenv("SRJTORCH_FAULTINJ_RANK", "r2")
    monkeypatch.setenv("SRJT_FAULTINJ_WORKER", "w1")
    monkeypatch.setenv("SRJT_FAULTINJ_RANK", "r2")
    a, b = _fires(pf, RULES[form]), _fires(rf, RULES[form])
    assert a == b
    assert any(a), form  # every form fires at least once


def test_tags_resolve_by_specificity(monkeypatch):
    monkeypatch.setenv("SRJTORCH_FAULTINJ_WORKER", "w1")
    seq = _fires(pf, RULES["tag"], calls=5)
    # op@tag beats op (fatal, not retryable); a foreign @w9 never matches
    assert seq[1] in (0, "FatalDeviceError") and "RetryableError" not in seq[:2]
    monkeypatch.setenv("SRJTORCH_FAULTINJ_WORKER", "w2")
    pf.configure({"seed": 1, "faults": {"x@w1": {"type": "fatal"}, "x": {"type": "retryable"}}})
    with pytest.raises(perr.RetryableError):
        pf.maybe_inject("x")


_KINDS = {
    "fatal": "FatalDeviceError",
    "retryable": "RetryableError",
    "exception": "RuntimeError",
    "spill_fail": "RetryableError",
    "reject": "Overloaded",
    "netsplit": "ConnectionRefusedError",
    "cache_evict": "CacheEvictInjected",
}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_each_kind_raises_the_counterpart_class(kind):
    cfg = {"seed": 1, "faults": {"op": {"type": kind, "delayMs": 250}}}
    errs = []
    for mod in (pf, rf):
        mod.configure(cfg)
        with pytest.raises(Exception) as ei:
            mod.maybe_inject("op")
        errs.append(ei.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__ == _KINDS[kind]
    assert str(errs[0]) == str(errs[1])
    if kind in ("fatal", "retryable", "spill_fail", "reject"):
        assert type(errs[0]).__module__.startswith("spark_rapids_jni_tpu_torch.")
    if kind == "reject":
        assert errs[0].retry_after_s == errs[1].retry_after_s == 0.25
        assert errs[0].cause == errs[1].cause == "injected"


def test_unknown_kind_and_bad_schedule_refused():
    for mod in (pf, rf):
        with pytest.raises(ValueError):
            mod.configure({"faults": {"x": {"type": "melt"}}})
        with pytest.raises(ValueError):
            mod.configure({"faults": {"x": {"type": "delay", "after": -1}}})


def test_delay_sleeps():
    pf.configure({"faults": {"op": {"type": "delay", "delayMs": 20}}})
    t0 = time.perf_counter()
    pf.maybe_inject("op")
    assert time.perf_counter() - t0 >= 0.018


@pytest.mark.parametrize("mod,dl", [(pf, pd), (rf, rd)], ids=["port", "reference"])
def test_hang_yields_to_the_deadline(mod, dl):
    mod.configure({"faults": {"op": {"type": "hang", "delayMs": 5000}}})
    t0 = time.perf_counter()
    with dl.scope(0.05):
        with pytest.raises(Exception) as ei:
            mod.maybe_inject("op")
    took = time.perf_counter() - t0
    assert type(ei.value).__name__ == "DeadlineExceeded" and "hang fault in op" in str(ei.value)
    assert took < 0.5
    # with no deadline a short hang is slept out in full
    mod.configure({"faults": {"op": {"type": "hang", "delayMs": 30}}})
    t0 = time.perf_counter()
    mod.maybe_inject("op")
    assert time.perf_counter() - t0 >= 0.028


def test_corrupt_and_torn_match():
    data = bytes(range(256)) * 3
    cfg = {"seed": 21, "faults": {"frame": {"type": "corrupt", "percent": 60},
                                  "journal.append": {"type": "torn_write", "percent": 50,
                                                     "delayMs": 100},
                                  "manifest": {"type": "torn_write"}}}
    outs = []
    for mod in (pf, rf):
        mod.configure(cfg)
        outs.append([mod.maybe_corrupt("frame", data) for _ in range(20)]
                    + [mod.maybe_torn("journal.append", data) for _ in range(20)]
                    + [mod.maybe_torn("manifest", data)]
                    # producer kinds are inert under maybe_inject
                    + [mod.maybe_inject("frame"), mod.maybe_inject("manifest")])
    assert outs[0] == outs[1]
    assert any(o != data for o in outs[0][:20])
    assert len(outs[0][40]) == 50  # delayMs defaults to 50: the bytes kept


def test_hot_reload_from_file(tmp_path):
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps({"faults": {}}))
    pf.configure_from_file(str(path))
    assert pf.is_enabled()
    pf.maybe_inject("op")  # empty: nothing fires
    path.write_text(json.dumps({"faults": {"op": {"type": "fatal"}}}))
    import os

    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 5))
    with pytest.raises(perr.FatalDeviceError):
        pf.maybe_inject("op")
    assert rerr.FatalDeviceError is not perr.FatalDeviceError
