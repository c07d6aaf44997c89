"""Port: deadlines, cancel tokens and the circuit breaker
(``spark_rapids_jni_tpu_torch/utils/deadline.py``) held against the JAX
package's under one injected clock: scope nesting, cancellation, the
errors they raise and the breaker's state sequence match exactly."""

import math

import pytest

from spark_rapids_jni_tpu.utils import deadline as rd
from spark_rapids_jni_tpu.utils import errors as rerr
from spark_rapids_jni_tpu.utils import metrics as rmet
from spark_rapids_jni_tpu_torch.utils import deadline as pd
from spark_rapids_jni_tpu_torch.utils import errors as perr
from spark_rapids_jni_tpu_torch.utils import metrics as pmet


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _nesting(mod, clock):
    """Scope nesting under an injected clock: a trace of (budget,
    remaining, expired, done) at each step."""
    out = []
    with mod.scope(10.0, clock=clock) as outer:
        out.append((outer.budget_s, outer.remaining(), outer.expired()))
        clock.t += 4.0
        with mod.scope(20.0, clock=clock) as inner:  # can only shrink
            out.append((inner.budget_s, inner.remaining(), inner.token is outer.token))
            with mod.scope(None, clock=clock) as innermost:
                out.append((innermost.budget_s, innermost.remaining()))
        with mod.scope(2.0, clock=clock) as short:
            out.append((short.budget_s, short.remaining()))
            clock.t += 2.5
            out.append((short.expired(), short.done(), outer.expired()))
            with pytest.raises(Exception) as ei:
                mod.check("op.x")
            out.append((type(ei.value).__name__, str(ei.value)))
        clock.t += 4.0
        out.append((outer.expired(), mod.remaining()))
        with mod.scope(5.0, clock=clock) as dead:  # an expired outer
            out.append((dead.budget_s, dead.done()))
    out.append((mod.current(), mod.remaining(), mod.cancel("x")))
    return out


def test_scope_nesting_matches():
    assert _nesting(pd, Clock()) == _nesting(rd, Clock())


def _cancel(mod, clock):
    out = []
    tok = mod.CancelToken()
    with mod.scope(None, token=tok, clock=clock) as d:
        out.append((d.done(), math.isinf(d.remaining()), mod.remaining()))
        with mod.scope(3.0, clock=clock) as inner:
            out.append(mod.cancel("first"))
            tok.cancel("second")
            out.append((inner.cancelled(), tok.reason, inner.done()))
            e = inner.exceeded("op.y")
            out.append((type(e).__name__, str(e)))
    return out


def test_cancel_tokens_match():
    assert _cancel(pd, Clock()) == _cancel(rd, Clock())


def test_deadline_errors_are_the_taxonomys():
    assert issubclass(pd.DeadlineExceeded, perr.DeviceError)
    assert not issubclass(pd.DeadlineExceeded, perr.RetryableError)
    for mod in (pd, rd):
        with pytest.raises(ValueError):
            mod.Deadline(0.0)
        with pytest.raises(ValueError):
            mod.set_default_budget(-1.0)
    assert pd.DeadlineExceeded is perr.DeadlineExceeded
    assert rd.DeadlineExceeded is rerr.DeadlineExceeded


def _op_scope(mod):
    out = []
    prev = mod.default_budget()
    try:
        with mod.op_scope() as d:
            out.append(d is None)
        mod.set_default_budget(30.0)
        with mod.op_scope() as d:
            out.append(d.budget_s)
            with mod.op_scope() as inner:  # nested: rides the outer scope
                out.append(inner is d)
        with mod.op_scope(2.0) as d:
            out.append(d.budget_s)
    finally:
        mod.set_default_budget(prev)
    return out


def test_op_scope_matches():
    assert _op_scope(pd) == _op_scope(rd) == [True, 30.0, True, 2.0]


def _breaker(mod, met, clock):
    met.reset()
    br = mod.CircuitBreaker(name="t.breaker", threshold=3, cooldown_s=5.0, clock=clock)
    seq = []

    def step(what):
        if what == "allow":
            seq.append(("allow", br.allow(), br.state()))
        elif what == "fail":
            br.record_failure("boom")
            seq.append(("fail", br.state()))
        elif what == "ok":
            br.record_success()
            seq.append(("ok", br.state()))
        elif what == "abort":
            br.abort_probe()
            seq.append(("abort", br.state()))
        else:
            clock.t += what
    for what in ["allow", "fail", "fail", "allow", "fail", "allow", "allow", 4.9,
                 "allow", 0.2, "allow", "allow", "fail", "allow", 5.0, "allow",
                 "abort", "allow", "ok", "allow", "fail"]:
        step(what)
    snap = br.snapshot()
    reg = met.registry()
    counters = {k: reg.value(f"t.breaker.{k}") for k in
                ("opened_total", "half_opened_total", "closed_total", "fast_fails_total", "state")}
    br.configure(threshold=1)
    seq.append(br.state())
    with pytest.raises(ValueError):
        br.configure(cooldown_s=0)
    return seq, snap, counters


def test_circuit_breaker_state_sequence_matches():
    a = _breaker(pd, pmet, Clock())
    b = _breaker(rd, rmet, Clock())
    assert a == b
    assert a[1]["opened_total"] == 2 and a[1]["state"] == "closed"
    assert rd.BREAKER_STATE_CODES == pd.BREAKER_STATE_CODES


def test_breaker_reads_the_port_knobs(monkeypatch):
    monkeypatch.setenv("SRJTORCH_BREAKER_THRESHOLD", "7")
    monkeypatch.setenv("SRJTORCH_BREAKER_COOLDOWN_SEC", "2.5")
    snap = pd.CircuitBreaker(name="t.knobs").snapshot()
    assert (snap["threshold"], snap["cooldown_s"]) == (7, 2.5)
