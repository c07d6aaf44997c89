"""Port: the retry orchestrator (``spark_rapids_jni_tpu_torch/utils/retry.py``)
held against the JAX package's: seeded backoff sequences, attempts and
stats of ``call_with_retry``, its deadline cut-offs, and the tables
``retry_with_split`` reassembles."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.utils import deadline as rd
from spark_rapids_jni_tpu.utils import errors as rerr
from spark_rapids_jni_tpu.utils import memory as rmem
from spark_rapids_jni_tpu.utils import metrics as rmet
from spark_rapids_jni_tpu.utils import retry as rr
from spark_rapids_jni_tpu_torch.utils import deadline as pd
from spark_rapids_jni_tpu_torch.utils import errors as perr
from spark_rapids_jni_tpu_torch.utils import memory as pmem
from spark_rapids_jni_tpu_torch.utils import metrics as pmet
from spark_rapids_jni_tpu_torch.utils import retry as pr

PORT = (pr, perr, pd, pmet, pmem)
REF = (rr, rerr, rd, rmet, rmem)


@pytest.fixture(autouse=True)
def _fresh():
    for r, _, _, m, _ in (PORT, REF):
        r.reset_stats()
        m.reset()
    yield
    for r, _, _, m, _ in (PORT, REF):
        r.reset_stats()
        m.reset()


@pytest.mark.parametrize("seed", [0, 1, 77, 2024])
def test_backoff_sequences_match(seed):
    for kw in ({}, {"base_delay_ms": 3.0, "jitter": 0.5, "max_delay_ms": 40.0},
               {"jitter": 0.0}):
        a = pr.RetryPolicy(seed=seed, **kw)
        b = rr.RetryPolicy(seed=seed, **kw)
        assert [a.backoff_ms(i) for i in range(12)] == [b.backoff_ms(i) for i in range(12)]


def test_policy_validation_and_env(monkeypatch):
    for mod in (pr, rr):
        for bad in ({"max_attempts": 0}, {"base_delay_ms": -1}, {"jitter": 1.0},
                    {"split_depth": -1}):
            with pytest.raises(ValueError):
                mod.RetryPolicy(**bad)
    monkeypatch.setenv("SRJTORCH_RETRY_MAX_ATTEMPTS", "6")
    monkeypatch.setenv("SRJTORCH_RETRY_SEED", "5")
    monkeypatch.setenv("SRJTORCH_RETRY_BASE_DELAY_MS", "2")
    monkeypatch.setenv("SRJT_RETRY_MAX_ATTEMPTS", "6")
    monkeypatch.setenv("SRJT_RETRY_SEED", "5")
    monkeypatch.setenv("SRJT_RETRY_BASE_DELAY_MS", "2")
    a, b = pr.RetryPolicy.from_env(), rr.RetryPolicy.from_env()
    assert (a.max_attempts, a.base_delay_ms) == (b.max_attempts, b.base_delay_ms) == (6, 2.0)
    assert [a.backoff_ms(i) for i in range(5)] == [b.backoff_ms(i) for i in range(5)]


def _flaky(pkg, fails, kind="RetryableError"):
    r, err, _, _, _ = pkg
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= fails:
            raise getattr(err, kind)(f"transient #{len(calls)}")
        return x * 2
    return fn, calls


@pytest.mark.parametrize("fails,attempts", [(0, 4), (2, 4), (3, 4), (5, 4), (1, 1)])
def test_call_with_retry_attempts_and_stats(fails, attempts):
    out = []
    for pkg in (PORT, REF):
        r, err, _, met, _ = pkg
        fn, calls = _flaky(pkg, fails)
        slept = []
        pol = r.RetryPolicy(max_attempts=attempts, base_delay_ms=1.0, seed=3, sleep=slept.append)
        with met.enabled():
            try:
                res = r.call_with_retry(fn, 21, op_name="op.t", policy=pol)
            except err.RetryableError as e:
                res = ("raised", str(e))
        # metrics.reset() keeps registered names at 0, so a name another
        # test registered on one side only reads 0 there: drop zeros.
        counters = {k: v for k, v in met.counters_snapshot().items()
                    if k.startswith("retry.") and v}
        out.append((res, len(calls), slept, r.stats(), counters))
    assert out[0] == out[1]


def test_fatal_is_never_retried():
    for pkg in (PORT, REF):
        r, err, _, _, _ = pkg
        fn, calls = _flaky(pkg, 3, kind="FatalDeviceError")
        with pytest.raises(err.FatalDeviceError):
            r.call_with_retry(fn, 1, policy=r.RetryPolicy(max_attempts=5, base_delay_ms=0))
        assert len(calls) == 1 and r.stats()["fatal"] == 1


class _FakeClock:
    """A clock that moves only by the sleeps asked of it, so a cut-off does
    not depend on how the host schedules the test."""

    def __init__(self):
        self.t = 1000.0

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _deadline_case(pkg, budget_s, base_ms):
    r, err, dl, met, _ = pkg
    fn, calls = _flaky(pkg, 10)
    clock = _FakeClock()
    pol = r.RetryPolicy(max_attempts=8, base_delay_ms=base_ms, jitter=0.0, seed=1,
                        sleep=clock.sleep)
    with met.enabled():
        with dl.scope(budget_s, clock=clock.now):
            with pytest.raises(err.DeadlineExceeded) as ei:
                r.call_with_retry(fn, 1, op_name="op.d", policy=pol)
    st = r.stats()
    return (len(calls), st["deadline_exceeded"], st["backoff_truncated"],
            type(ei.value.__cause__).__name__, str(ei.value))


@pytest.mark.parametrize("budget_s,base_ms", [(0.05, 30.0), (0.2, 40.0)])
def test_deadline_cut_offs_match(budget_s, base_ms):
    # backoffs of base, 2*base, ... : the one that would cross the budget
    # raises at once, so both sides stop after the same attempt
    assert _deadline_case(PORT, budget_s, base_ms) == _deadline_case(REF, budget_s, base_ms)


def test_capacity_retry_is_counted():
    for pkg in (PORT, REF):
        r, _, _, met, _ = pkg
        with met.enabled():
            r.record_capacity_retry(2)
        assert r.stats()["capacity_retries"] == 2
        assert met.registry().value("shuffle.capacity_retries") == 2


def test_scoped_enable_restores():
    prev = pr.policy()
    assert not pr.is_enabled()
    with pr.enabled(base_delay_ms=1, seed=4) as pol:
        assert pr.is_enabled() and pol.base_delay_ms == 1.0 and pr.policy() is pol
    assert not pr.is_enabled() and pr.policy() is prev


def _split_run(pkg, rows_cap, split_depth, n=37):
    """retry_with_split over a table whose batches fail above ``rows_cap``
    rows with the memory tier's RESOURCE_EXHAUSTED class."""
    r, err, _, met, mem = pkg
    if pkg is PORT:
        from spark_rapids_jni_tpu_torch.columnar import Column, Table
        mk = lambda a: Column.from_numpy(a, device="cpu")  # noqa: E731
    else:
        from spark_rapids_jni_tpu.columnar import Column, Table
        mk = Column.from_numpy
    rng = np.random.default_rng(n)
    t = Table([mk(rng.integers(-9, 9, n).astype(np.int64)),
               mk(rng.normal(size=n).astype(np.float32))], ["a", "b"])
    seen = []

    def fn(b):
        seen.append(b.num_rows)
        if b.num_rows > rows_cap:
            raise mem.MemoryBudgetExceeded(f"{b.num_rows} rows over the budget")
        return b
    pol = r.RetryPolicy(max_attempts=2, base_delay_ms=0.0, split_depth=split_depth, seed=0)
    with met.enabled():
        try:
            out = r.retry_with_split(fn, t, op_name="op.s", policy=pol)
        except err.RetryableError as e:
            return ("raised", type(e).__name__, seen, r.stats())
    cols = [np.asarray(c.to_numpy() if hasattr(c, "to_numpy") else c.data) for c in out.columns]
    return ([c.tolist() for c in cols], seen, r.stats(),
            met.registry().value("retry.splits"))


@pytest.mark.parametrize("rows_cap,split_depth", [(100, 3), (20, 3), (9, 3), (5, 3), (9, 1)])
def test_retry_with_split_matches(rows_cap, split_depth):
    assert _split_run(PORT, rows_cap, split_depth) == _split_run(REF, rows_cap, split_depth)


def test_card_oom_text_is_resource_exhausted():
    assert pr.is_resource_exhausted(perr.RetryableError("CUDA out of memory. Tried to allocate"))
    assert pr.is_resource_exhausted(pmem.MemoryBudgetExceeded("x"))
    assert not pr.is_resource_exhausted(perr.RetryableError("Connection reset"))


@pytest.mark.parametrize("fails", [1, 9])
def test_a_retried_call_leaves_no_cycle_holding_its_inputs(fails):
    # a retried error's traceback holds the attempt's frames: the port
    # drops it on the way out, so an attempt's tensors are freed without
    # waiting for the cycle collector
    import gc
    import weakref

    import torch

    gc.disable()
    try:
        t = torch.ones(8)
        ref = weakref.ref(t)
        fn, calls = _flaky(PORT, fails)
        try:
            pr.call_with_retry(fn, t, policy=pr.RetryPolicy(max_attempts=3, base_delay_ms=0.0))
        except perr.RetryableError:
            pass
        del t, fn, calls
        assert ref() is None
    finally:
        gc.enable()
