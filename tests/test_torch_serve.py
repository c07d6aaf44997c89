"""Port: the serving tier's scheduler (``spark_rapids_jni_tpu_torch/serve/``)
held against the JAX package's.

The same scripted submissions go to both packages' ``Scheduler``
(tenants and weights, priorities, bounded queues with eviction, a
dead-on-arrival deadline, a cancel, an expiry in the queue, a pressure
trip, a dark pool, an injected reject, shutdown): the dispatch order,
the shed causes, the final states, the tenant snapshots and the
``serve.*`` counter deltas (zeros dropped) are equal. The q1/q6/q98
pipelines served by each package answer bit for bit alike, and the
reference's serve admission (out-of-core plans admit their
per-partition peak) and serve integration (the plan cache, bad
estimates, the forecast shed) cases are ported."""

import threading
import time

import numpy as np
import pytest

import torch_serve_sides as S
from torch_serve_sides import PORT, REF, SIDES

from spark_rapids_jni_tpu.models import tpcds as rtpcds, tpch as rtpch
from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds, tpch as ptpch


@pytest.fixture(autouse=True)
def _clean():
    for s in SIDES:
        S.clean(s)
    yield
    for s in SIDES:
        S.clean(s)
        s.serve.shutdown_scheduler(drain=False, timeout_s=10)


def _wait_running(h, timeout=10):
    t_end = time.monotonic() + timeout
    while h.status() != "running":
        assert time.monotonic() < t_end, h
        time.sleep(0.002)


def _script(side, monkeypatch):
    """Everything queues behind a gate query in one slot; the dispatch
    order after the gate opens is the stride scheduler's."""
    order, handles, sheds = [], {}, []
    sched = side.serve.Scheduler(max_concurrent=1, queue_depth=3, max_queued=7,
                                 max_queue_age_s=60, name="script")
    gate = threading.Event()

    def job(label):
        def fn():
            order.append(label)
            return label
        return fn

    def submit(label, tenant, **kw):
        try:
            handles[label] = sched.submit(job(label), tenant=tenant, **kw)
        except side.errors.Overloaded as e:
            sheds.append((label, e.cause))

    try:
        sched.set_tenant_weight("a", 2.0)
        g = sched.submit(gate.wait, 30, tenant="gate")
        _wait_running(g)
        for i in range(3):
            submit(f"a{i}", "a")
        submit("a3", "a")  # queue full, does not outrank: shed
        submit("a4", "a", priority=5)  # outranks: evicts a2
        submit("b0", "b")
        submit("b1", "b", priority=1)
        submit("c0", "c", deadline_s=0.05)  # expires while queued
        submit("c1", "c")
        handles["b0"].cancel("test")
        submit("c2", "c")  # 7 queued: the next one trips pressure
        submit("d0", "d")
        submit("doa", "d", deadline_s=0.0)
        side.faultinj.configure({"seed": 5, "faults": {"serve.admit": {
            "type": "reject", "percent": 100, "interceptionCount": 1}}})
        submit("inj", "d")
        side.faultinj.disable()
        br = side.sidecar.breaker()
        for _ in range(br.snapshot()["threshold"]):
            br.record_failure(cause="test")
        submit("dark", "d", host_eligible=False)
        br.reset()
        time.sleep(0.15)  # c0's budget runs out in the queue
        gate.set()
        assert g.result(10) is True
        for h in handles.values():
            h._done.wait(10)
        snap = sched.snapshot()
    finally:
        gate.set()
        sched.shutdown(drain=True, timeout_s=10)
    submit("late", "a")
    states = {k: h.status() for k, h in sorted(handles.items())}
    excs = {k: type(h.exception()).__name__ for k, h in sorted(handles.items()) if h.exception()}
    return order, sheds, states, excs, snap["tenants"]


def test_scheduler_script_matches(monkeypatch):
    seen = []
    for s in SIDES:
        c0 = S.counters(s, "serve.")
        obs = _script(s, monkeypatch)
        d = S.delta(c0, S.counters(s, "serve."))
        seen.append((obs, d))
    assert seen[1] == seen[0]
    order, sheds, states = seen[0][0][:3]
    # stride order: every lane enters at the pass floor, and a's weight 2
    # advances its pass half as far a dispatch
    assert order == ["a0", "b1", "c1", "a1", "a4", "c2"]
    assert dict(sheds)["a3"] == "queue_full" and dict(sheds)["late"] == "shutting_down"
    assert {c for _, c in sheds} >= {"queue_full", "pressure", "doa_deadline", "injected",
                                     "breaker", "shutting_down"}
    assert states["a2"] == "shed" and states["b0"] == "cancelled" and states["c0"] == "expired"


def _serve_pipelines(side, tpch, tpcds, dev):
    kw = {} if dev is None else {"device": dev}
    lineitem = tpch.gen_lineitem(2000, seed=7, **kw)
    store = tpcds.gen_store(2000, seed=3, **kw)
    sched = side.serve.Scheduler(max_concurrent=2, name="pipes")
    try:
        hs = [sched.submit(tpch.q1, lineitem, tenant="t0"),
              sched.submit(tpch.q6, lineitem, tenant="t1"),
              sched.submit(tpcds.q98, store, tenant="t2")]
        q1, q6, q98 = [h.result(300) for h in hs]
    finally:
        sched.shutdown(drain=False, timeout_s=30)
    host = (lambda c: np.asarray(c.data)) if dev is None else (
        lambda c: c.to_numpy() if c.dtype.is_fixed_width else c.data.cpu().numpy())
    return ([host(c).tobytes() for c in q1.columns], q6,
            [host(c).tobytes() for c in q98.columns], q98.names,
            side.journal.result_digest(q1), side.journal.result_digest((q1, q6, q98)))


def test_served_pipelines_answer_bit_for_bit():
    ref = _serve_pipelines(REF, rtpch, rtpcds, None)
    port = _serve_pipelines(PORT, ptpch, ptpcds, "cpu")
    assert port == ref


# ---------------------------------------------------------------------------
# serve admission (out-of-core) and serve integration (the plan cache)
# ---------------------------------------------------------------------------


def _q1_ir(P):
    return P.Sort(
        P.Aggregate(
            P.Filter(P.Scan("lineitem"), P.pcol("l_quantity") >= P.plit(0.0)),
            keys=("l_returnflag", "l_linestatus"),
            aggs=(P.AggSpec("l_quantity", "sum", "sum_qty"),
                  P.AggSpec("l_extendedprice", "sum", "sum_price"),
                  P.AggSpec(None, "count_all", "count_order")),
        ),
        keys=(("l_returnflag", True), ("l_linestatus", True)),
    )


def _bytes(t):
    return [(c.to_numpy() if c.dtype.is_fixed_width else c.data.cpu().numpy()).tobytes()
            for c in t.columns]


def test_submit_admits_the_per_partition_peak(monkeypatch):
    from spark_rapids_jni_tpu_torch import plan as PP

    tables = {"lineitem": ptpch.gen_lineitem(3000, seed=7, device="cpu")}
    ir = _q1_ir(PP)
    want = _bytes(PP.compile_ir(ir, tables, name="incore")())
    for k, v in {"OOC_ENABLED": "1", "OOC_PARTITIONS": "4",
                 "DEVICE_MEMORY_BUDGET": str(36 * 1024)}.items():
        monkeypatch.setenv(PORT.prefix + k, v)
    reg = PORT.metrics.registry()
    adm0 = reg.value("memgov.ooc_admissions")
    s = PORT.serve.Scheduler(max_concurrent=1, queue_depth=4, name="ooc-adm")
    try:
        with PORT.memgov.enabled():
            h = s.submit(ir, tables, tenant="ooc")
            assert h._memory_bytes is not None and h._memory_bytes <= 36 * 1024
            out = h.result(timeout_s=300)
        assert _bytes(out) == want
        assert reg.value("memgov.ooc_admissions") > adm0
        assert PORT.memgov.catalog().kind_stats("partition") == (0, 0)
    finally:
        s.shutdown(drain=False, timeout_s=10.0)
        PORT.memgov.reset()


def test_cached_serving_is_bit_exact(monkeypatch):
    from spark_rapids_jni_tpu_torch import cache, plan as PP
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    rng = np.random.default_rng(23)
    tabs = {"fact": Table([Column.from_numpy(np.arange(96, dtype=np.int64), device="cpu"),
                           Column.from_numpy(rng.integers(0, 5, 96).astype(np.int64), device="cpu"),
                           Column.from_numpy(rng.random(96), device="cpu")], ["v", "k", "p"])}

    def mk(cut):
        return PP.Aggregate(PP.Filter(PP.Scan("fact"), PP.pcol("v") < PP.plit(cut)),
                            keys=("k",), aggs=(PP.AggSpec("v", "sum", "s"),))

    oracle = {cut: PP.compile_ir(mk(cut), tabs, name="oracle")().to_pydict() for cut in (10, 50, 90)}
    monkeypatch.setenv(PORT.prefix + "PLAN_CACHE", "1")
    monkeypatch.setenv(PORT.prefix + "SUBRESULT_CACHE", "1")
    cache.reset()
    hits0 = PORT.metrics.registry().value("cache.hits")
    s = PORT.serve.Scheduler(max_concurrent=2, queue_depth=32, name="csrv")
    try:
        handles = [(cut, s.submit(mk(cut), tabs, tenant="t")) for cut in (10, 50, 90)
                   for _ in range(4)]
        for cut, h in handles:
            assert h.result(60).to_pydict() == oracle[cut]
    finally:
        assert s.shutdown(drain=False, timeout_s=30.0)
        cache.reset()
    assert PORT.metrics.registry().value("cache.hits") - hits0 >= 9


def _bad_estimate_and_forecast(side, monkeypatch):
    reg = side.metrics.registry()
    out = []
    s = side.serve.Scheduler(max_concurrent=1, queue_depth=8, name="best")
    try:
        def fn():
            return 7
        fn.estimated_memory_bytes = 0
        before = reg.value("serve.bad_estimate")
        h = s.submit(fn, tenant="t")
        out += [h.result(10), reg.value("serve.bad_estimate") - before, h._memory_bytes]
        h2 = s.submit(lambda: 8, tenant="t", memory_bytes=-5)
        out += [h2.result(10), reg.value("serve.bad_estimate") - before]
    finally:
        s.shutdown(drain=False, timeout_s=30.0)
    monkeypatch.setenv(side.prefix + "SERVE_FORECAST_BUDGET_SEC", "5")
    s = side.serve.Scheduler(max_concurrent=1, queue_depth=8, name="fcst")
    ev = threading.Event()
    try:
        blocker = s.submit(ev.wait, 30, tenant="t")
        _wait_running(blocker)

        def pricey():
            return 1
        pricey.predicted_cost_s = 10.0
        before = reg.value("serve.shed.forecast")
        try:
            s.submit(pricey, tenant="t")
        except side.errors.Overloaded as e:
            out.append(e.cause)
        out.append(reg.value("serve.shed.forecast") - before)
        h = s.submit(lambda: 2, tenant="t")  # no cost evidence: never forecast-shed
        ev.set()
        out.append(h.result(10))
    finally:
        ev.set()
        s.shutdown(drain=False, timeout_s=30.0)
    return out


def test_bad_estimates_and_the_forecast_shed_match(monkeypatch):
    seen = [_bad_estimate_and_forecast(s, monkeypatch) for s in SIDES]
    assert seen[1] == seen[0] == [7, 1, None, 8, 2, "forecast", 1, 2]


def test_stats_sections_and_leak_report_match():
    seen = []
    for s in SIDES:
        sched = s.serve.scheduler(max_concurrent=1, name="default-test")
        assert s.serve.submit(lambda: 3, tenant="t").result(10) == 3
        sec = s.serve.stats_section()
        seen.append((sorted(sec), sorted(sec["shed"]), s.serve.live_scheduler_count() >= 1,
                     sched.name))
        s.serve.shutdown_scheduler(drain=True, timeout_s=10)
        seen[-1] += (s.serve.leak_report(),)
    assert seen[1] == seen[0]
    assert list(PORT.serve.SHED_CAUSES) == list(REF.serve.SHED_CAUSES)
    assert sorted(PORT.serve.__all__) == sorted(REF.serve.__all__)


class _Cluster:
    """A cluster view's surface the scheduler reads: quorum and ranks."""

    def __init__(self, alive, world):
        self.alive, self.world = alive, world

    def has_quorum(self):
        return len(self.alive) * 2 > self.world

    def alive_ranks(self):
        return list(self.alive)


def test_cluster_quorum_shed_matches():
    seen = []
    for s in SIDES:
        c0 = S.counters(s, "serve.")
        sched = s.serve.Scheduler(max_concurrent=1, name="quorum")
        try:
            sched.attach_cluster(_Cluster([0, 1, 2, 3], 4))
            out = [sched.submit(lambda: 1, tenant="t").result(10)]
            sched.attach_cluster(_Cluster([0], 4))
            try:
                sched.submit(lambda: 2, tenant="t")
            except s.errors.Overloaded as e:
                out.append((e.cause, str(e).split(": ", 1)[1]))
            sched.attach_cluster(None)
            out.append(sched.submit(lambda: 3, tenant="t").result(10))
        finally:
            sched.shutdown(drain=True, timeout_s=10)
        seen.append((out, S.delta(c0, S.counters(s, "serve."))))
    assert seen[1] == seen[0]
    assert seen[0][0][1][0] == "cluster_degraded"
