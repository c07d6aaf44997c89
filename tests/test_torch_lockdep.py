"""Port: runtime lockdep and the dynamic race layer
(``analysis/lockdep.py``) held against the JAX package's. Each scenario
runs on one package, then on the other, never with both armed: the same
locks, threads and tracked state go through each package's shim and the
two reports must have the same shape (cycles, edges, self-deadlocks,
blocking events, race pairs by location and kind). The port's hooks
(metrics registry, memgov catalog, plan / subresult caches, the
single-flight map, the scheduler's tenants, the pool's health state) are
tracked when armed and untouched otherwise, and a served run through them
reports no race. After every test ``threading`` and ``time.sleep`` are the
originals again."""

import json
import re
import threading
import time

import pytest

from spark_rapids_jni_tpu.analysis import lockdep as RLD
from spark_rapids_jni_tpu_torch.analysis import lockdep as PLD

ORIGINALS = (threading.Lock, threading.RLock, threading.Condition, threading.Event,
             threading.Semaphore, threading.BoundedSemaphore, threading.Barrier,
             threading.Thread.start, threading.Thread.join, time.sleep)
SIDES = {"ref": (RLD, "SRJT" + "_"), "port": (PLD, "SRJTORCH_")}


def _current():
    return (threading.Lock, threading.RLock, threading.Condition, threading.Event,
            threading.Semaphore, threading.BoundedSemaphore, threading.Barrier,
            threading.Thread.start, threading.Thread.join, time.sleep)


@pytest.fixture(autouse=True)
def _threading_restored():
    assert not PLD.is_installed() or not RLD.is_installed()
    yield
    assert _current() == ORIGINALS, "a test left threading patched"
    assert not PLD.race_armed() and not RLD.race_armed()


class _Armed:
    """Arm one package's shim (and, with ``race``, its detector) in an
    isolated universe; disarm and restore threading on exit."""

    def __init__(self, ld, race=False):
        self.ld, self.race = ld, race

    def __enter__(self):
        assert _current() == ORIGINALS, "the other package is still armed"
        if self.race:
            self.ld.enable_race_detection()
        else:
            self.ld.install()
        self._iso = self.ld.isolated_state()
        return self._iso.__enter__()

    def __exit__(self, *exc):
        self._iso.__exit__(*exc)
        self.ld.uninstall()
        return False


def _shape(rep: dict) -> dict:
    """What both packages must agree on: every key, the counts, and the
    race pairs by (location without its registration suffix, kind)."""
    return {
        "keys": sorted(rep),
        "cycles": sorted(sorted(c["locks"]) for c in rep["cycles"]),
        "edges": sorted((e["from"], e["to"], e["count"]) for e in rep["edges"]),
        "self_deadlocks": [d["site"] for d in rep["self_deadlocks"]],
        "blocking_total": rep["blocking_total"],
        "blocking_held": [len(b["locks_held"]) for b in rep["blocking_events"]],
        "races": sorted({(re.sub(r"#\d+", "", p["location"]), p["kind"])
                         for p in rep["race_pairs"]}),
        "raced": rep["race_total"] > 0,
        "race_armed": rep["race_armed"],
    }


def _both(scenario, race=False):
    """Run ``scenario(ld)`` armed on each package in turn; return the two
    reports after asserting their shapes agree."""
    reps = {}
    for side, (ld, _) in SIDES.items():
        with _Armed(ld, race) as st:
            scenario(ld)
            reps[side] = ld.report(st)
    assert _shape(reps["port"]) == _shape(reps["ref"])
    return reps["port"]


def _run_threads(*fns):
    ts = [threading.Thread(target=f) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert not any(t.is_alive() for t in ts)


# -- lockdep ------------------------------------------------------------------


def test_two_lock_inversion_reports_cycle():
    def inversion(ld):
        a, b = threading.Lock(), threading.Lock()
        assert type(a).__name__ == "_TrackedLock"
        with a:
            with b:
                pass
        with b:
            with a:
                pass

    rep = _both(inversion)
    assert len(rep["cycles"]) == 1 and len(rep["cycles"][0]["locks"]) == 2
    assert all("test_torch_lockdep.py" in s for s in rep["cycles"][0]["locks"])
    assert all(e["stack"] for e in rep["edges"]) and len(rep["edges"]) == 2


def test_consistent_order_reports_no_cycle():
    def ordered(ld):
        a, b = threading.Lock(), threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass

    rep = _both(ordered)
    assert rep["cycles"] == [] and [e["count"] for e in rep["edges"]] == [3]


def test_self_deadlock_detected():
    def self_deadlock(ld):
        lk = threading.Lock()
        with lk:
            assert lk.acquire(blocking=False) is False

    assert len(_both(self_deadlock)["self_deadlocks"]) == 1


def test_rlock_reentry_is_not_a_self_deadlock():
    def reentry(ld):
        lk = threading.RLock()
        with lk:
            with lk:
                pass

    rep = _both(reentry)
    assert rep["self_deadlocks"] == [] and rep["cycles"] == []


def test_sleep_while_locked_recorded():
    def sleepy(ld):
        lk = threading.Lock()
        time.sleep(0)
        with lk:
            time.sleep(0)

    rep = _both(sleepy)
    assert rep["blocking_total"] == 1 and rep["blocking_events"][0]["locks_held"]


def test_condition_wait_keeps_held_stack_exact():
    def cond_wait(ld):
        cond = threading.Condition(threading.Lock())
        outer = threading.Lock()
        hits = []

        def waiter():
            with cond:
                cond.wait(timeout=5)
                with outer:
                    hits.append(1)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            cond.notify()
        t.join(10)
        assert hits == [1]

    rep = _both(cond_wait)
    assert rep["cycles"] == [] and rep["self_deadlocks"] == []


def test_threads_have_independent_held_stacks():
    def two_holders(ld):
        a, b = threading.Lock(), threading.Lock()
        barrier = threading.Barrier(2, timeout=10)

        def hold(lock):
            with lock:
                barrier.wait()
                barrier.wait()

        _run_threads(lambda: hold(a), lambda: hold(b))

    assert _both(two_holders)["edges"] == []


@pytest.mark.parametrize("edges", [{(1, 2), (2, 3)}, {(1, 2), (2, 1), (3, 4)}, {(5, 5)},
                                   {(1, 2), (2, 3), (3, 1)}])
def test_find_cycles_matches_reference(edges):
    assert PLD.find_cycles(edges) == RLD.find_cycles(edges)


def _cycle_report():
    return {"pid": 99, "locks": {}, "edges": [],
            "cycles": [{"locks": ["x.py:1", "y.py:2"], "keys": [1, 2]}],
            "self_deadlocks": [], "blocking_events": [], "blocking_total": 2}


def test_write_merge_and_gate_cli(tmp_path, capsys):
    got = {}
    for side, (ld, _) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        with _Armed(ld):
            a, b = threading.Lock(), threading.Lock()
            with a:
                with b:
                    pass
            rep = json.loads(open(ld.write_report(str(d / "lockdep_1.json"))).read())
        assert rep["edges"] and rep["cycles"] == []
        (d / "lockdep_2.json").write_text(json.dumps(_cycle_report()))
        out = str(d / "merged.json")
        rc = ld.main(["--merge", str(d), "--out", out])
        merged = json.loads(open(out).read())
        (d / "lockdep_2.json").unlink()
        rc_clean = ld.main(["--merge", str(d), "--out", out])
        got[side] = (rc, rc_clean, merged["reports"], len(merged["cycles"]),
                     merged["blocking_total"], sorted(merged))
    capsys.readouterr()
    assert got["port"] == got["ref"] == (1, 0, 2, 1, 2, got["ref"][5])


def test_flush_report_never_writes_from_isolated_state(tmp_path, monkeypatch):
    for side, (ld, prefix) in SIDES.items():
        monkeypatch.setenv(prefix + "LOCKDEP_DIR", str(tmp_path / side))
        with _Armed(ld):
            ld.flush_report()
        assert not (tmp_path / side).exists()


def test_report_dir_defaults_apart():
    # the two packages' reports never merge by default
    from spark_rapids_jni_tpu_torch.utils import knobs as pk

    assert pk.knob("SRJTORCH_LOCKDEP_DIR").default == "artifacts/lockdep_torch"
    assert PLD._report_dir() != RLD._report_dir() or PLD._report_dir() != "artifacts/lockdep"


def test_cross_process_inversion_fails_merge_gate(tmp_path, capsys):
    def rep(frm, to):
        return {"pid": 1, "locks": {}, "cycles": [], "self_deadlocks": [],
                "blocking_events": [], "blocking_total": 0,
                "edges": [{"from": frm, "to": to, "from_key": 1, "to_key": 2, "count": 1}]}

    (tmp_path / "lockdep_a.json").write_text(json.dumps(rep("x.py:1", "y.py:2")))
    (tmp_path / "lockdep_b.json").write_text(json.dumps(rep("y.py:2", "x.py:1")))
    assert PLD.merge_reports(str(tmp_path)) == RLD.merge_reports(str(tmp_path))
    merged = PLD.merge_reports(str(tmp_path))
    assert merged["cycles"] == [] and len(merged["site_cycles"]) == 1
    assert PLD.main(["--merge", str(tmp_path)]) == RLD.main(["--merge", str(tmp_path)]) == 1
    (tmp_path / "lockdep_b.json").write_text(json.dumps(rep("x.py:1", "x.py:1")))
    merged = PLD.merge_reports(str(tmp_path))
    assert merged == RLD.merge_reports(str(tmp_path))
    assert merged["site_cycles"] == [] and merged["site_self_edges"] == ["x.py:1"]
    assert PLD.main(["--merge", str(tmp_path)]) == 0
    capsys.readouterr()


def test_gate_fails_on_missing_reports(tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    for ld in (RLD, PLD):
        assert ld.main(["--merge", str(tmp_path / "nope")]) == 2
        assert ld.main(["--merge", str(tmp_path / "empty")]) == 2
        assert ld.main(["--merge", str(tmp_path / "empty"), "--allow-empty"]) == 0
    capsys.readouterr()


# -- the race layer -----------------------------------------------------------


def test_seeded_unguarded_write_is_reported_with_both_stacks():
    def seeded(ld):
        d = ld.track({}, "seeded")

        def w1():
            for i in range(100):
                d["x"] = i

        _run_threads(w1, w1)

    rep = _both(seeded, race=True)
    pair = rep["race_pairs"][0]
    assert "seeded" in pair["location"] and pair["a"]["stack"] and pair["b"]["stack"]
    assert pair["a"]["thread"] != pair["b"]["thread"]


def _ordered_by_lock(ld):
    d = ld.track({}, "locked")
    mu = threading.Lock()

    def w():
        for i in range(100):
            with mu:
                d["x"] = i

    _run_threads(w, w)


def _ordered_by_event(ld):
    d = ld.track({}, "ev")
    ev = threading.Event()
    got = []

    def writer():
        d["k"] = 42
        ev.set()

    def reader():
        assert ev.wait(10)
        got.append(d.get("k"))

    _run_threads(reader, writer)
    assert got == [42]


def _ordered_by_start_join(ld):
    d = ld.track({}, "tj")
    d["a"] = 1

    def child():
        d["a"] = d["a"] + 1

    t = threading.Thread(target=child)
    t.start()
    t.join(10)
    assert d["a"] == 2


def _ordered_by_semaphore(ld):
    d = ld.track({}, "sem")
    sem = threading.Semaphore(0)
    got = []

    def producer():
        d["p"] = 7
        sem.release()

    def consumer():
        assert sem.acquire(timeout=10)
        got.append(d.get("p"))

    _run_threads(consumer, producer)
    assert got == [7]


def _ordered_by_barrier(ld):
    d = ld.track({}, "bar")
    b = threading.Barrier(2, timeout=10)
    got = []

    def phase_writer():
        d["x"] = 9
        b.wait()

    def phase_reader():
        b.wait()
        got.append(d.get("x"))

    _run_threads(phase_reader, phase_writer)
    assert got == [9]


def _keyed_ewma_churn(ld):
    from spark_rapids_jni_tpu_torch.utils.metrics import KeyedEwma as PE
    from spark_rapids_jni_tpu.utils.metrics import KeyedEwma as RE

    e = (PE if ld is PLD else RE)(alpha=0.5, max_keys=8)
    e._entries = ld.track(e._entries, "ewma_entries")

    def churner(base):
        def run():
            for i in range(200):
                e.update(f"{base}.{i % 16}", float(i))
                e.get(f"{base}.{(i + 3) % 16}")
        return run

    _run_threads(churner("a"), churner("b"), churner("c"))
    assert len(e) <= 8


@pytest.mark.parametrize("scenario", [_ordered_by_lock, _ordered_by_event, _ordered_by_start_join,
                                      _ordered_by_semaphore, _ordered_by_barrier,
                                      _keyed_ewma_churn],
                         ids=["lock", "event", "start_join", "semaphore", "barrier", "keyed_ewma"])
def test_synchronised_access_is_clean(scenario):
    assert _both(scenario, race=True)["race_total"] == 0


def test_tracked_object_setattr_write_write_race():
    class Slot:
        __slots__ = ("alive", "strikes")

        def __init__(self):
            self.alive = True
            self.strikes = 0

    def bump_both(ld):
        s = ld.track(Slot(), "slot")

        def bump():
            for i in range(100):
                s.strikes = i

        _run_threads(bump, bump)

    rep = _both(bump_both, race=True)
    assert any("strikes" in p["location"] for p in rep["race_pairs"])


def test_track_disarmed_returns_original_object():
    for ld in (RLD, PLD):
        d = {}
        assert ld.track(d, "noop") is d and type(d) is dict


def test_unordered_write_read_is_reported():
    def write_read(ld):
        d = ld.track({}, "wr")
        hold = threading.Event()

        def writer():
            hold.wait(10)
            for _ in range(50):
                d["k"] = 1
                time.sleep(0)

        def reader():
            hold.wait(10)
            for _ in range(50):
                d.get("k")
                time.sleep(0)

        ts = [threading.Thread(target=writer), threading.Thread(target=reader)]
        for t in ts:
            t.start()
        hold.set()
        for t in ts:
            t.join(20)

    # which of write-read / read-write lands first is the scheduler's
    # choice: each package must see a race on the location
    reps = {}
    for side, (ld, _) in SIDES.items():
        with _Armed(ld, race=True) as st:
            write_read(ld)
            reps[side] = ld.report(st)
    for rep in reps.values():
        assert rep["race_total"] > 0
        assert {re.sub(r"#\d+", "", p["location"]) for p in rep["race_pairs"]} == {"wr['k']"}


def test_seeded_race_under_chaos_storm():
    def storm(ld):
        good = ld.track({}, "disciplined")
        bad = ld.track({}, "seeded_bare")
        mu = threading.Lock()

        def disciplined(n):
            def run():
                for i in range(50):
                    with mu:
                        good[f"k{n}"] = i
                        good.get(f"k{(n + 1) % 4}")
            return run

        def rogue():
            for i in range(50):
                bad["x"] = i
                time.sleep(0)

        _run_threads(disciplined(0), disciplined(1), disciplined(2), disciplined(3), rogue, rogue)

    reps = {}
    for side, (ld, _) in SIDES.items():
        with _Armed(ld, race=True) as st:
            storm(ld)
            reps[side] = ld.report(st)
    for rep in reps.values():
        assert rep["race_total"] > 0
        assert all("seeded_bare" in p["location"] for p in rep["race_pairs"])


def test_report_shape_and_merge_gate_can_fail(tmp_path, capsys):
    got = {}
    for side, (ld, _) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        with _Armed(ld, race=True) as st:
            t = ld.track({}, "gate")

            def w():
                for i in range(100):
                    t["x"] = i

            _run_threads(w, w)
            rep = ld.report(st)
        assert rep["race_armed"] is True and rep["tracked_objects"] >= 1
        (d / "lockdep_races.json").write_text(json.dumps(rep))
        out = str(d / "merged.json")
        rc = ld.main(["--merge", str(d), "--out", out])
        merged = json.loads(open(out).read())
        clean = {k: ([] if k == "race_pairs" else v) for k, v in rep.items()}
        clean["race_total"] = 0
        (d / "lockdep_races.json").write_text(json.dumps(clean))
        got[side] = (rc, ld.main(["--merge", str(d), "--out", out]), bool(merged["race_pairs"]),
                     merged["race_total"] == rep["race_total"], sorted(rep), sorted(merged))
    capsys.readouterr()
    assert got["port"] == got["ref"] and got["port"][:4] == (1, 0, True, True)


# -- the port's hooks ---------------------------------------------------------


def _hooked_maps():
    from spark_rapids_jni_tpu_torch import serve
    from spark_rapids_jni_tpu_torch.cache.flight import SingleFlight
    from spark_rapids_jni_tpu_torch.cache.plancache import PlanCache
    from spark_rapids_jni_tpu_torch.cache.subresult import SubresultCache
    from spark_rapids_jni_tpu_torch.memgov.catalog import BufferCatalog
    from spark_rapids_jni_tpu_torch.utils.metrics import Registry

    sched = serve.Scheduler(max_concurrent=1, name="hooks")
    try:
        return [Registry()._metrics, BufferCatalog()._entries, PlanCache(4, 2)._entries,
                SubresultCache(1 << 20)._entries, SingleFlight("h")._flights, sched._tenants]
    finally:
        sched.shutdown(drain=False, timeout_s=10)


def test_hooks_track_only_when_armed():
    assert all(type(m) is dict for m in _hooked_maps())
    with _Armed(PLD, race=True) as st:
        maps = _hooked_maps()
        assert all(type(m).__name__ == "_TrackedDict" for m in maps)
        assert st.tracked_objects >= len(maps)


def test_armed_served_run_and_pool_report_no_race():
    """Two dispatch slots serving q1 / q6 / q98 on the CPU through the
    tracked tenant table, metrics registry and catalog, then a 2-worker
    in-process pool (tracked worker records, EWMA map and hedge budget)
    answering a burst of group-bys: no race pair, no cycle."""
    from torch_serve_sides import PORT, clean, groupby_payload, inproc_pool

    from spark_rapids_jni_tpu_torch import serve
    from spark_rapids_jni_tpu_torch.models import tpcds, tpch

    with _Armed(PLD, race=True) as st:
        lineitem = tpch.gen_lineitem(600, seed=7, device="cpu")
        store = tpcds.gen_store(600, seed=3, device="cpu")
        sched = serve.Scheduler(max_concurrent=2, name="armed")
        try:
            hs = [sched.submit(tpch.q1, lineitem, tenant="t0"),
                  sched.submit(tpch.q6, lineitem, tenant="t1"),
                  sched.submit(tpcds.q98, store, tenant="t2"),
                  sched.submit(tpch.q6, lineitem, tenant="t0")]
            res = [h.result(120) for h in hs]
        finally:
            sched.shutdown(drain=False, timeout_s=30)
        assert res[1] == res[3]
        clean(PORT)
        pool = inproc_pool(PORT, size=2)
        try:
            outs = [pool.call(PORT.sidecar.OP_GROUPBY_SUM_F32, groupby_payload()) for _ in range(6)]
        finally:
            pool.shutdown()
        assert len(set(outs)) == 1
        assert all(type(w).__name__ == "_Worker" and getattr(type(w), "_srjt_tracked_class", False)
                   for w in pool._workers)
        rep = PLD.report(st)
    assert rep["race_pairs"] == [] and rep["cycles"] == [] and rep["self_deadlocks"] == []
    assert rep["tracked_objects"] >= 5


def test_threading_is_the_original_after_armed_tests():
    assert _current() == ORIGINALS
    assert threading.Lock is PLD._ORIG_LOCK is RLD._ORIG_LOCK
    assert time.sleep is PLD._ORIG_SLEEP
    assert not PLD.is_installed() and not RLD.is_installed()
