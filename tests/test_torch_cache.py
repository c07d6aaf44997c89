"""Port: the caching tier (``spark_rapids_jni_tpu_torch/cache``) held against
the JAX package's: parameterized fingerprints and rebinds, the
compiled-plan cache's hit / rebind / evict economics, the single-flight
latch, the governed subresult cache and table-generation invalidation
(``tests/test_cache.py``; its serving cases wait for the serving tier).
Each case runs on both packages, every port tensor on the CPU, and
compares results bit for bit, the ``cache.*`` counter deltas (zeros
dropped) and the snapshots."""

import threading
import time

import numpy as np
import pytest

from torch_memgov_sides import PORT, REF, SIDES, clean, counters, delta

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu import cache as rcache, plan as RP
from spark_rapids_jni_tpu.cache import plancache as rplancache
from spark_rapids_jni_tpu.cache.flight import SingleFlight as RFlight
from spark_rapids_jni_tpu.columnar import Column as RC, Table as RT
from spark_rapids_jni_tpu_torch import cache as pcache, plan as PP
from spark_rapids_jni_tpu_torch.cache import plancache as pplancache
from spark_rapids_jni_tpu_torch.cache.flight import SingleFlight as PFlight
from spark_rapids_jni_tpu_torch.columnar import Column as PC, Table as PT

MOD = {REF.name: (rcache, RP, rplancache, RFlight), PORT.name: (pcache, PP, pplancache, PFlight)}


@pytest.fixture(autouse=True)
def _clean_cache(monkeypatch):
    for s in SIDES:
        for suffix in ("PLAN_CACHE", "SUBRESULT_CACHE"):
            monkeypatch.delenv(s.prefix + suffix, raising=False)
        MOD[s.name][0].reset()
        clean(s)
    yield
    for s in SIDES:
        MOD[s.name][0].reset()
        clean(s)


@pytest.fixture
def armed(monkeypatch):
    for s in SIDES:
        monkeypatch.setenv(s.prefix + "PLAN_CACHE", "1")
        monkeypatch.setenv(s.prefix + "SUBRESULT_CACHE", "1")


def _tables(s, rows=120, v_dtype=np.int64):
    rng = np.random.default_rng(11)
    arrays = [np.arange(rows, dtype=v_dtype), rng.integers(0, 7, rows).astype(np.int64),
              rng.random(rows)]
    if s is REF:
        cols = [RC.from_numpy(a) for a in arrays]
        return {"fact": RT(cols, ["v", "k", "p"])}
    cols = [PC.from_numpy(a, device="cpu") for a in arrays]
    return {"fact": PT(cols, ["v", "k", "p"])}


def _mk(P, cut, factor=2.0):
    return P.Aggregate(
        P.Filter(P.Scan("fact"), (P.pcol("v") < P.plit(cut)) & (P.pcol("p") < P.plit(factor))),
        keys=("k",), aggs=(P.AggSpec("v", "sum", "s"),))


def _result(s, table):
    return {n: s.host(c).tobytes() for n, c in zip(table.names, table.columns)}


def both(case):
    """``case(side, cache, P, plancache)`` on both packages; the port's
    observations and its ``cache.*`` / ``memgov.*`` counter deltas must be
    the reference's."""
    seen = []
    for s in SIDES:
        c0 = counters(s, ("cache.", "memgov."))
        obs = case(s, *MOD[s.name][:3])
        seen.append((obs, delta(c0, counters(s, ("cache.", "memgov.")))))
    assert seen[1] == seen[0]
    return seen[0]


class TestParamFingerprint:
    def test_keys_values_and_rebinds_match_the_reference(self):
        def case(s, cache, P, pc):
            from importlib import import_module

            rw = import_module(P.__name__ + ".rewrites")
            pf = lambda p: rw.parameterized_fingerprint(p)  # noqa: E731
            a, b = pf(_mk(P, 10)), pf(_mk(P, 99))
            sorted_ = pf(P.Sort(_mk(P, 10), keys=(("s", False),)))
            f = lambda lit: pf(P.Filter(P.Scan("fact"), P.pcol("v") < P.plit(lit)))  # noqa
            tags = len({f(10).key, f(10.0).key, f(np.int32(10)).key})
            orig = _mk(P, 1998, 0.5)
            mapping = {b_: 2001 for b_ in pf(orig).bindings if b_[0] == "int"}
            rebound = rw.rebind_literals(orig, mapping)
            return (a.key, a.key == b.key, a.values, b.values, sorted_.key != a.key, tags,
                    rw.fingerprint(rebound) == rw.fingerprint(_mk(P, 2001, 0.5)),
                    rw.fingerprint(_mk(P, 10)) != rw.fingerprint(_mk(P, 99)))

        obs, _ = both(case)
        assert obs[1] is True and obs[4:] == (True, 3, True, True)


class TestPlanCache:
    def test_off_knob_is_plain_compile(self):
        def case(s, cache, P, pc):
            fn = cache.compile_cached(_mk(P, 10), _tables(s), name="off")
            return isinstance(fn, cache.CachedQuery), type(fn).__name__

        assert both(case)[0] == (False, "CompiledPlan")

    def test_miss_exact_hit_rebind_and_cost(self, armed):
        def case(s, cache, P, pc):
            tabs = _tables(s)
            q1 = cache.compile_cached(_mk(P, 10), tabs, name="q")
            q2 = cache.compile_cached(_mk(P, 10), tabs, name="q")
            same = q2.compiled is q1.compiled
            first = q1.predicted_cost_s
            r1, r2 = _result(s, q1()), _result(s, q2())
            q3 = cache.compile_cached(_mk(P, 77), tabs, name="q")
            oracle = _result(s, P.compile_ir(_mk(P, 77), tabs, name="oracle")())
            return (same, first, r1 == r2, r1, _result(s, q3()) == oracle, oracle,
                    q1.predicted_cost_s > 0, cache.plan_cache().snapshot())

        obs, d = both(case)
        assert obs[0] is True and obs[1] is None and obs[2] is True and obs[4] is True
        assert d["cache.misses"] == 1 and d["cache.hits"] == 2 and d["cache.rebinds"] == 1

    def test_verifier_gate_blocks_insert(self, armed, monkeypatch):
        for s in SIDES:
            monkeypatch.setattr(MOD[s.name][2], "verify_for_cache",
                                lambda *a, **k: ["simulated violation"])

        def case(s, cache, P, pc):
            tabs = _tables(s)
            q1 = cache.compile_cached(_mk(P, 10), tabs, name="q")
            q2 = cache.compile_cached(_mk(P, 10), tabs, name="q")
            return _result(s, q1()) == _result(s, q2())

        obs, d = both(case)
        assert obs is True and d["cache.insert_rejected"] == 2 and d["cache.misses"] == 2

    def test_lru_eviction_and_catalog_signature(self, armed, monkeypatch):
        for s in SIDES:
            monkeypatch.setenv(s.prefix + "CACHE_PLAN_ENTRIES", "2")

        def case(s, cache, P, pc):
            tabs = _tables(s)
            cache.compile_cached(_mk(P, 1), tabs, name="a")
            cache.compile_cached(P.Sort(_mk(P, 1), keys=(("s", False),)), tabs, name="b")
            cache.compile_cached(P.Limit(P.Sort(_mk(P, 1), keys=(("s", False),)), 3), tabs,
                                 name="c")
            entries = cache.plan_cache().snapshot()["entries"]
            other = _tables(s, rows=8, v_dtype=np.int32)
            cache.compile_cached(_mk(P, 5), other, name="q")
            return entries, pc.catalog_signature(tabs), pc.catalog_signature(other)

        obs, d = both(case)
        assert obs[0] == 2 and obs[1] != obs[2]
        assert d["cache.evictions"] == 2 and d["cache.misses"] == 4


class TestSingleFlight:
    def test_fan_out_cancel_and_failure_isolation(self):
        def case(s, cache, P, pc):
            Flight = MOD[s.name][3]
            sf = Flight("t")
            gate = threading.Event()
            calls = []

            def thunk():
                gate.wait(5)
                calls.append(1)
                return {"x": 1}

            results = [None] * 6

            def run(i):
                results[i] = sf.run("k", thunk)

            ts = [threading.Thread(target=run, args=(i,)) for i in range(6)]
            for t in ts:
                t.start()
            time.sleep(0.1)
            gate.set()
            for t in ts:
                t.join(10)
            out = {"calls": len(calls), "results": results}
            # a waiter's expiry never cancels the leader
            gate2, got = threading.Event(), {}

            def leader():
                got["leader"] = sf.run("k2", lambda: (gate2.wait(10), 42)[1])

            def waiter():
                try:
                    with s.deadline.scope(0.1):
                        sf.run("k2", lambda: 0)
                    got["waiter"] = "no-raise"
                except s.errors.DeadlineExceeded:
                    got["waiter"] = "expired"

            tl = threading.Thread(target=leader)
            tl.start()
            time.sleep(0.05)
            tw = threading.Thread(target=waiter)
            tw.start()
            tw.join(10)
            gate2.set()
            tl.join(10)
            out["cancel"] = dict(got)
            # a leader's failure is not fanned out
            gate3, n, fail = threading.Event(), [], {}

            def thunk3():
                n.append(1)
                if len(n) == 1:
                    gate3.wait(5)
                    raise RuntimeError("leader crashed")
                return "recomputed"

            def leader3():
                try:
                    sf.run("k3", thunk3)
                except RuntimeError:
                    fail["leader"] = "raised"

            def waiter3():
                fail["waiter"] = sf.run("k3", thunk3)

            t1 = threading.Thread(target=leader3)
            t1.start()
            time.sleep(0.05)
            t2 = threading.Thread(target=waiter3)
            t2.start()
            time.sleep(0.05)
            gate3.set()
            t1.join(10)
            t2.join(10)
            out["fail"] = dict(fail)
            return out

        obs, d = both(case)
        assert obs == {"calls": 1, "results": [{"x": 1}] * 6,
                       "cancel": {"waiter": "expired", "leader": 42},
                       "fail": {"leader": "raised", "waiter": "recomputed"}}
        assert d["cache.share"] == 7 and d["cache.share_fallback"] == 1


class TestSubresultCache:
    def test_spill_rematerialize_and_governed_bytes(self, armed):
        def case(s, cache, P, pc):
            tabs = _tables(s)
            first = _result(s, cache.compile_cached(_mk(P, 50), tabs, name="q")())
            sc = cache.subresult_cache()
            with sc._lock:
                handles = [e.handle for e in sc._entries.values()]
            for h in handles:
                h.spill()
            again = _result(s, cache.compile_cached(_mk(P, 50), tabs, name="q")())
            governed = s.memgov.catalog().kind_stats("cache")
            snap = sc.snapshot()
            cache.reset()
            return (first == again, first, governed, snap["entries"], snap["bytes"],
                    s.memgov.catalog().kind_stats("cache"))

        obs, d = both(case)
        assert obs[0] is True and obs[2][0] > 0 and obs[5] == (0, 0)
        assert d["cache.sub_hits"] > 0 and "cache.sub_corrupt" not in d

    def test_corrupt_entry_and_byte_cap(self, armed, monkeypatch):
        def case(s, cache, P, pc):
            tabs = _tables(s)
            first = _result(s, cache.compile_cached(_mk(P, 50), tabs, name="q")())
            sc = cache.subresult_cache()
            with sc._lock:
                regkeys = [e.regkey for e in sc._entries.values()]
            for rk in regkeys:
                s.memgov.catalog().unregister(rk)
            again = _result(s, cache.compile_cached(_mk(P, 50), tabs, name="q")())
            cache.reset()
            monkeypatch.setenv(s.prefix + "CACHE_SUBRESULT_BYTES", "1")
            cache.compile_cached(_mk(P, 50), _tables(s), name="q")()
            return first == again, cache.subresult_cache().snapshot()["entries"]

        obs, d = both(case)
        assert obs == (True, 1)
        assert d["cache.sub_corrupt"] > 0 and d["cache.sub_evictions"] > 0

    def test_invalidate_table_and_new_objects(self, armed):
        def case(s, cache, P, pc):
            tabs = _tables(s)
            first = _result(s, cache.compile_cached(_mk(P, 50), tabs, name="q")())
            entries = cache.subresult_cache().snapshot()["entries"]
            c0 = counters(s, ("cache.",))
            cache.invalidate_table(tabs["fact"])
            inv = delta(c0, counters(s, ("cache.",)))
            after = cache.subresult_cache().snapshot()["entries"]
            c1 = counters(s, ("cache.",))
            again = _result(s, cache.compile_cached(_mk(P, 50), tabs, name="q")())
            recompute = delta(c1, counters(s, ("cache.",)))
            c2 = counters(s, ("cache.",))
            cache.compile_cached(_mk(P, 50), _tables(s), name="q")()
            fresh = delta(c2, counters(s, ("cache.",)))
            return (entries, inv, after, first == again, recompute, fresh,
                    sorted(cache.stats_section()["counters"].items()) != [])

        obs, _ = both(case)
        assert obs[0] > 0 and obs[1]["cache.invalidations"] > 0 and obs[2] == 0
        assert obs[3] is True and "cache.sub_hits" not in obs[4]
        assert "cache.sub_hits" not in obs[5]


def test_off_posture_stats_inert():
    def case(s, cache, P, pc):
        sec = cache.stats_section()
        return sec["enabled"], "plan" in sec, sorted(sec["counters"])

    obs, _ = both(case)
    assert obs[0] == {"plan": False, "subresult": False, "sharing": True} and obs[1] is False
