"""Port: the sidecar worker pool (``spark_rapids_jni_tpu_torch/sidecar_pool.py``)
held against the JAX package's.

Each case runs the same steps on both packages (``torch_serve_sides``):
the slab allocator, routing and failover, respawn with SET_ARENA
re-hydration, the pool-scoped breaker and the host-engine degrade, STATS
aggregation, gray-failure quarantine and hedged dispatch. Workers are the
packages' own ``_handle_conn`` served from threads in this process; where
the reference's expectation is a counter, both sides' ``sidecar.pool.*``
deltas (zeros dropped) are compared. Real port worker processes
(``--device cpu``, two for the module) carry a kill -9 failover and a
crash-and-corrupt storm."""

import os
import signal
import struct
import threading
import time

import numpy as np
import pytest

import torch_serve_sides as S
from torch_serve_sides import PORT, REF, SIDES

POOL = "sidecar.pool."


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for s in SIDES:
        S.clean(s)
    yield
    for s in SIDES:
        S.clean(s)


@pytest.fixture(scope="module", autouse=True)
def _no_slab_outlives_the_module():
    yield
    assert PORT.pool.open_slab_count() == 0, PORT.pool.arena_leak_report()


def both(case, *args, prefix=POOL, counted=True):
    """Run ``case(side, *args)`` on each package; the port's observation
    (and, with ``counted``, its counter deltas under ``prefix``) must equal
    the reference's."""
    seen = []
    for s in SIDES:
        c0 = S.counters(s, prefix)
        obs = case(s, *args)
        seen.append((obs, S.delta(c0, S.counters(s, prefix)) if counted else None))
    assert seen[1] == seen[0]
    return seen[0]


def _c(side, name):
    return side.metrics.registry().value(name)


def _want(side, payload=None):
    payload = S.groupby_payload() if payload is None else payload
    return payload, side.sidecar._dispatch(side.sidecar.OP_GROUPBY_SUM_F32, payload, "cpu")


# ---------------------------------------------------------------------------
# the slab allocator
# ---------------------------------------------------------------------------


def _slab_classes(side):
    slab = side.pool.ArenaSlab(1 << 16)
    regions = [slab.lease(100) for _ in range(8)]
    offs = sorted(r.offset for r in regions)
    pow2 = all(((r.capacity + 32) & (r.capacity + 31)) == 0 for r in regions)
    for r in regions:
        r.release()
    return offs, pow2, slab.close()


def _slab_coalesce(side):
    slab = side.pool.ArenaSlab(1 << 16)
    for r in [slab.lease(3000) for _ in range(4)]:
        r.release()
    big = slab.lease((1 << 16) - 32 - 32)
    cap = big.capacity
    big.release()
    return cap, slab.close()


def _slab_exhaustion(side):
    slab = side.pool.ArenaSlab(1 << 14)
    held, msg = [], None
    try:
        for _ in range(64):
            held.append(slab.lease(3000))
    except side.errors.RetryableError as e:
        msg = ("RESOURCE_EXHAUSTED" in str(e), side.retry.is_resource_exhausted(e))
    try:
        slab.lease(1 << 20)
    except side.errors.RetryableError as e:
        msg = msg + ("RESOURCE_EXHAUSTED" in str(e),)
    for r in held:
        r.release()
    return len(held), msg, slab.close()


def _slab_leak(side):
    slab = side.pool.ArenaSlab(1 << 14)
    slab.lease(100)
    return slab.close(), side.pool.arena_leak_report()


def _slab_header(side):
    slab = side.pool.ArenaSlab(1 << 14)
    r = slab.lease(64)
    r.write(b"payload!")
    hdr = side.sidecar.REGION_HDR.unpack_from(slab._mm, r.offset)
    out = (hdr == (side.sidecar.REGION_MAGIC, r.generation, r.request_id, r.capacity, 8),
           r.payload_bytes(), r.snapshot_bytes())
    r.release()
    return out, slab.close()


@pytest.mark.parametrize("case", [_slab_classes, _slab_coalesce, _slab_exhaustion, _slab_leak,
                                  _slab_header], ids=lambda f: f.__name__[1:])
def test_arena_slab_matches(case):
    both(case)


# ---------------------------------------------------------------------------
# routing, failover, respawn, re-hydration, the degrade
# ---------------------------------------------------------------------------


def _round_robin(side):
    pool = S.inproc_pool(side)
    try:
        payload, want = _want(side)
        with side.retry.enabled(max_attempts=4, base_delay_ms=1):
            ok = [pool.call(side.sidecar.OP_GROUPBY_SUM_F32, payload) == want for _ in range(4)]
        return ok, sorted(pool.worker_stats(fold=False))
    finally:
        pool.shutdown()


def _kill_one(side):
    pool = S.inproc_pool(side)
    try:
        payload, want = _want(side)
        opened0 = _c(side, "sidecar.breaker.opened_total")
        pool._workers[pool._rr % pool.size].proc.kill()
        with side.retry.enabled(max_attempts=6, base_delay_ms=1):
            ok = [pool.call(side.sidecar.OP_GROUPBY_SUM_F32, payload) == want for _ in range(4)]
        healthy = pool.wait_healthy(20)
        return ok, _c(side, "sidecar.breaker.opened_total") - opened0, healthy
    finally:
        pool.shutdown()


def _whole_pool_dark(side):
    pool = S.inproc_pool(side, deadline_s=5)
    try:
        payload, want = _want(side)
        host0 = _c(side, "sidecar.host_fallbacks")
        pool._respawn_max = 0
        for w in pool._workers:
            w.proc.kill()
        with side.retry.enabled(max_attempts=3, base_delay_ms=1):
            got = pool.call(side.sidecar.OP_GROUPBY_SUM_F32, payload)
        return got == want, _c(side, "sidecar.host_fallbacks") - host0
    finally:
        pool.shutdown()
        side.sidecar.breaker().reset()


def _rehydration(side):
    pool = S.inproc_pool(side)
    try:
        payload, want = _want(side)
        pool.set_arena(1 << 20)
        op = side.sidecar.OP_GROUPBY_SUM_F32
        with side.retry.enabled(max_attempts=6, base_delay_ms=1):
            ok = [pool.call_arena(op, payload) == want]
            pool._workers[pool._rr % pool.size].proc.kill()
            ok.append(pool.call_arena(op, payload) == want)
            healthy = pool.wait_healthy(20)
            ok += [pool.call_arena(op, payload) == want for _ in range(2)]
        return ok, healthy
    finally:
        pool.shutdown()


def _stream_after_slab(side):
    pool = S.inproc_pool(side)
    try:
        payload, want = _want(side)
        pool.ensure_slab()
        t0 = time.monotonic()
        with side.retry.enabled(max_attempts=4, base_delay_ms=1):
            ok = [pool.call(side.sidecar.OP_GROUPBY_SUM_F32, payload) == want for _ in range(3)]
        return ok, time.monotonic() - t0 < 5
    finally:
        pool.shutdown()


def _arena_survives_reconnect(side):
    pool = S.inproc_pool(side)
    try:
        payload, want = _want(side)
        pool.ensure_slab()
        op = side.sidecar.OP_GROUPBY_SUM_F32
        with side.retry.enabled(max_attempts=4, base_delay_ms=1):
            ok = [pool.call_arena(op, payload) == want]
            for w in pool._workers:
                w.client.close()
            ok.append(pool.call_arena(op, payload) == want)
        return ok, pool.live_count()
    finally:
        pool.shutdown()


def _oversized_write(side):
    pool = S.inproc_pool(side)
    try:
        region = pool.lease(64)
        try:
            region.write(b"x" * (region.capacity + 1))
        except side.errors.RetryableError as e:
            out = ("RESOURCE_EXHAUSTED" in str(e), str(region.capacity + 1) in str(e),
                   side.retry.is_resource_exhausted(e))
        finally:
            region.release()
        import mmap

        client = side.sidecar.SupervisedClient("/nonexistent.sock", deadline_s=1)
        client.arena_mm = mmap.mmap(-1, 4096)
        try:
            client._raw_request(side.sidecar.OP_PING, b"", arena_len=8192)
        except side.errors.RetryableError as e:
            out += ("RESOURCE_EXHAUSTED" in str(e),)
        finally:
            client.arena_mm.close()
        return out
    finally:
        pool.shutdown()


def _shutdown_joins_respawn(side):
    entered, release, spawned = threading.Event(), threading.Event(), []

    def spawn_fn(startup_timeout_s=None, env=None):
        if len(spawned) >= 2:
            entered.set()
            release.wait(20)
        w = S.InProcWorker(side)
        spawned.append(w)
        return w, w.sock_path

    pool = side.pool.SidecarPool(size=2, deadline_s=5, heartbeat_s=1e9, spawn_fn=spawn_fn)
    try:
        victim = pool._workers[0]
        victim.proc.kill()
        pool._on_worker_failure(victim, side.errors.RetryableError("Socket closed"))
        t = victim.respawn_thread
        reached = entered.wait(10)
        threading.Timer(0.2, release.set).start()
        pool.shutdown()
        return reached, t.is_alive(), len(spawned), spawned[-1].returncode is not None
    finally:
        release.set()
        pool.shutdown()


def _pool_size_knob(side, monkeypatch):
    sizes = []
    for v in (None, "3"):
        if v is None:
            monkeypatch.delenv(side.prefix + "SIDECAR_POOL_SIZE", raising=False)
        else:
            monkeypatch.setenv(side.prefix + "SIDECAR_POOL_SIZE", v)
        pool = side.pool.SidecarPool(spawn_fn=S.inproc_spawn(side))
        sizes.append(pool.size)
        pool.shutdown()
    return sizes


def _two_region_ops_overlap(side, monkeypatch):
    pool = S.inproc_pool(side, slab_bytes=1 << 20)
    try:
        payload, want = _want(side)
        barrier = threading.Barrier(2, timeout=10)
        real = side.sidecar._dispatch
        op = side.sidecar.OP_GROUPBY_SUM_F32

        def synced(o, pl, backend):
            if o == op:
                barrier.wait()
            return real(o, pl, backend)

        monkeypatch.setattr(side.sidecar, "_dispatch", synced)
        got, errs = [], []

        def one():
            try:
                with side.retry.enabled(max_attempts=4, base_delay_ms=1):
                    got.append(pool.call_arena(op, payload) == want)
            except Exception as e:  # surfaced below
                errs.append(repr(e))

        ts = [threading.Thread(target=one) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(20)
        monkeypatch.setattr(side.sidecar, "_dispatch", real)
        served = sorted(
            (s["snapshot"]["counters"] or {}).get("sidecar.worker.requests.GROUPBY_SUM_F32", 0) >= 1
            for s in pool.worker_stats(fold=False).values())
        return got, errs, barrier.broken, served
    finally:
        pool.shutdown()


def _stale_generation(side):
    pool = S.inproc_pool(side, size=1, slab_bytes=1 << 20)
    try:
        payload, want = _want(side)
        sc = side.sidecar
        region = pool.lease(len(payload))
        region.write(payload)
        mm = pool._slab._mm
        hdr = bytearray(mm[region.offset: region.offset + sc.REGION_HDR_LEN])
        hdr[4] ^= 0xFF
        mm[region.offset: region.offset + sc.REGION_HDR_LEN] = bytes(hdr)
        w = pool._workers[0]
        pool._ensure_arena(w)
        try:
            w.client.request(sc.OP_GROUPBY_SUM_F32, b"", region=region)
            desync = None
        except side.errors.RetryableError as e:
            desync = "region header desync" in str(e)
        with side.retry.enabled(max_attempts=4, base_delay_ms=1):
            healed = pool.call(sc.OP_GROUPBY_SUM_F32, region=region) == want
        region.release()
        return desync, healed
    finally:
        pool.shutdown()


@pytest.mark.parametrize("case", [_round_robin, _kill_one, _whole_pool_dark, _rehydration,
                                  _stream_after_slab, _arena_survives_reconnect, _oversized_write,
                                  _shutdown_joins_respawn, _stale_generation],
                         ids=lambda f: f.__name__[1:])
def test_pool_case_matches(case):
    both(case)


@pytest.mark.parametrize("case", [_pool_size_knob, _two_region_ops_overlap],
                         ids=lambda f: f.__name__[1:])
def test_pool_case_with_monkeypatch_matches(case, monkeypatch):
    both(case, monkeypatch)


# ---------------------------------------------------------------------------
# STATS aggregation and the stats sections
# ---------------------------------------------------------------------------


def _stats(side):
    pool = S.inproc_pool(side)
    try:
        payload, _ = _want(side)
        with side.retry.enabled(max_attempts=4, base_delay_ms=1):
            for _ in range(2):
                pool.call(side.sidecar.OP_GROUPBY_SUM_F32, payload)
        stats = pool.worker_stats(fold=True)
        gauges = side.metrics.snapshot()["gauges"]
        snap = pool.snapshot()
        return (sorted(stats), sorted({s["backend"] for s in stats.values()}),
                "sidecar.worker.w0.requests.GROUPBY_SUM_F32" in gauges,
                "sidecar.worker.w1.requests.GROUPBY_SUM_F32" in gauges,
                any("sidecar.worker.w0.sidecar.worker." in k for k in gauges),
                sorted(snap), sorted(snap["workers"]), snap["live"])
    finally:
        pool.shutdown()


def _runtime_sections(side):
    pool = side.pool.connect_pool(size=2, deadline_s=20, heartbeat_s=1e9,
                                  spawn_fn=S.inproc_spawn(side))
    try:
        stats = side.runtime.device_stats(fold=True)
        rep = side.runtime.stats_report()
        return (sorted(stats["pool_workers"]), sorted(rep), sorted(rep["pool"]),
                sorted(rep["health"]), sorted(rep["hedge"]), "crc_mismatch" in rep["integrity"])
    finally:
        side.pool.shutdown_pool()
        assert side.pool.current_pool() is None


@pytest.mark.parametrize("case", [_stats, _runtime_sections], ids=lambda f: f.__name__[1:])
def test_stats_match(case):
    both(case, counted=False)


# ---------------------------------------------------------------------------
# gray-failure quarantine
# ---------------------------------------------------------------------------


def _seed_hist(side, op, us=1000, n=40):
    side.metrics.reset()
    h = side.metrics.registry().histogram(f"sidecar.op_lat_us.{side.sidecar.op_name(op)}")
    for _ in range(n):
        h.record(us)


def _quarantine_and_reinstate(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "QUARANTINE_PROBE_INTERVAL_S", "1.0")
    monkeypatch.setenv(side.prefix + "QUARANTINE_STRIKES", "3")
    pool = S.inproc_pool(side, deadline_s=10)
    try:
        op = side.sidecar.OP_PING
        _seed_hist(side, op)
        w1 = pool._workers[1]
        for _ in range(3):
            pool._note_latency(w1, op, 0.1)
        gray = (w1.quarantined, pool.routable_count(), _c(side, "sidecar.pool.quarantines"),
                _c(side, "sidecar.pool.quarantined"),
                all(pool._pick() is pool._workers[0] for _ in range(8)),
                pool.wait_healthy(timeout_s=0.2))
        monkeypatch.setenv(side.prefix + "QUARANTINE_PROBE_INTERVAL_S", "0.05")
        back = (pool.wait_healthy(timeout_s=10.0), w1.quarantined, w1.strikes,
                _c(side, "sidecar.pool.reinstatements"),
                _c(side, "sidecar.pool.quarantine_probes") >= 3,
                sorted({pool._pick().wid for _ in range(4)}))
        return gray, back
    finally:
        pool.shutdown()


def _dirty_probes_hold(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "QUARANTINE_PROBE_INTERVAL_S", "0.05")
    monkeypatch.setenv(side.prefix + "QUARANTINE_STRIKES", "2")
    monkeypatch.setenv(side.prefix + "QUARANTINE_PROBE_SLOW_S", "0.000000001")
    pool = S.inproc_pool(side, deadline_s=10)
    try:
        op = side.sidecar.OP_PING
        _seed_hist(side, op)
        w1 = pool._workers[1]
        for _ in range(2):
            pool._note_latency(w1, op, 0.1)
        first = w1.quarantined
        time.sleep(0.6)
        held = (w1.quarantined, _c(side, "sidecar.pool.quarantine_probes") >= 2, w1.clean_probes)
        monkeypatch.setenv(side.prefix + "QUARANTINE_PROBE_SLOW_S", "0.25")
        return first, held, pool.wait_healthy(timeout_s=10.0)
    finally:
        pool.shutdown()


def _strikes_and_fallbacks(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "QUARANTINE_STRIKES", "2")
    monkeypatch.setenv(side.prefix + "QUARANTINE_PROBE_INTERVAL_S", "60")
    pool = S.inproc_pool(side, deadline_s=10)
    try:
        sc = side.sidecar
        side.metrics.reset()
        w0, w1 = pool._workers
        # a timeout strikes even on a cold op class
        pool._note_latency(w0, sc.OP_ZORDER, 10.0, timed_out=True)
        cold = [w0.quarantined]
        pool._note_latency(w0, sc.OP_ZORDER, 10.0, timed_out=True)
        cold.append(w0.quarantined)
        # clean samples pay strikes back
        monkeypatch.setenv(side.prefix + "QUARANTINE_STRIKES", "3")
        _seed_hist(side, sc.OP_PING)
        pool._note_latency(w1, sc.OP_PING, 0.1)
        pool._note_latency(w1, sc.OP_PING, 0.1)
        flap = [w1.strikes]
        pool._note_latency(w1, sc.OP_PING, 0.001)
        flap.append(w1.strikes)
        pool._note_latency(w1, sc.OP_PING, 0.1)
        flap.append(w1.quarantined)
        # every live worker gray: routing falls back (counted), calls answer
        with pool._lock:
            for w in pool._workers:
                if not w.quarantined:
                    pool._quarantine_locked(w, "test")
        fb0 = _c(side, "sidecar.pool.quarantine_fallbacks")
        gray = (pool.routable_count(), pool.live_count(), pool._pick() is not None,
                _c(side, "sidecar.pool.quarantine_fallbacks") - fb0,
                pool.call(sc.OP_PING))
        # gray -> dead: the respawned slot starts clean
        w1.proc.kill()
        pool._on_worker_failure(w1, side.errors.RetryableError("UNAVAILABLE"))
        dead = (w1.quarantined, pool.wait_healthy(timeout_s=0.1) is False)
        return cold, flap, gray, dead
    finally:
        pool.shutdown()


@pytest.mark.parametrize("case", [_quarantine_and_reinstate, _dirty_probes_hold,
                                  _strikes_and_fallbacks], ids=lambda f: f.__name__[1:])
def test_quarantine_matches(case, monkeypatch):
    both(case, monkeypatch, counted=False)


# ---------------------------------------------------------------------------
# hedged dispatch
# ---------------------------------------------------------------------------


def _drain(pool):
    t_end = time.monotonic() + 10
    while time.monotonic() < t_end and pool._slab is not None and pool._slab.outstanding:
        time.sleep(0.02)
    return 0 if pool._slab is None else pool._slab.outstanding


def _hedge_both_answer(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "HEDGE_BUDGET_PCT", "100")
    pool = S.inproc_pool(side)
    try:
        side.metrics.reset()
        payload, want = _want(side)
        side.faultinj.configure({"seed": 11, "faults": {"sidecar.worker.GROUPBY_SUM_F32": {
            "type": "delay", "percent": 100, "delayMs": 60}}})
        monkeypatch.setattr(pool, "_hedge_delay_s", lambda op, primary: 0.001)
        got = pool.call_arena(side.sidecar.OP_GROUPBY_SUM_F32, payload) == want
        return (got, _c(side, "sidecar.pool.hedges_launched"),
                _c(side, "sidecar.pool.hedges_cancelled"),
                _c(side, "sidecar.pool.hedges_won") in (0, 1), _drain(pool),
                _c(side, "sidecar.pool.region_leaks"))
    finally:
        side.faultinj.disable()
        pool.shutdown()


def _hedge_beats_a_straggler(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "HEDGE_BUDGET_PCT", "100")
    pool = S.inproc_pool(side)
    try:
        side.metrics.reset()
        payload, want = _want(side)
        side.faultinj.configure({"seed": 11, "faults": {"sidecar.worker.GROUPBY_SUM_F32": {
            "type": "delay", "percent": 100, "delayMs": 2000, "interceptionCount": 1}}})
        monkeypatch.setattr(pool, "_hedge_delay_s", lambda op, primary: 0.05)
        t0 = time.monotonic()
        got = pool.call_arena(side.sidecar.OP_GROUPBY_SUM_F32, payload) == want
        fast = time.monotonic() - t0 < 1.5
        return (got, fast, _c(side, "sidecar.pool.hedges_launched"),
                _c(side, "sidecar.pool.hedges_won"), _drain(pool))
    finally:
        side.faultinj.disable()
        pool.shutdown()


def _hedge_gates(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "HEDGE_BUDGET_PCT", "10")
    monkeypatch.setenv(side.prefix + "HEDGE_MIN_SAMPLES", "10")
    monkeypatch.setenv(side.prefix + "HEDGE_SHED_WINDOW_S", "5.0")
    pool = S.inproc_pool(side, deadline_s=10)
    try:
        sc = side.sidecar
        side.metrics.reset()
        reg = side.metrics.registry()
        reg.counter("sidecar.pool.calls").inc(100)
        reg.counter("sidecar.pool.hedges_launched").inc(9)
        budget = [pool._hedge_budget_ok()]
        reg.counter("sidecar.pool.hedges_launched").inc(1)
        budget.append(pool._hedge_budget_ok())
        side.metrics.reset()
        w0 = pool._workers[0]
        cold = pool._hedge_delay_s(sc.OP_ZORDER, w0)
        _seed_hist(side, sc.OP_PING, n=20)
        armed = pool._hedge_delay_s(sc.OP_PING, w0) is not None
        # memgov pressure disarms it, counted
        monkeypatch.setattr(side.memgov, "is_enabled", lambda: True)
        reg.gauge("memgov.queue_depth").set(1)
        sup0 = _c(side, "sidecar.pool.hedges_suppressed")
        pressured = (pool._hedge_delay_s(sc.OP_PING, w0),
                     _c(side, "sidecar.pool.hedges_suppressed") - sup0)
        launched0 = _c(side, "sidecar.pool.hedges_launched")
        pressured += (pool.call(sc.OP_PING), _c(side, "sidecar.pool.hedges_launched") - launched0)
        reg.gauge("memgov.queue_depth").set(0)
        monkeypatch.undo()
        monkeypatch.setenv(side.prefix + "HEDGE_MIN_SAMPLES", "10")
        monkeypatch.setenv(side.prefix + "HEDGE_SHED_WINDOW_S", "5.0")
        # a recent serve-layer shed disarms it; an old one does not
        reg.gauge("serve.last_shed_s").set(time.monotonic())
        shed = [pool._hedge_delay_s(sc.OP_PING, w0)]
        reg.gauge("serve.last_shed_s").set(time.monotonic() - 60.0)
        shed.append(pool._hedge_delay_s(sc.OP_PING, w0) is not None)
        return budget, cold, armed, pressured, shed
    finally:
        pool.shutdown()
        side.metrics.reset()


def _single_worker_never_hedges(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "HEDGE_MIN_SAMPLES", "10")
    pool = S.inproc_pool(side, size=1, deadline_s=10)
    try:
        _seed_hist(side, side.sidecar.OP_PING, n=20)
        return pool._hedge_delay_s(side.sidecar.OP_PING, pool._workers[0])
    finally:
        pool.shutdown()


@pytest.mark.parametrize("case", [_hedge_both_answer, _hedge_beats_a_straggler, _hedge_gates,
                                  _single_worker_never_hedges], ids=lambda f: f.__name__[1:])
def test_hedged_dispatch_matches(case, monkeypatch):
    both(case, monkeypatch, counted=False)


# ---------------------------------------------------------------------------
# quarantine-aware serving
# ---------------------------------------------------------------------------


def _serve_quarantine_routing(side, monkeypatch):
    monkeypatch.setenv(side.prefix + "QUARANTINE_PROBE_INTERVAL_S", "60")
    pool = side.pool.connect_pool(size=1, deadline_s=10, heartbeat_s=1e9,
                                  spawn_fn=S.inproc_spawn(side))
    sched = side.serve.Scheduler(max_concurrent=1, name="tail-test")
    try:
        with pool._lock:
            pool._quarantine_locked(pool._workers[0], "test")
        try:
            sched.submit(lambda: 1, tenant="t", host_eligible=False)
            shed = None
        except side.errors.Overloaded as e:
            shed = e.cause
        flows = sched.submit(lambda: 2, tenant="t", host_eligible=True).result(10)
        return shed, flows
    finally:
        sched.shutdown(drain=False, timeout_s=10)
        side.pool.shutdown_pool()


def test_serve_quarantine_routing_matches(monkeypatch):
    both(_serve_quarantine_routing, monkeypatch, prefix="serve.")


# ---------------------------------------------------------------------------
# real port workers: kill -9 mid-stream and a crash-and-corrupt storm
# ---------------------------------------------------------------------------


def _roundtrip(side, pool, payload, types):
    """CONVERT_TO_ROWS then CONVERT_FROM_ROWS through ``pool``."""
    resp = pool.call(side.sidecar.OP_CONVERT_TO_ROWS, payload)
    (nrows,) = struct.unpack_from("<Q", resp, 4)
    offs = resp[12: 12 + 4 * (nrows + 1)]
    (blen,) = struct.unpack_from("<Q", resp, 12 + 4 * (nrows + 1))
    blob = resp[20 + 4 * (nrows + 1): 20 + 4 * (nrows + 1) + blen]
    ids = np.asarray([t for t, _ in types], np.int32).tobytes()
    scales = np.asarray([s for _, s in types], np.int32).tobytes()
    req = (struct.pack("<I", len(types)) + ids + scales + struct.pack("<Q", nrows) + offs
           + struct.pack("<Q", blen) + blob)
    return resp, pool.call(side.sidecar.OP_CONVERT_FROM_ROWS, req)


class _Inline:
    """The reference's ``_dispatch`` behind a pool's ``call``: the oracle."""

    def call(self, op, payload):
        return REF.sidecar._dispatch(op, payload, "cpu")


def test_real_workers_kill9_failover_bit_identical():
    """Two real port workers (``--device cpu``): a kill -9 mid-stream is
    exactly one failover, no breaker trip and no host degrade, the victim
    is respawned, and every answer is the reference's bit for bit."""
    _, _, payload = S.requests(False)[0]  # to_rows_fixed, legacy form
    table = REF.sidecar._read_table(payload)
    types = [(int(c.dtype.id.value), int(c.dtype.scale)) for c in table.columns]
    want = _roundtrip(REF, _Inline(), payload, types)
    pool = PORT.pool.SidecarPool(size=2, deadline_s=60, heartbeat_s=1e9, startup_timeout_s=120,
                                 device="cpu")
    try:
        failovers0 = _c(PORT, "sidecar.pool.failovers")
        opened0 = _c(PORT, "sidecar.breaker.opened_total")
        host0 = _c(PORT, "sidecar.pool.host_fallbacks")
        with PORT.retry.enabled(max_attempts=6, base_delay_ms=1):
            warm = _roundtrip(PORT, pool, payload, types)
            victim = pool._workers[pool._rr % pool.size]
            os.kill(victim.proc.pid, signal.SIGKILL)
            cold = _roundtrip(PORT, pool, payload, types)
        assert warm == want and cold == want
        assert _c(PORT, "sidecar.pool.failovers") == failovers0 + 1
        assert _c(PORT, "sidecar.breaker.opened_total") == opened0
        assert _c(PORT, "sidecar.pool.host_fallbacks") == host0
        assert pool.wait_healthy(120), "the kill -9 victim was not respawned"
        assert [w.client.ping() for w in pool._workers] == ["cpu", "cpu"]
    finally:
        pool.shutdown()


def _corrupt_storm(side):
    """The ``corrupt`` half of the reference's crash-and-corrupt profile
    (ci/chaos_crash.json), in process: CONVERT_TO_ROWS answers are
    flipped under the CRC four times; the client catches each one and
    every answer lands exact."""
    pool = S.inproc_pool(side)
    try:
        _, _, tp = S.requests(False)[0]
        want = side.sidecar._dispatch(side.sidecar.OP_CONVERT_TO_ROWS, tp, "cpu")
        side.faultinj.configure({"seed": 20260803, "faults": {"sidecar.worker.CONVERT_TO_ROWS": {
            "type": "corrupt", "percent": 100, "interceptionCount": 4}}})
        with side.retry.enabled(max_attempts=8, base_delay_ms=1):
            ok = [pool.call(side.sidecar.OP_CONVERT_TO_ROWS, tp) == want for _ in range(4)]
        return ok
    finally:
        side.faultinj.disable()
        pool.shutdown()


def test_corrupt_storm_matches():
    both(_corrupt_storm, prefix="sidecar.integrity.")
