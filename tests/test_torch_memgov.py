"""Port: the memory governor (``spark_rapids_jni_tpu_torch/memgov``) held
against the JAX package's. Each case runs the reference's steps
(``tests/test_memgov.py``: admission, catalog, pressure, the op boundary,
the exchange's escalation and the squeeze) on both packages, every port
tensor on the CPU, and compares what they observed: results, tiers,
accounted bytes, spill-frame bytes and the ``memgov.*`` counter deltas
with zero-valued entries dropped."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from torch_memgov_sides import PORT, REF, SIDES, both, clean, counters, delta, setenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MEMGOV_CHAOS = os.path.join(REPO, "ci", "chaos_memgov.json")


@pytest.fixture(autouse=True)
def _clean_state():
    for s in SIDES:
        clean(s)
    yield
    for s in SIDES:
        clean(s)


def _new_pair(side, capacity, max_wait_s=0.2, **kw):
    cat = side.memgov.BufferCatalog()
    ctl = side.memgov.AdmissionController(
        capacity_fn=lambda: capacity, catalog=cat, max_wait_s=max_wait_s, **kw)
    return ctl, cat


def _raises(side, exc_name, fn):
    """The class name of what ``fn`` raised (``exc_name`` expected)."""
    with pytest.raises(Exception) as ei:
        fn()
    assert type(ei.value).__name__ == exc_name, (side.name, ei.value)
    return exc_name


# ---------------------------------------------------------------------------
# admission controller
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_byte_accounting_exact(self):
        def case(s):
            ctl, _ = _new_pair(s, 1000)
            seen = []
            a = ctl.acquire(600, "a")
            seen.append(ctl.in_use())
            b = ctl.acquire(400, "b")
            snap = ctl.snapshot()
            seen += [ctl.in_use(), snap["in_use_bytes"], snap["active"]]
            a.release()
            a.release()  # idempotent
            seen.append(ctl.in_use())
            b.release()
            seen += [ctl.in_use(), ctl.snapshot()["active"]]
            return seen

        assert both(case)[0] == [600, 1000, 1000, 2, 400, 0, 0]

    def test_hopeless_demand_rejects_immediately(self):
        def case(s):
            ctl, _ = _new_pair(s, 1000, max_wait_s=30.0)
            t0 = time.monotonic()
            _raises(s, "MemoryBudgetExceeded", lambda: ctl.acquire(1500, "too_big"))
            return time.monotonic() - t0 < 2.0

        assert both(case)[0] is True

    def test_sustained_overbudget_raises_retryable_and_max_concurrent(self):
        def case(s):
            ctl, _ = _new_pair(s, 1000, max_wait_s=0.15)
            hold = ctl.acquire(800, "holder")
            _raises(s, "MemoryBudgetExceeded", lambda: ctl.acquire(500, "waiter"))
            hold.release()
            ctl.acquire(500, "waiter").release()
            cap, _ = _new_pair(s, 10_000, max_wait_s=0.15, max_concurrent=1)
            a = cap.acquire(10, "a")
            _raises(s, "MemoryBudgetExceeded", lambda: cap.acquire(10, "b"))
            a.release()
            cap.acquire(10, "b").release()
            return ctl.in_use(), cap.in_use(), issubclass(
                s.memory.MemoryBudgetExceeded, s.errors.RetryableError)

        obs, d = both(case)
        assert obs == (0, 0, True)
        assert d["memgov.rejected"] == 2 and d["memgov.admitted"] == 4

    def test_fifo_head_blocks_smaller_latecomers(self):
        def case(s):
            ctl, _ = _new_pair(s, 100, max_wait_s=10.0)
            hold = ctl.acquire(80, "hold")
            done = []

            def worker(tag, nb):
                adm = ctl.acquire(nb, name=tag)
                done.append(tag)
                adm.release()

            big = threading.Thread(target=worker, args=("big", 60), daemon=True)
            big.start()
            for _ in range(400):
                if ctl.snapshot()["queue_depth"] == 1:
                    break
                time.sleep(0.005)
            small = threading.Thread(target=worker, args=("small", 15), daemon=True)
            small.start()
            for _ in range(400):
                if ctl.snapshot()["queue_depth"] == 2:
                    break
                time.sleep(0.005)
            time.sleep(0.1)
            blocked = list(done)  # 80 + 15 fits, and still waits behind big
            hold.release()
            big.join(timeout=5)
            small.join(timeout=5)
            return blocked, sorted(done), ctl.in_use()

        assert both(case)[0] == ([], ["big", "small"], 0)

    def test_queue_wait_histogram_and_deadlines(self):
        def case(s):
            ctl, _ = _new_pair(s, 100)
            h = s.metrics.registry().histogram("memgov.queue_wait_us")
            before = h.count
            ctl.acquire(50, "x").release()
            recorded = h.count - before
            slow, _ = _new_pair(s, 100, max_wait_s=30.0)
            hold = slow.acquire(100, "holder")
            t0 = time.monotonic()
            with s.deadline.scope(0.2):
                _raises(s, "DeadlineExceeded", lambda: slow.acquire(50, "waiter"))
            quick = time.monotonic() - t0 < 2.0
            with s.deadline.scope(0.01):
                time.sleep(0.03)  # the budget is gone before the acquire
                _raises(s, "DeadlineExceeded", lambda: slow.acquire(50, "late"))
            hold.release()
            return recorded, quick, slow.in_use()

        obs, d = both(case)
        assert obs == (1, True, 0)
        assert d["memgov.deadline_denied"] == 2


# ---------------------------------------------------------------------------
# spillable buffer catalog
# ---------------------------------------------------------------------------


def _adversarial(s):
    """NaNs, infinities and negative zero in f64, full-range u64, bools."""
    f = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-308, -1.5, 3.14], np.float64)
    u = np.array([0, 1, 2**63, 2**64 - 1, 12345], np.uint64)
    b = np.array([True, False, True], bool)
    return s.array(f), s.array(u), s.array(b)


def _mixed_table(s):
    """Fixed-width lanes with and without validity, FLOAT64 bits: the
    reference's storage on both sides."""
    rng = np.random.default_rng(0)
    return s.table([
        ("INT64", np.arange(100), np.arange(100) % 3 != 0),
        ("FLOAT64", rng.integers(0, 2**64, 100, np.uint64), None),
        ("INT32", rng.integers(-5, 5, 100).astype(np.int32), None),
        ("UINT32", rng.integers(0, 2**32, 100, np.uint64).astype(np.uint32),
         rng.random(100) < 0.5),
    ], ["k", "bits", "i", "u"])


class TestCatalog:
    def test_spill_rematerialize_bit_exact(self):
        def case(s):
            cat = s.memgov.BufferCatalog()
            val = _adversarial(s)
            want = s.tree_bytes(val)
            h = cat.register("adv", val)
            tiers = [h.tier]
            h.spill()
            tiers.append(h.tier)
            dev0 = cat.device_bytes()
            back = h.get()
            tiers.append(h.tier)
            return tiers, dev0, s.tree_bytes(back) == want, want

        obs, _ = both(case)
        assert obs[:3] == (["device", "host", "device"], 0, True)

    def test_disk_round_trip_frames_equal_the_references(self, tmp_path):
        def case(s):
            d = tmp_path / s.name
            cat = s.memgov.BufferCatalog(spill_dir=str(d))
            frames_seen = []
            out = []
            for key, val in (("adv", _adversarial(s)), ("tbl", _mixed_table(s))):
                want = s.tree_bytes(val)
                h = cat.register(key, val)
                h.spill(to_disk=True)
                files = os.listdir(d)
                with open(os.path.join(d, files[0]), "rb") as f:
                    frames_seen.append(f.read())
                out.append((h.tier, cat.disk_bytes() == h.nbytes, cat.host_bytes(),
                            files[0].endswith(".frm"), s.frames.is_frame(frames_seen[-1])))
                back = h.get()
                out.append((h.tier, s.tree_bytes(back) == want, os.listdir(d)))
                if key == "tbl":
                    out.append(list(back.names))
            return out, frames_seen

        obs, _ = both(case)
        assert obs[0][0] == ("disk", True, 0, True, True)
        assert obs[0][1] == ("device", True, [])
        assert obs[0][4] == ["k", "bits", "i", "u"]

    def test_legacy_spill_containers_still_load(self, tmp_path):
        import io

        def case(s):
            out = []
            for kind in ("envelope", "plain"):
                cat = s.memgov.BufferCatalog(spill_dir=str(tmp_path / s.name))
                val = _adversarial(s)
                want = s.tree_bytes(val)
                h = cat.register(f"legacy-{kind}", val)
                leaves = [np.frombuffer(b, dtype=dt) for b, dt in
                          zip(want, (np.float64, np.uint64, bool))]
                h.spill(to_disk=True)
                buf = io.BytesIO()
                np.savez(buf, **{f"a{i}": leaf for i, leaf in enumerate(leaves)})
                blob = buf.getvalue()
                with open(h._disk_path, "wb") as f:
                    if kind == "envelope":
                        f.write(b"SRJTSPL1")
                        f.write(s.integrity.pack_crc(s.integrity.checksum(blob)))
                        f.write(len(blob).to_bytes(8, "little"))
                    f.write(blob)
                out.append(s.tree_bytes(h.get()) == want)
            return out

        assert both(case)[0] == [True, True]

    def test_nested_columns_walk_like_the_reference(self, tmp_path):
        """STRING, LIST and STRUCT columns: the leaf order, the frame bytes
        and the rebuilt handles of a disk round trip."""
        from spark_rapids_jni_tpu.columnar import Column as RC, Table as RT, dtype as rdt
        from spark_rapids_jni_tpu_torch.columnar import Column as PC, Table as PT, dtype as pdt
        import jax.numpy as jnp

        offs = np.array([0, 2, 2, 5, 9], np.int32)
        chars = np.frombuffer(b"abcdefghi", np.uint8).copy()
        valid = np.array([True, False, True, True])
        ints = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9], np.int64)

        def build(s):
            if s is REF:
                C, T, d, a = RC, RT, rdt, jnp.asarray
            else:
                C, T, d, a = PC, PT, pdt, (lambda x: torch.from_numpy(np.array(x)))
            st = C(d.STRING, offsets=a(offs), chars=a(chars), validity=a(valid))
            lst = C(d.LIST, offsets=a(offs), child=C(d.INT64, data=a(ints)))
            sct = C(d.STRUCT, children=(C(d.INT64, data=a(ints[:4])), st),
                    child_names=("x", "s"), validity=a(valid))
            return T([st, lst, sct], ["s", "l", "st"])

        def case(s):
            cat = s.memgov.BufferCatalog(spill_dir=str(tmp_path / s.name))
            t = build(s)
            want = s.tree_bytes(t)
            h = cat.register("nested", t)
            h.spill(to_disk=True)
            with open(h._disk_path, "rb") as f:
                frame = f.read()
            back = h.get()
            return (h.nbytes, len(want), want, frame, s.tree_bytes(back) == want,
                    list(back.names), back.columns[2].child_names)

        obs, _ = both(case)
        assert obs[4] is True and obs[6] == ("x", "s")

    def test_pinned_lru_and_counters(self):
        def case(s):
            out = []
            cat = s.memgov.BufferCatalog()
            hot = cat.register("hot", s.zeros(100), pinned=True)
            out.append(cat.spill_until(10**9))
            _raises(s, "ValueError", hot.spill)
            hot.unpin()
            out += [cat.spill_until(1), hot.tier]
            lru = s.memgov.BufferCatalog()
            a = lru.register("a", s.zeros(100))
            b = lru.register("b", s.zeros(100))
            a.get()  # b is the LRU victim now
            out += [lru.spill_until(1), b.tier, a.tier]
            x = lru.register("x", s.zeros(500))
            x.spill()
            x.get()
            x.spill()
            out.append(x.spill_count)
            re = s.memgov.BufferCatalog()
            re.register("k", s.zeros(10))
            re.register("k", s.zeros(20))
            out += [re.snapshot()["entries"], re.device_bytes()]
            return out

        obs, d = both(case)
        assert obs == [0, 800, "host", 800, "host", "device", 2, 1, 160]
        assert d["memgov.spilled_bytes"] == 800 + 800 + 8000 and d["memgov.respilled"] == 1

    def test_host_budget_and_injected_spill_failure(self, tmp_path):
        def case(s):
            out = []
            cat = s.memgov.BufferCatalog(spill_dir=str(tmp_path / s.name), host_budget=1000)
            a = cat.register("a", s.zeros(100))
            b = cat.register("b", s.zeros(100))
            a.spill()
            out.append(a.tier)
            b.spill()  # the host tier would hold 1600 B: the LRU one demotes
            out += [b.tier, a.tier, cat.host_bytes(), s.tree_bytes(a.get()) == s.tree_bytes(
                s.zeros(100))]
            inj = s.memgov.BufferCatalog()
            h = inj.register("x", s.zeros(100))
            s.faultinj.configure(
                {"faults": {"memgov.spill": {"type": "spill_fail", "percent": 100}}})
            out += [inj.spill_until(1), h.tier]
            s.faultinj.disable()
            out += [inj.spill_until(1), h.tier]
            return out

        obs, d = both(case)
        assert obs == ["host", "host", "disk", 800, True, 0, "device", 800, "host"]
        assert d["memgov.spill_failures"] == 1

    def test_accounting_only_arena_entries(self):
        def case(s):
            cat = s.memgov.BufferCatalog()
            h = cat.register_host_bytes("sidecar.arena.c1", 1 << 20)
            snap = cat.snapshot()
            out = [cat.host_bytes(), snap["arenas"], snap["arena_bytes"]]
            _raises(s, "ValueError", h.get)
            out += [cat.spill_until(10**9), cat.unregister("sidecar.arena.c1"),
                    cat.host_bytes()]
            return out

        assert both(case)[0] == [1 << 20, 1, 1 << 20, 0, True, 0]

    def test_corrupt_frame_raises_and_retires_the_entry(self, tmp_path):
        """A flipped byte in a spilled frame raises the retryable
        DataCorruption on re-materialization and closes the entry."""
        def case(s):
            cat = s.memgov.BufferCatalog(spill_dir=str(tmp_path / s.name))
            h = cat.register("c", _mixed_table(s))
            h.spill(to_disk=True)
            with open(h._disk_path, "r+b") as f:
                f.seek(-3, os.SEEK_END)
                byte = f.read(1)
                f.seek(-3, os.SEEK_END)
                f.write(bytes([byte[0] ^ 0xFF]))
            name = _raises(s, "DataCorruption", h.get)
            return name, cat.lookup("c") is None, os.listdir(tmp_path / s.name)

        assert both(case)[0] == ("DataCorruption", True, [])

    def test_rematerializes_onto_the_registered_device(self):
        cat = PORT.memgov.BufferCatalog()
        t = _mixed_table(PORT)
        h = cat.register("t", (t, torch.arange(5, dtype=torch.int16)))
        h.spill()
        back, ar = h.get()
        assert ar.dtype == torch.int16 and ar.device.type == "cpu"
        assert [c.data.dtype for c in back.columns] == [c.data.dtype for c in t.columns]
        assert all(torch.equal(a.data, b.data) for a, b in zip(back.columns, t.columns))


# ---------------------------------------------------------------------------
# pressure loop + admission integration
# ---------------------------------------------------------------------------


class TestPressure:
    def test_acquire_spills_and_pinned_residents_bound(self):
        def case(s):
            ctl, cat = _new_pair(s, 1000)
            cold = cat.register("cold", s.zeros(100))
            adm = ctl.acquire(600, "hot")  # 800 + 600 > 1000: must spill
            out = [cold.tier]
            adm.release()
            ctl2, cat2 = _new_pair(s, 1000)
            cat2.register("pinned", s.zeros(100), pinned=True)
            _raises(s, "MemoryBudgetExceeded", lambda: ctl2.acquire(600, "hot"))
            ctl2.acquire(150, "small").release()
            return out

        obs, d = both(case)
        assert obs == ["host"] and d["memgov.spilled_bytes"] == 800

    def test_ensure_fits_grows_the_held_admission(self):
        def case(s):
            ctl, _ = _new_pair(s, 1000, max_wait_s=0.15)
            adm = ctl.acquire(100, "op")
            ctl.ensure_fits(600, "op.escalation", admission=adm)
            out = [ctl.in_use(), adm.nbytes]
            _raises(s, "MemoryBudgetExceeded", lambda: ctl.acquire(500, "rival"))
            adm.release()
            out.append(ctl.in_use())
            adm2 = ctl.acquire(100, "op2")
            _raises(s, "MemoryBudgetExceeded",
                    lambda: ctl.ensure_fits(2000, "op2.escalation", admission=adm2))
            out += [ctl.in_use(), adm2.nbytes]
            adm2.release()
            return out

        assert both(case)[0] == [600, 600, 0, 100, 100]

    def test_spill_dir_that_cannot_be_written(self, tmp_path):
        """Under a host budget, a disk tier that cannot be written degrades
        to an over-budget host tier (counted); a forced disk spill into it
        raises, as in the reference."""
        blocker = tmp_path / "not-a-dir"
        blocker.write_bytes(b"x")

        def case(s):
            cat = s.memgov.BufferCatalog(spill_dir=str(blocker / "spill"), host_budget=100)
            a = cat.register("a", s.zeros(100))
            out = [cat.spill_until(1), a.tier]
            b = cat.register("b", s.zeros(10))
            with pytest.raises(OSError):
                b.spill(to_disk=True)
            out.append(b.tier)
            return out

        obs, d = both(case)
        assert obs == [800, "host", "host"]
        assert d["memgov.spill_failures"] == 2

    def test_smcache_drop_finds_no_cache_in_the_port(self, monkeypatch):
        """The last-resort valve is armed, but the port has no compiled
        shard_map cache: nothing is dropped, and the hopeless request is
        refused as in the reference."""
        setenv(monkeypatch, PORT, "MEMGOV_DROP_SMCACHE", "1")
        ctl, _ = _new_pair(PORT, 1000)
        before = counters(PORT)
        with pytest.raises(PORT.memory.MemoryBudgetExceeded):
            ctl.acquire(5000, "too_big")
        d = delta(before, counters(PORT))
        assert d == {"memgov.pressure_events": 1, "memgov.rejected": 1}


# ---------------------------------------------------------------------------
# op_boundary integration
# ---------------------------------------------------------------------------


def _ops(s):
    ob = s.dispatch.op_boundary

    @ob("memgov_inner_op")
    def inner(t):
        return t

    @ob("memgov_outer_op")
    def outer(t):
        return inner(t)

    @ob("memgov_failing_op")
    def failing(t):
        raise ValueError("op body failed")

    return inner, outer, failing


def _int_table(s, n):
    return s.table([("INT64", np.arange(n), None)], ["x"])


class TestDispatch:
    def test_disarmed_governor_never_touches_admission(self, monkeypatch):
        def case(s):
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", 10)
            s.memgov.disable()
            inner, _, _ = _ops(s)
            inner(_int_table(s, 64))
            return s.memgov.is_enabled()

        obs, d = both(case)
        assert obs is False and d == {}

    def test_outermost_boundary_owns_the_admission(self, monkeypatch):
        def case(s):
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", 100000)
            _, outer, failing = _ops(s)
            with s.memgov.enabled():
                outer(_int_table(s, 64))
                in_use = s.memgov.controller().in_use()
                _raises(s, "ValueError", lambda: failing(_int_table(s, 16), memory_bytes=500))
            return in_use, s.memgov.controller().in_use()

        obs, d = both(case)
        assert obs == (0, 0) and d["memgov.admitted"] == 2

    def test_memory_bytes_overrides_the_estimate(self, monkeypatch):
        def case(s):
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", 1000)
            inner, _, _ = _ops(s)
            t = _int_table(s, 10_000)
            with s.memgov.enabled():
                _raises(s, "MemoryBudgetExceeded", lambda: inner(t))
                inner(t, memory_bytes=100)
            return (s.memgov.controller().in_use(),
                    s.memgov.estimate_call_bytes((t,), {"k": t}))

        assert both(case)[0] == (0, 320_000)

    def test_admission_denial_engages_retry_split(self, monkeypatch):
        def case(s):
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", 4000)
            calls = []

            @s.dispatch.op_boundary("memgov_split_op")
            def proc(t):
                calls.append(t.num_rows)
                return t

            def run(t):
                return proc(t, memory_bytes=t.num_rows * 1000)

            pol = s.retry.RetryPolicy(max_attempts=1, split_depth=4)
            with s.memgov.enabled():
                out = s.retry.retry_with_split(run, _int_table(s, 16), op_name="memgov_split",
                                               policy=pol)
            return (out.num_rows, s.host(out.column("x")).tolist(), calls,
                    s.retry.stats()["splits"])

        obs, _ = both(case)
        assert obs[1] == list(range(16)) and max(obs[2]) <= 4 and obs[3] >= 2


# ---------------------------------------------------------------------------
# pipeline build tables ride the catalog
# ---------------------------------------------------------------------------


def test_pipeline_registered_build_spills_and_rematerializes(tmp_path):
    from spark_rapids_jni_tpu import pipeline as rpipe
    from spark_rapids_jni_tpu_torch import pipeline as ppipe

    def case(s):
        mod = rpipe if s is REF else ppipe
        n = 64
        fact = s.table([("INT64", np.arange(n) % 8, None),
                        ("FLOAT64", np.arange(n, dtype=np.float64).view(np.uint64), None)],
                       ["k", "v"])
        build = s.table([("INT64", np.arange(8), None), ("INT64", np.arange(8) * 10, None)],
                        ["bk", "payload"])
        plan = mod.PlanSpec(
            joins=(mod.JoinSpec(build="dim", probe_key="k", build_key="bk", num_keys=8,
                                payload=("payload",)),),
            aggregates=(mod.Agg("payload", "sum"),))
        pipe = mod.compile_plan(plan)
        want = s.host(pipe(fact, {"dim": build}).column("payload_sum")).tobytes()
        pipe.register_build("dim", build)
        got = [s.host(pipe(fact).column("payload_sum")).tobytes()]
        handle = pipe._build_handles["dim"]
        handle.spill()
        tiers = [handle.tier]
        got.append(s.host(pipe(fact).column("payload_sum")).tobytes())
        tiers.append(handle.tier)
        s.memgov.catalog()._spill_dir = str(tmp_path / s.name)
        handle.spill(to_disk=True)
        tiers.append(handle.tier)
        got.append(s.host(pipe(fact).column("payload_sum")).tobytes())
        pipe.unregister_builds()
        return want, got == [want] * 3, tiers, s.memgov.catalog().snapshot()["entries"]

    obs, d = both(case)
    assert obs[1:] == (True, ["host", "device", "disk"], 0)


# ---------------------------------------------------------------------------
# the exchange's capacity escalation routes through the governor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshes():
    from spark_rapids_jni_tpu.parallel import mesh as jmesh
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh

    return {REF.name: jmesh.make_mesh({"data": 8}),
            PORT.name: pmesh.make_mesh({"data": 8}, devices=[torch.device("cpu")] * 8)}


def _shard(s, t, mesh):
    if s is REF:
        from spark_rapids_jni_tpu.parallel import mesh as jmesh

        return jmesh.shard_table_rows(t, mesh)
    return t


class TestShuffleEscalation:
    def test_escalation_that_cannot_fit_raises_retryable(self, meshes, monkeypatch):
        def case(s):
            from spark_rapids_jni_tpu.parallel import shuffle as rsh
            from spark_rapids_jni_tpu_torch.parallel import shuffle as psh

            sh = rsh if s is REF else psh
            n = 512
            t = _shard(s, s.table([("INT64", np.zeros(n, np.int64), None),
                                   ("INT64", np.arange(n), None)], ["k", "v"]),
                       meshes[s.name])
            setenv(monkeypatch, s, "MEMGOV_HEADROOM", "1.0")
            ceiling = s.memory.exchange_bytes_estimate(17, 8, n // 8)
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", ceiling - 400)
            with s.memgov.enabled():
                name = _raises(s, "MemoryBudgetExceeded", lambda: sh.exchange_by_key(
                    t, ["k"], meshes[s.name], capacity=1, on_overflow="retry"))
            return name, s.memgov.controller().in_use()

        obs, d = both(case)
        assert obs == ("MemoryBudgetExceeded", 0) and d["memgov.rejected"] == 1

    def test_escalation_admitted_under_ample_budget(self, meshes, monkeypatch):
        def case(s):
            from spark_rapids_jni_tpu.parallel import shuffle as rsh
            from spark_rapids_jni_tpu_torch.parallel import shuffle as psh

            sh = rsh if s is REF else psh
            n = 512
            t = _shard(s, s.table([("INT64", np.arange(n) % 8, None),
                                   ("INT64", np.arange(n), None)], ["k", "v"]),
                       meshes[s.name])
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", 64 << 20)
            before = s.retry.stats()["capacity_retries"]
            with s.memgov.enabled():
                pairs, mask, overflow = sh.exchange_by_key(
                    t, ["k"], meshes[s.name], capacity=2, on_overflow="retry")
            m = np.asarray(mask).reshape(-1).astype(bool)
            got = np.sort(np.asarray(pairs[1][0]).reshape(-1)[m])
            return (bool(np.asarray(overflow).any()),
                    s.retry.stats()["capacity_retries"] - before, got.tolist())

        obs, _ = both(case)
        assert obs[0] is False and obs[1] > 0 and obs[2] == list(range(512))


# ---------------------------------------------------------------------------
# squeeze: spills and splits interleave, results exact
# ---------------------------------------------------------------------------


class TestSqueeze:
    def test_groupby_squeeze_spills_and_splits_interleave(self, meshes, monkeypatch):
        def case(s):
            if s is REF:
                from spark_rapids_jni_tpu.parallel.table_ops import distributed_groupby_table
            else:
                from spark_rapids_jni_tpu_torch.parallel.table_ops import (
                    distributed_groupby_table)
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", 300000)
            rng = np.random.default_rng(3)
            n = 4096
            keys = np.where(rng.integers(0, 10, n) < 9, 0, rng.integers(0, 50, n))
            vals = rng.integers(0, 100, n)
            t = s.table([("INT64", keys, None), ("INT64", vals, None)], ["k", "v"])
            decoys = [s.memgov.catalog().register(f"decoy{i}", s.zeros(15_000))
                      for i in range(2)]
            s.faultinj.configure_from_file(_MEMGOV_CHAOS)
            splits0 = s.memory.split_retry_count()
            with s.memgov.enabled(), s.retry.enabled(max_attempts=10, base_delay_ms=1,
                                                     max_delay_ms=8, seed=99):
                out, ovf = distributed_groupby_table(
                    t, ["k"], [("v", "sum", "v_sum"), ("v", "mean", "v_mean")],
                    meshes[s.name])
            got = dict(zip(out.column("k").to_pylist(), out.column("v_sum").to_pylist()))
            return (bool(ovf), s.memory.split_retry_count() > splits0,
                    [d.tier for d in decoys], got)

        obs, d = both(case)
        assert obs[0] is False and obs[1] is True and "host" in obs[2]
        assert d["memgov.spilled_bytes"] > 0

    def test_q1_bit_identical_under_squeeze(self, monkeypatch):
        from spark_rapids_jni_tpu.models import tpch as rtpch
        from spark_rapids_jni_tpu_torch.models import tpch as ptpch

        def case(s):
            mod = rtpch if s is REF else ptpch
            lineitem = (mod.gen_lineitem(1000, seed=7) if s is REF
                        else mod.gen_lineitem(1000, seed=7, device="cpu"))
            want = [s.host(c).tobytes() for c in mod.q1(lineitem).columns]
            est = s.memgov.estimate_call_bytes((lineitem,), {})
            setenv(monkeypatch, s, "DEVICE_MEMORY_BUDGET", int(est * 1.2))
            decoy = s.memgov.catalog().register("cold_cache", s.zeros(max(est // 16, 1024)))
            with s.memgov.enabled():
                got = [s.host(c).tobytes() for c in mod.q1(lineitem).columns]
            return est, got == want, decoy.tier, want

        obs, d = both(case)
        assert obs[1] is True and obs[2] == "host" and d["memgov.spilled_bytes"] > 0
