"""Port: ``parallel/cluster.ClusterView`` and the exchange's generation
fence held against the JAX package's. Each case runs the reference's
steps on both packages (every port tensor on the CPU) and compares what
they observed: states, generations, counter deltas, the partitions that
recovery rebuilds and the rows each rank receives. The heavy cases
(world-4 plans, in-process failover, the four-process chaos run) are
marked slow as the reference's are."""

import os
import socket
import threading
import time

import numpy as np
import pytest

from torch_exchange_sides import (PORT, REF, SIDES, counter, demo, dense, exchange_world,
                                  groupby_matches_single_host, run_ranks, same_dense, shard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEAD_ADDR = "127.0.0.1:9"  # the discard port: connects are refused
COUNTERS = ("cluster.deaths", "cluster.transitions", "cluster.recoveries",
            "cluster.stale_generation_refused", "cluster.stale_generation_rejects")


@pytest.fixture(autouse=True)
def _clean_state():
    for s in SIDES:
        s.faultinj.disable()
        s.retry.disable()
        s.retry.reset_stats()
    yield
    for s in SIDES:
        s.faultinj.disable()
        s.retry.disable()
        s.retry.reset_stats()
        s.shuffle.exchange_breaker().reset()


def both(case):
    """Run ``case(side)`` on the reference and on the port, and hold the
    port's observations (and its counter deltas) to the reference's."""
    seen = []
    for s in SIDES:
        c0 = {n: counter(s, n) for n in COUNTERS}
        obs = case(s)
        seen.append((obs, {n: counter(s, n) - c0[n] for n in COUNTERS}))
    assert seen[1] == seen[0]
    return seen[0]


def _probe_err(side):
    return side.errors.RetryableError("probe: connection refused")


def _view(side, ex, addrs=None, **kw):
    addrs = {0: ex.address, 1: DEAD_ADDR} if addrs is None else addrs
    return side.cluster.ClusterView(0, addrs, ex, **kw)


# ---------------------------------------------------------------------------
# membership and liveness
# ---------------------------------------------------------------------------


class TestMembership:
    def test_ctor_validation(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                with pytest.raises(ValueError, match="must include this rank"):
                    s.cluster.ClusterView(7, {0: ex.address, 1: DEAD_ADDR}, ex)
                with pytest.raises(ValueError, match="DEAD_MISSES"):
                    _view(s, ex, suspect_misses=4, dead_misses=2)
            return None

        both(case)

    def test_miss_ladder_and_generation_fencing(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                view = _view(s, ex, suspect_misses=2, dead_misses=4)
                steps = [(view.state(1), view.generation(), ex.generation())]
                for _ in range(4):
                    view._record_miss(1, _probe_err(s))
                    steps.append((view.state(1), view.generation(), ex.generation()))
                assert steps[-1] == (s.cluster.DEAD, 2, 2) and steps[2][0] == s.cluster.SUSPECT
                return steps, view.dead_ranks(), view.alive_ranks(), view.has_quorum()

        obs, deltas = both(case)
        assert deltas["cluster.deaths"] == 1 and deltas["cluster.transitions"] == 2

    def test_suspect_heals_to_alive_on_hit(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                view = _view(s, ex, suspect_misses=2, dead_misses=4)
                view._record_miss(1, _probe_err(s))
                view._record_miss(1, _probe_err(s))
                states = [view.state(1)]
                view._record_hit(1, peer_gen=1)
                states.append(view.state(1))
                view._record_miss(1, _probe_err(s))  # the hit reset the count
                states.append(view.state(1))
                assert states == [s.cluster.SUSPECT, s.cluster.ALIVE, s.cluster.ALIVE]
                return states, view.generation()

        obs, deltas = both(case)
        assert deltas["cluster.transitions"] == 2

    def test_wire_generation_adoption(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                view = _view(s, ex)
                view._record_hit(1, peer_gen=5)
                first = (view.generation(), ex.generation())
                view._record_hit(1, peer_gen=3)  # never backwards
                assert first == (5, 5) and view.generation() == 5
                return first, view.generation()

        both(case)

    def test_mark_dead_idempotent_and_await_dead(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                view = _view(s, ex)
                early = view.await_dead(1, 0.05)
                t = threading.Timer(0.2, view.mark_dead, args=(1,))
                t.start()
                woke = view.await_dead(1, 10.0)
                t.join(5)
                again = view.await_dead(1, 0.0)
                view.mark_dead(1)  # DEAD is terminal
                assert (early, woke, again) == (False, True, True)
                return early, woke, again, view.generation()

        obs, deltas = both(case)
        assert deltas["cluster.deaths"] == 1

    def test_quorum_fraction(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                addrs = {0: ex.address, 1: DEAD_ADDR, 2: DEAD_ADDR, 3: DEAD_ADDR}
                view = _view(s, ex, addrs, quorum_fraction=0.5)
                q = [view.has_quorum()]
                view.mark_dead(1)
                q.append(view.has_quorum())
                view.mark_dead(2)
                q.append(view.has_quorum())
                assert q == [True, True, False] and view.generation() == 3
                return q, view.generation(), view.alive_ranks()

        both(case)

    def test_heartbeat_detects_death_and_views_converge(self):
        def case(s):
            exs = [s.shuffle.TcpExchange(r, **s.kw) for r in range(3)]
            addrs = {r: ex.address for r, ex in enumerate(exs)}
            kw = dict(heartbeat_s=0.05, heartbeat_timeout_s=0.25, suspect_misses=1,
                      dead_misses=2)
            views = [s.cluster.ClusterView(r, addrs, exs[r], **kw) for r in (0, 1)]
            try:
                for v in views:
                    v.start()
                exs[2].close()
                t_end = time.monotonic() + 15.0
                while time.monotonic() < t_end:
                    if all(v.state(2) == s.cluster.DEAD for v in views):
                        break
                    time.sleep(0.02)
                return ([v.state(2) for v in views], [v.generation() for v in views],
                        [ex.generation() for ex in exs[:2]], views[0].state(1),
                        views[1].state(0), views[0].snapshot()["states"])
            finally:
                for v in views:
                    v.stop()
                for ex in exs:
                    ex.close()

        obs, deltas = both(case)
        assert obs[0] == ["dead", "dead"] and obs[1] == [2, 2] and obs[2] == [2, 2]
        assert obs[5] == {1: "alive", 2: "dead"}
        assert deltas["cluster.deaths"] == 2  # one death, seen by two views


# ---------------------------------------------------------------------------
# the generation fence and the classification of wire failures
# ---------------------------------------------------------------------------


class TestFencing:
    def test_ping_returns_generation(self):
        def case(s):
            ex0, ex1 = s.shuffle.TcpExchange(0, **s.kw), s.shuffle.TcpExchange(1, **s.kw)
            try:
                gens = [ex0.ping(ex1.address, 2.0)]
                ex1.set_generation(7)
                gens.append(ex0.ping(ex1.address, 2.0))
                ex1.close()
                # a connect racing the close may still be served
                for _ in range(50):
                    try:
                        ex0.ping(ex1.address, 0.5)
                    except (s.errors.RetryableError, OSError):
                        break
                    time.sleep(0.05)
                else:
                    pytest.fail("ping never failed after the peer closed")
                assert gens == [0, 7]
                return gens
            finally:
                ex0.close()
                ex1.close()

        both(case)

    def test_stale_generation_rejected_both_sides_then_heals(self):
        def case(s):
            ex0, ex1 = s.shuffle.TcpExchange(0, **s.kw), s.shuffle.TcpExchange(1, **s.kw)
            try:
                ex1.publish(3, {0: s.int64_table([np.arange(64, dtype=np.int64)], ["x"])})
                ex1.set_generation(2)
                ex0.set_generation(1)
                with pytest.raises(s.errors.RetryableError, match="DESYNC"):
                    ex0._fetch_once(ex1.address, 3, 0)
                ex0.set_generation(2)
                healed = s.host(ex0._fetch_once(ex1.address, 3, 0).columns[0])
                ex0.set_generation(None)  # an unfenced client sends the plain GET
                plain = ex0._fetch_once(ex1.address, 3, 0).num_rows
                assert np.array_equal(healed, np.arange(64)) and plain == 64
                return healed.tolist(), plain
            finally:
                ex0.close()
                ex1.close()

        obs, deltas = both(case)
        assert deltas["cluster.stale_generation_refused"] == 1
        assert deltas["cluster.stale_generation_rejects"] == 1

    def test_reset_mid_frame_is_unavailable_not_corruption(self):
        def case(s):
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            addr = f"127.0.0.1:{srv.getsockname()[1]}"

            def serve_half_frame():
                conn, _ = srv.accept()
                conn.recv(s.shuffle._EXC_REQ.size)
                # an OK header promising 4096 payload bytes, then gone
                conn.sendall(s.shuffle._EXC_RESP.pack(s.shuffle._EXC_OK, 4096))
                conn.close()

            t = threading.Thread(target=serve_half_frame, daemon=True)
            t.start()
            ex0 = s.shuffle.TcpExchange(0, **s.kw)
            try:
                with pytest.raises(s.errors.RetryableError) as ei:
                    ex0._fetch_once(addr, 0, 0)
                msg = str(ei.value)
                assert not isinstance(ei.value, s.errors.DataCorruption)
                assert "UNAVAILABLE" in msg and "reset" in msg and "payload" in msg
                return type(ei.value).__name__
            finally:
                ex0.close()
                srv.close()
                t.join(5)

        both(case)

    def test_netsplit_rank_tag_scopes_to_tagged_rank(self, monkeypatch):
        def case(s):
            cfg = {"faults": {"exchange.connect@r1": {"type": "netsplit", "percent": 100}}}
            monkeypatch.setenv(s.prefix + "FAULTINJ_RANK", "r1")
            s.faultinj.configure(cfg)
            with pytest.raises(ConnectionRefusedError):
                s.faultinj.maybe_inject("exchange.connect")
            ex0, ex1 = s.shuffle.TcpExchange(0, **s.kw), s.shuffle.TcpExchange(1, **s.kw)
            try:
                ex1.publish(0, {0: s.int64_table([np.arange(64, dtype=np.int64)], ["x"])})
                with pytest.raises(s.errors.RetryableError, match="UNAVAILABLE"):
                    ex0._fetch_once(ex1.address, 0, 0)
                monkeypatch.setenv(s.prefix + "FAULTINJ_RANK", "r2")  # a foreign tag
                s.faultinj.configure(cfg)
                s.faultinj.maybe_inject("exchange.connect")
                return ex0._fetch_once(ex1.address, 0, 0).num_rows
            finally:
                ex0.close()
                ex1.close()
                s.faultinj.disable()

        assert both(case)[0] == 64

    def test_per_peer_breaker_isolation(self):
        def case(s):
            br = s.shuffle.exchange_breaker(DEAD_ADDR)
            br.configure(threshold=1, cooldown_s=60.0)
            br.record_failure(cause="unavailable")
            assert not br.allow()
            ex0, ex1 = s.shuffle.TcpExchange(0, **s.kw), s.shuffle.TcpExchange(1, **s.kw)
            try:
                with pytest.raises(s.errors.RetryableError, match="breaker open"):
                    ex0.fetch(DEAD_ADDR, 0, 0)
                ex1.publish(0, {0: s.int64_table([np.arange(64, dtype=np.int64)], ["x"])})
                rows = ex0.fetch(ex1.address, 0, 0).num_rows  # a live peer flows
                snap = s.shuffle.exchange_breaker().snapshot()
                assert len(snap) >= 2 and s.shuffle.exchange_breaker(DEAD_ADDR) is br
                return rows, snap[DEAD_ADDR]["state"], snap[ex1.address]["state"]
            finally:
                ex0.close()
                ex1.close()

        both(case)


# ---------------------------------------------------------------------------
# lineage recovery
# ---------------------------------------------------------------------------


def _expected_partition(s, src, world, dest):
    partitioned, offsets = s.shuffle.hash_partition(src, world, ["k"])
    bounds = list(offsets) + [partitioned.num_rows]
    return s.copying.slice_table(partitioned, bounds[dest], bounds[dest + 1])


class TestRecovery:
    ROWS = 900
    SEED = 3

    def _view3(self, s, ex, **kw):
        full = demo(s, self.ROWS, self.SEED)
        addrs = {0: ex.address, 1: DEAD_ADDR, 2: DEAD_ADDR}
        kw.setdefault("heartbeat_s", 0.02)
        kw.setdefault("heartbeat_timeout_s", 0.05)
        kw.setdefault("suspect_misses", 1)
        kw.setdefault("dead_misses", 1)
        view = s.cluster.ClusterView(
            0, addrs, ex, lineage=lambda r: shard(s, full, self.ROWS, 3, r), **kw)
        return full, view

    def test_failover_requires_confirmed_death_and_lineage(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                full, view = self._view3(s, ex)
                assert view.failover_fetch(1, 0, ["k"], 3, 0) is None  # not dead
                view.mark_dead(1)
                no_lineage = s.cluster.ClusterView(
                    0, {0: ex.address, 1: DEAD_ADDR}, ex, heartbeat_s=0.02,
                    heartbeat_timeout_s=0.05, suspect_misses=1, dead_misses=1)
                no_lineage.mark_dead(1)
                assert no_lineage.failover_fetch(1, 0, ["k"], 2, 0) is None
                with pytest.raises(s.errors.FatalDeviceError, match="no lineage"):
                    no_lineage.recover_partition(1, 0, ["k"], 2, 0)
                got = view.failover_fetch(1, 0, ["k"], 3, 0)
                want = _expected_partition(s, shard(s, full, self.ROWS, 3, 1), 3, 0)
                same_dense(dense(s, got), dense(s, want))
                return dense(s, got)

        obs = []
        for s in SIDES:
            obs.append(case(s))
        same_dense(obs[1], obs[0])

    def test_recover_partition_republishes_idempotently(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                full, view = self._view3(s, ex)
                view.mark_dead(1)
                got = view.recover_partition(1, 0, ["k"], 3, 2)
                want = _expected_partition(s, shard(s, full, self.ROWS, 3, 1), 3, 2)
                same_dense(dense(s, got), dense(s, want))
                recovery_epoch = 2 * s.shuffle._RECOVERY_EPOCH_STRIDE
                with ex._published:
                    keys = sorted(k for k in ex._frames if k[0] == recovery_epoch)
                again = view.recover_partition(1, 0, ["k"], 3, 2)
                same_dense(dense(s, again), dense(s, want))
                assert keys == [(recovery_epoch, 0), (recovery_epoch, 2)]
                d = dense(s, got)
                return keys, {n: v[0].tolist() for n, v in d.items()}

        obs, deltas = both(case)
        assert deltas["cluster.recoveries"] == 1

    def test_recompute_dead_partition_matches_direct(self):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                full, view = self._view3(s, ex)
                view.mark_dead(1)
                got = view.recompute_dead_partition(1, ["k"], 3)
                same_dense(dense(s, got), dense(s, _expected_partition(s, full, 3, 1)))
                return {n: v[0].tolist() for n, v in dense(s, got).items()}

        both(case)

    @pytest.mark.slow
    def test_exchange_failover_bit_identical_in_process(self):
        """World 3 with rank 1 dead from the start: both survivors' pulls
        spend their retries, meet the detector and fail over to the lineage
        copy; with the dead rank's share rebuilt, the group-by is the
        single-host one, on both packages alike."""
        rows, seed, world = 1200, 5, 3

        def case(s):
            full = demo(s, rows, seed)
            ex0, ex2 = s.shuffle.TcpExchange(0, **s.kw), s.shuffle.TcpExchange(2, **s.kw)
            addrs = {0: ex0.address, 1: DEAD_ADDR, 2: ex2.address}
            kw = dict(lineage=lambda r: shard(s, full, rows, world, r), heartbeat_s=0.05,
                      heartbeat_timeout_s=0.2, suspect_misses=1, dead_misses=2)
            views = {0: s.cluster.ClusterView(0, addrs, ex0, **kw),
                     2: s.cluster.ClusterView(2, addrs, ex2, **kw)}
            exs = {0: ex0, 2: ex2}

            def run_rank(rank):
                peers = {r: a for r, a in addrs.items() if r != rank}
                local = exs[rank].exchange_table(shard(s, full, rows, world, rank), ["k"], peers,
                                                 epoch=0, cluster=views[rank])
                return s.shuffle._local_groupby_sum(local)

            try:
                for v in views.values():
                    v.start()
                with s.retry.enabled(max_attempts=20, base_delay_ms=5, max_delay_ms=50):
                    res = run_ranks({r: (lambda r=r: run_rank(r)) for r in (0, 2)})
                res[1] = s.shuffle._local_groupby_sum(views[0].recompute_dead_partition(
                    1, ["k"], world))
                groupby_matches_single_host(s, res, full)
                return ([v.dead_ranks() for v in views.values()],
                        [v.generation() for v in views.values()],
                        {r: dense(s, t)["s"][0].tolist() for r, t in res.items()})
            finally:
                for v in views.values():
                    v.stop()
                ex0.close()
                ex2.close()

        seen = []
        for s in SIDES:
            recov0 = counter(s, "cluster.recoveries")
            seen.append(case(s))
            assert counter(s, "cluster.recoveries") >= recov0 + 1
        assert seen[1] == seen[0]
        assert seen[0][0] == [[1], [1]] and seen[0][1] == [2, 2]


# ---------------------------------------------------------------------------
# the N-rank plans
# ---------------------------------------------------------------------------


class TestTopology:
    def test_topology_validation(self, monkeypatch):
        def case(s):
            with s.shuffle.TcpExchange(0, **s.kw) as ex:
                t = demo(s, 64, 1)
                with pytest.raises(ValueError, match="must cover ranks"):
                    ex.exchange_table(t, ["k"], {5: DEAD_ADDR})
                with pytest.raises(ValueError, match="power-of-two"):
                    ex.exchange_table(t, ["k"], {1: "x", 2: "y"}, topology="tree")
                with pytest.raises(ValueError, match="unknown exchange topology"):
                    ex.exchange_table(t, ["k"], {1: "x"}, topology="ring")
                monkeypatch.setenv(s.prefix + "CLUSTER_TOPOLOGY", "tree")
                with pytest.raises(ValueError, match="power-of-two"):
                    ex.exchange_table(t, ["k"], {1: "x", 2: "y"})
                monkeypatch.delenv(s.prefix + "CLUSTER_TOPOLOGY")
            return None

        both(case)

    def test_cluster_pins_all_to_all_over_tree(self):
        """An attached cluster pins the direct plan even when tree is asked:
        frames land under the real epoch, each rank receives the
        reference's rows in the reference's order."""
        rows, seed = 400, 9

        def case(s):
            full = demo(s, rows, seed)
            exs = [s.shuffle.TcpExchange(r, **s.kw) for r in (0, 1)]
            addrs = {r: ex.address for r, ex in enumerate(exs)}
            views = [s.cluster.ClusterView(r, addrs, exs[r]) for r in (0, 1)]

            def run_rank(rank):
                local = exs[rank].exchange_table(shard(s, full, rows, 2, rank), ["k"],
                                                 {1 - rank: addrs[1 - rank]}, epoch=0,
                                                 topology="tree", cluster=views[rank])
                return local

            try:
                with s.retry.enabled(max_attempts=20, base_delay_ms=5):
                    res = run_ranks({r: (lambda r=r: run_rank(r)) for r in (0, 1)})
                with exs[0]._published:
                    epochs = sorted({e for e, _ in exs[0]._frames})
                assert 0 in epochs and all(e < s.shuffle._TREE_EPOCH_STRIDE for e in epochs)
                groupby_matches_single_host(
                    s, {r: s.shuffle._local_groupby_sum(t) for r, t in res.items()}, full)
                return epochs, {r: dense(s, t) for r, t in res.items()}
            finally:
                for ex in exs:
                    ex.close()

        got = [case(s) for s in SIDES]
        assert got[1][0] == got[0][0]
        for r in (0, 1):
            same_dense(got[1][1][r], got[0][1][r])

    @pytest.mark.slow
    def test_tree_equals_all_to_all_world4(self):
        """The two plans move rows differently and aggregate identically
        at world 4; auto picks the tree plan (its frames sit in the derived
        sub-epochs); each plan's rows are the reference's, in its order."""
        rows, seed, world = 1600, 21, 4
        full = demo(PORT, rows, seed)
        for topology, epoch in (("all_to_all", 0), (None, 2)):
            want = exchange_world([REF] * world, rows, seed, epoch=epoch, topology=topology)
            got = exchange_world([PORT] * world, rows, seed, epoch=epoch, topology=topology)
            results = {}
            for r in range(world):
                same_dense(got[r], want[r])
                results[r] = PORT.shuffle._local_groupby_sum(PORT.int64_table(
                    [got[r]["k"][0], got[r]["v"][0]], ["k", "v"]))
            groupby_matches_single_host(PORT, results, full)
        # auto at world 4 took the hypercube plan: the sub-epoch frames
        exs = [PORT.shuffle.TcpExchange(r, device="cpu") for r in range(world)]
        try:
            addrs = {r: ex.address for r, ex in enumerate(exs)}
            with PORT.retry.enabled(max_attempts=40, base_delay_ms=5, max_delay_ms=50):
                run_ranks({r: (lambda r=r: exs[r].exchange_table(
                    shard(PORT, full, rows, world, r), ["k"],
                    {q: a for q, a in addrs.items() if q != r}, epoch=4)) for r in range(world)})
            with exs[0]._published:
                epochs = {e for e, _ in exs[0]._frames}
            assert any(e >= PORT.shuffle._TREE_EPOCH_STRIDE for e in epochs)
        finally:
            for ex in exs:
                ex.close()


# ---------------------------------------------------------------------------
# the four-process chaos acceptance on port workers
# ---------------------------------------------------------------------------


class TestClusterChaosFourRank:
    @pytest.mark.slow
    def test_four_rank_groupby_survives_rank_kill(self):
        """ci/chaos_cluster.json armed in three ``--device cpu`` workers:
        rank 2 SIGKILLs itself on its first payload serve, rank 3 rides a
        netsplit, rank 1 serves with jitter. Exactly one death, generation
        2, at least one recovery, and the group-by is the single-host one."""
        rows, seed, world = 4000, 13, 4
        cfg = os.path.join(REPO, "ci", "chaos_cluster.json")
        s = PORT
        full = demo(s, rows, seed)
        ex0 = s.shuffle.TcpExchange(0, device="cpu")
        procs, view = {}, None
        c0 = {n: counter(s, n) for n in COUNTERS}
        try:
            with s.metrics.enabled():
                procs, peers = s.shuffle.spawn_exchange_fleet(
                    ex0.address, rows, seed, world=world, cluster=True, device="cpu",
                    extra_env_by_rank={r: {s.prefix + "FAULTINJ_CONFIG": cfg}
                                       for r in range(1, world)})
                view = s.cluster.ClusterView(0, dict(peers), ex0,
                                             lineage=lambda r: shard(s, full, rows, world, r))
                view.start()
                res = {}
                with s.deadline.scope(300), s.retry.enabled(max_attempts=40, base_delay_ms=25,
                                                             max_delay_ms=250):
                    local0 = ex0.exchange_table(shard(s, full, rows, world, 0), ["k"],
                                                {r: a for r, a in peers.items() if r != 0},
                                                epoch=0, cluster=view)
                    res[0] = s.shuffle._local_groupby_sum(local0)
                    assert view.await_dead(2, 120), "rank 2 never declared dead"
                    assert procs[2].wait(timeout=120) != 0
                    for r in (1, 3):
                        got = ex0.fetch(peers[r], 1, r)
                        res[r] = s.int64_table([s.host(c) for c in got.columns], ["k", "s", "c"])
                    res[2] = s.shuffle._local_groupby_sum(
                        view.recompute_dead_partition(2, ["k"], world))
                groupby_matches_single_host(s, res, full)
                assert view.dead_ranks() == [2]
                assert view.generation() == 2 and ex0.generation() == 2
                d = {n: counter(s, n) - c0[n] for n in COUNTERS}
                assert d["cluster.deaths"] == 1 and d["cluster.transitions"] == 2
                assert d["cluster.recoveries"] >= 1
        finally:
            if view is not None:
                view.stop()
            for p in procs.values():
                if p.poll() is None:
                    try:
                        p.stdin.close()
                        p.wait(timeout=20)
                    except Exception:  # the child is killed whatever went wrong
                        p.kill()
                        p.wait()
            ex0.close()
            s.shuffle.exchange_breaker().reset()
