"""Port: the cross-process TCP exchange (``parallel/shuffle.TcpExchange``
and its worker harness) held against the JAX package's on the same seeded
inputs, every port tensor on the CPU. Each case runs the reference's steps
on both packages; the exchanges' received rows, their order and validity
must be the reference's, under the direct and the tree plan, and a world
with one rank of each package must move what an all-reference world moves
(the wire format byte for byte, fenced and traced verbs armed)."""

import contextlib
import os
import time
import types

import numpy as np
import pytest
import torch

from torch_exchange_sides import (PORT, REF, SIDES, counter, demo, exchange_world,
                                  groupby_matches_single_host, same_dense, shard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = [s.name for s in SIDES]


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


def _arange_table(side, n):
    return side.int64_table([np.arange(n, dtype=np.int64)], ["x"])


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_exchange_mode_env(side, monkeypatch):
    knob = side.prefix + "EXCHANGE_MODE"
    monkeypatch.delenv(knob, raising=False)
    assert side.shuffle.exchange_mode() == "mesh"
    monkeypatch.setenv(knob, "tcp")
    assert side.shuffle.exchange_mode() == "tcp"
    monkeypatch.setenv(knob, "bogus")
    with pytest.warns(UserWarning):
        assert side.shuffle.exchange_mode() == "mesh"


def test_wire_constants_are_the_references():
    for name in ("_EXC_MAGIC", "_EXC_GET", "_EXC_GET_TRACED", "_EXC_GET_FENCED",
                 "_EXC_GET_FENCED_TRACED", "_EXC_PING", "_EXC_OK", "_EXC_RETRY", "_EXC_ERR",
                 "_EXC_STALE", "_TREE_EPOCH_STRIDE", "_RECOVERY_EPOCH_STRIDE"):
        assert getattr(PORT.shuffle, name) == getattr(REF.shuffle, name), name
    for name in ("_EXC_REQ", "_EXC_RESP", "_EXC_GEN"):
        assert getattr(PORT.shuffle, name).format == getattr(REF.shuffle, name).format, name
    assert sorted(PORT.shuffle.__all__) == sorted(REF.shuffle.__all__)
    assert PORT.shuffle.format_peers({1: "h:2", 0: "h:1"}) == REF.shuffle.format_peers(
        {1: "h:2", 0: "h:1"})
    assert PORT.shuffle.parse_peers("0=h:1,,1=h:2") == REF.shuffle.parse_peers("0=h:1,,1=h:2")
    assert [PORT.shuffle._shard_bounds(1001, 4, r) for r in range(4)] == [
        REF.shuffle._shard_bounds(1001, 4, r) for r in range(4)]


def test_two_rank_exchange_matches_reference():
    """Each rank's received partition: the reference's rows, order and
    validity; and the group-by of the two ranks the single-host one."""
    rows, seed = 2000, 7
    want = exchange_world([REF, REF], rows, seed)
    got = exchange_world([PORT, PORT], rows, seed)
    for r in (0, 1):
        same_dense(got[r], want[r])
        assert got[r]["k"][0].shape[0] > 0
    results = {r: PORT.shuffle._local_groupby_sum(PORT.int64_table(
        [got[r]["k"][0], got[r]["v"][0]], ["k", "v"])) for r in (0, 1)}
    groupby_matches_single_host(PORT, results, demo(PORT, rows, seed))


@pytest.mark.parametrize("topology", ["all_to_all", "tree"])
def test_world4_plan_order_matches_reference(topology):
    """Both plans at world 4: every rank holds the reference's rows in the
    reference's order (the two plans' orders differ; neither is sorted)."""
    rows, seed = 1600, 21
    want = exchange_world([REF] * 4, rows, seed, topology=topology)
    got = exchange_world([PORT] * 4, rows, seed, topology=topology)
    for r in range(4):
        same_dense(got[r], want[r])


@contextlib.contextmanager
def _traced(side):
    qt = side.tracing.start_trace("exchange.mixed")
    with qt.activate():
        yield
    qt.finish()


@pytest.mark.parametrize("port_rank", [0, 1])
def test_mixed_world_moves_what_an_all_reference_world_moves(port_rank, monkeypatch):
    """One rank of each package, fenced (generation 1 on both) and traced
    (a sampled trace active on both): each rank receives what it receives
    when both ranks are the reference's."""
    rows, seed = 1200, 17
    want = exchange_world([REF, REF], rows, seed)
    sides = [REF, REF]
    sides[port_rank] = PORT
    served = {s.name: 0 for s in SIDES}
    for s in SIDES:
        decode = s.tracing.decode_wire_context

        def spy(blob, s=s, decode=decode):
            served[s.name] += 1
            return decode(blob)

        monkeypatch.setattr(s.tracing, "decode_wire_context", spy)
    stale0 = {s.name: counter(s, "cluster.stale_generation_rejects") for s in SIDES}
    with REF.tracing.enabled(), PORT.tracing.enabled():
        got = exchange_world(sides, rows, seed, arm=lambda ex: ex.set_generation(1),
                             scope=_traced)
    for r in (0, 1):
        same_dense(got[r], want[r])
    # each server decoded the other's trace context: the traced, fenced verb
    assert served == {"reference": 1, "port": 1}
    assert all(counter(s, "cluster.stale_generation_rejects") == stale0[s.name] for s in SIDES)


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_tampered_exchange_raises_retryable_corruption(side):
    """A tampered frame decodes to retryable DataCorruption (counted) and
    heals under retry once the fault budget is spent."""
    rule = {"seed": 5, "faults": {"exchange.frame": {
        "type": "corrupt", "percent": 100, "interceptionCount": 1}}}
    ex1 = side.shuffle.TcpExchange(1, **side.kw)
    ex0 = side.shuffle.TcpExchange(0, **side.kw)
    try:
        ex1.publish(0, {0: _arange_table(side, 128)})
        side.faultinj.configure(rule)
        before = counter(side, "sidecar.integrity.crc_mismatch")
        with pytest.raises(side.errors.DataCorruption):
            ex0._fetch_once(ex1.address, 0, 0)
        assert counter(side, "sidecar.integrity.crc_mismatch") == before + 1
        side.faultinj.configure(rule)
        with side.retry.enabled(max_attempts=5, base_delay_ms=1):
            out = ex0.fetch(ex1.address, 0, 0)
        assert np.array_equal(side.host(out.columns[0]), np.arange(128))
        assert side.retry.stats()["retries"] >= 1
    finally:
        ex0.close()
        ex1.close()


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_epoch_eviction_bounds_retention(side):
    ex = side.shuffle.TcpExchange(0, publish_wait_s=0.05, retain_epochs=2, **side.kw)
    try:
        evicted0 = counter(side, "shuffle.tcp.frames_evicted")
        with side.metrics.enabled():
            for epoch in range(4):
                ex.publish(epoch, {1: _arange_table(side, 8)})
        with ex._published:
            assert sorted({e for e, _ in ex._frames}) == [2, 3]
        assert counter(side, "shuffle.tcp.frames_evicted") == evicted0 + 2
        with pytest.raises(side.errors.RetryableError, match="not\\s+published"):
            ex._fetch_once(ex.address, 0, 1)
        out = ex._fetch_once(ex.address, 3, 1)
        assert np.array_equal(side.host(out.columns[0]), np.arange(8))
        assert ex.drop_epoch(2) == 1
        with ex._published:
            assert (2, 1) not in ex._frames
    finally:
        ex.close()


def test_result_after_tree_rounds_survives_eviction():
    """A worker's two tree rounds publish at epoch + (j+1) * 2^16, then its
    result at epoch 3. The port keeps the most recently published epochs,
    so the result stays servable; the reference keeps the numerically
    largest and evicts the result as it is published (its worker can then
    never hand over a result after two or more tree rounds)."""
    stride = PORT.shuffle._TREE_EPOCH_STRIDE
    kept = {}
    for s in SIDES:
        with s.shuffle.TcpExchange(0, publish_wait_s=0.05, retain_epochs=4, **s.kw) as ex:
            for rnd in (0, 2):
                for j in (1, 2):
                    ex.publish(rnd + j * stride, {1: _arange_table(s, 8)})
            ex.publish(3, {0: _arange_table(s, 8)})
            with ex._published:
                kept[s.name] = (3, 0) in ex._frames
    assert kept == {"port": True, "reference": False}


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_unpublished_partition_is_retryable(side):
    ex1 = side.shuffle.TcpExchange(1, publish_wait_s=0.05, **side.kw)
    ex0 = side.shuffle.TcpExchange(0, **side.kw)
    try:
        with pytest.raises(side.errors.RetryableError, match="not\\s+published"):
            ex0._fetch_once(ex1.address, 9, 9)
    finally:
        ex0.close()
        ex1.close()


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_dead_peer_fetch_respects_deadline(side):
    ex0 = side.shuffle.TcpExchange(0, **side.kw)
    try:
        t0 = time.monotonic()
        with pytest.raises((side.errors.DeadlineExceeded, side.errors.RetryableError)):
            with side.deadline.scope(0.5):
                with side.retry.enabled(max_attempts=50, base_delay_ms=10):
                    ex0.fetch("127.0.0.1:9", 0, 0)  # the discard port: refused
        assert time.monotonic() - t0 < 10
    finally:
        ex0.close()


def _worker_args(**kw):
    args = dict(rank=1, world=2, rows=8, seed=1, epoch=0, bind="127.0.0.1:0", peers="",
                cluster=False, query="demo", rounds=1, device="cpu")
    args.update(kw)
    return types.SimpleNamespace(**args)


def test_worker_harness_refuses_mesh_mode(monkeypatch, capsys):
    monkeypatch.setenv("SRJT_EXCHANGE_MODE", "mesh")
    assert REF.shuffle._exchange_worker_main(_worker_args()) == 2
    monkeypatch.setenv(PORT.prefix + "EXCHANGE_MODE", "mesh")
    assert PORT.shuffle._exchange_worker_main(_worker_args()) == 2
    assert "must be 'tcp'" in capsys.readouterr().err


def test_worker_without_a_card_or_q55_exits_before_ready(monkeypatch, capsys):
    """The port's own refusal: with no card and no ``--device cpu``, the
    demo leg and the plan tier's q55 leg both exit non-zero before the
    READY line (``--query q55`` runs with CPU workers, below)."""
    monkeypatch.delenv(PORT.prefix + "EXCHANGE_MODE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PORT.shuffle._exchange_worker_main(_worker_args(device=None)) == 2
    assert PORT.shuffle._exchange_worker_main(_worker_args(device=None, query="q55")) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert err.count("no CUDA device") == 2


def test_exchange_device_is_explicit(monkeypatch):
    """``device=None`` means the card: without one the constructor raises
    (and opens no socket); a fetched partition lands on the exchange's
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.shuffle.TcpExchange(0)
    with PORT.shuffle.TcpExchange(0, device="cpu") as ex:
        assert ex.device == torch.device("cpu")
        ex.publish(0, {0: _arange_table(PORT, 16)})
        out = ex.fetch(ex.address, 0, 0)
        assert all(c.device == torch.device("cpu") for c in out.columns)


def test_spawn_fleet_kills_started_children_when_a_spawn_fails(monkeypatch):
    killed = []

    class FakeProc:
        def __init__(self, rank):
            self.rank = rank

        def kill(self):
            killed.append(self.rank)

        def wait(self):
            return -9

    def fake_spawn(parent_addr, rows, seed, *, rank, **kw):
        if rank == 3:
            raise PORT.errors.FatalDeviceError("exchange peer exited during startup rc=2")
        return FakeProc(rank), f"127.0.0.1:{1000 + rank}"

    monkeypatch.setattr(PORT.shuffle, "spawn_exchange_peer", fake_spawn)
    with pytest.raises(PORT.errors.FatalDeviceError, match="startup"):
        PORT.shuffle.spawn_exchange_fleet("127.0.0.1:999", 64, 1, world=4, device="cpu")
    assert sorted(killed) == [1, 2]


def _close_children(*procs):
    """Close each live child's stdin and wait for its exit; a child that
    does not exit is killed, and ``killed_after_close`` says so."""
    for p in procs:
        if p is not None and p.poll() is None:
            try:
                p.stdin.close()
                p.wait(timeout=20)
            except Exception:  # the child is killed whatever went wrong
                p.killed_after_close = True
                p.kill()
                p.wait()


def test_two_process_groupby_with_cpu_workers():
    """The one tier-1 test that starts interpreters: a worker started
    without a card and without ``--device cpu`` fails the spawn before
    READY; a ``--device cpu`` worker as rank 1 of a two-rank world gives
    the single-host group-by bit for bit with this process as rank 0."""
    rows, seed = 3000, 11
    full = demo(PORT, rows, seed)
    ex0 = PORT.shuffle.TcpExchange(0, device="cpu")
    proc = None
    try:
        if not torch.cuda.is_available():
            # the child's pipes close before it can be reaped: the spawn
            # must still report the exit, its code and the child's stderr
            with pytest.raises(PORT.errors.FatalDeviceError,
                               match=r"exited during startup rc=2(.|\n)*no CUDA device"):
                PORT.shuffle.spawn_exchange_peer(ex0.address, 64, seed, ready_timeout_s=120)
        proc, addr = PORT.shuffle.spawn_exchange_peer(ex0.address, rows, seed, device="cpu",
                                                       ready_timeout_s=120)
        with PORT.retry.enabled(max_attempts=20, base_delay_ms=5, max_delay_ms=50):
            local0 = ex0.exchange_table(shard(PORT, full, rows, 2, 0), ["k"], {1: addr}, epoch=0)
            res1 = ex0.fetch(addr, 1, 1)
        results = {0: PORT.shuffle._local_groupby_sum(local0),
                   1: PORT.int64_table([PORT.host(c) for c in res1.columns], ["k", "s", "c"])}
        groupby_matches_single_host(PORT, results, full)
    finally:
        _close_children(proc)
        ex0.close()
    assert proc.returncode == 0, (
        f"worker rc={proc.returncode} killed_after_close="
        f"{getattr(proc, 'killed_after_close', False)}; its stderr:\n"
        f"{PORT.shuffle.peer_stderr(proc)}")


def test_two_process_q55_with_cpu_workers():
    """The worker's ``--query q55`` leg: a ``--device cpu`` worker as rank
    1 of a two-rank world runs the q55 plan with exchange stages, and its
    published partial merged with this process's rank-0 partial is the
    unbound (single-host) plan's result bit for bit."""
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.models.tpcds_plans import q55_plan
    from spark_rapids_jni_tpu_torch.plan import compile_ir
    from spark_rapids_jni_tpu_torch.plan.distribute import (exchange_context, insert_exchanges,
                                                            merge_partials)

    rows, seed, world = 8000, 12, 2
    tables = tpcds.gen_store(rows, seed=seed, device="cpu")
    plan = insert_exchanges(q55_plan(), world)
    ref = compile_ir(plan, tables, name="q55x2-oracle")()
    assert ref.num_rows > 0
    sales = tables["store_sales"]

    def shard_tables(r):
        out = dict(tables)
        out["store_sales"] = shard(PORT, sales, sales.num_rows, world, r)
        return out

    ex0 = PORT.shuffle.TcpExchange(0, device="cpu")
    proc = None
    try:
        proc, addr = PORT.shuffle.spawn_exchange_peer(
            ex0.address, rows, seed, rank=1, world=world, query="q55", device="cpu",
            ready_timeout_s=120)
        with PORT.retry.enabled(max_attempts=20, base_delay_ms=5, max_delay_ms=50):
            with exchange_context(ex0, {1: addr}, shard_tables=shard_tables):
                part0 = compile_ir(plan, shard_tables(0), name="q55x2-r0")()
            part1 = ex0.fetch(addr, 1, 1)
        names = list(ref.names)
        part1 = type(part1)(part1.columns, names)  # a frame carries no names
        got = merge_partials([part0, part1], [("ext_price", False), ("i_brand_id", True)])
        assert got.num_rows == ref.num_rows
        for name in names:
            assert np.array_equal(PORT.host(got.column(name)), PORT.host(ref.column(name))), name
    finally:
        _close_children(proc)
        ex0.close()
    assert proc.returncode == 0, (
        f"worker rc={proc.returncode}; its stderr:\n{PORT.shuffle.peer_stderr(proc)}")


class TestTcpExchangeTwoProcess:
    @pytest.mark.slow
    def test_two_process_groupby_bit_identical_under_chaos(self):
        """The reference's acceptance on port workers: ci/chaos_crash.json
        armed in the peer corrupts its first served frame (caught by the
        CRC, re-fetched by retry) and kills it on its result serve; a clean
        respawn recomputes, and the group-by is the single-host one."""
        rows, seed = 3000, 11
        cfg = os.path.join(REPO, "ci", "chaos_crash.json")
        full = demo(PORT, rows, seed)
        ex0 = PORT.shuffle.TcpExchange(0, device="cpu")
        proc = proc2 = None
        mismatch0 = counter(PORT, "sidecar.integrity.crc_mismatch")
        try:
            proc, addr = PORT.shuffle.spawn_exchange_peer(
                ex0.address, rows, seed, device="cpu",
                extra_env={PORT.prefix + "FAULTINJ_CONFIG": cfg})
            with PORT.deadline.scope(300), PORT.retry.enabled(
                    max_attempts=6, base_delay_ms=5, max_delay_ms=50):
                local0 = ex0.exchange_table(shard(PORT, full, rows, 2, 0), ["k"], {1: addr},
                                            epoch=0)
                res0 = PORT.shuffle._local_groupby_sum(local0)
                with pytest.raises(PORT.errors.RetryableError):
                    ex0.fetch(addr, 1, 1)  # the `crash` rule's serve
                assert proc.wait(timeout=120) != 0
                proc2, addr = PORT.shuffle.spawn_exchange_peer(
                    ex0.address, rows, seed, device="cpu", respawn_of=proc)
                res1 = ex0.fetch(addr, 1, 1)
            results = {0: res0, 1: PORT.int64_table([PORT.host(c) for c in res1.columns],
                                                    ["k", "s", "c"])}
            groupby_matches_single_host(PORT, results, full)
            assert counter(PORT, "sidecar.integrity.crc_mismatch") > mismatch0
        finally:
            _close_children(proc, proc2)
            ex0.close()
            PORT.shuffle.exchange_breaker().reset()

