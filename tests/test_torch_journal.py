"""Port: the durable query journal (``spark_rapids_jni_tpu_torch/serve/journal.py``)
held against the JAX package's.

Each package replays the other's segments to the same state, every byte
prefix of a torn segment replays alike in both, the live open truncates
a torn tail and a ``torn_write`` fault alike, ``result_digest`` agrees
across the packages (a Table with validity and a STRING column, the
containers a query returns), and a scheduler restarted over the journal
answers duplicate idempotency keys from the digest and resubmits the
incomplete work bit for bit (the reference's ``TestSchedulerJournal``)."""

import numpy as np
import pytest

import torch_serve_sides as S
from torch_serve_sides import PORT, REF, SIDES

import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as RColumn, Table as RTable
from spark_rapids_jni_tpu.columnar import dtype as rdt
from spark_rapids_jni_tpu_torch.columnar import Column as PColumn, Table as PTable
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt

JOURNAL = "journal."


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for s in SIDES:
        monkeypatch.delenv(s.prefix + "JOURNAL_DIR", raising=False)
        s.journal.reset()
        s.faultinj.disable()
    yield
    for s in SIDES:
        s.journal.reset()
        s.faultinj.disable()


def _rec(jid, **kw):
    r = {"jid": jid, "tenant": "t", "priority": 0, "deadline_s": None,
         "memory_bytes": None, "host_eligible": True}
    r.update(kw)
    return r


def _state(st):
    return ({j: (e["rec"], e["state"], e["digest"], e["cause"]) for j, e in st.records.items()},
            st.replayed, st.truncated, st.segments, st.incomplete(), st.counts())


def _write(side, path, monkeypatch):
    monkeypatch.setenv(side.prefix + "JOURNAL_DIR", str(path))
    j = side.journal.active()
    j.append_submit(_rec("p-A", idem="a"))
    j.append_state("p-A", "done", digest=111)
    j.append_submit(_rec("p-B", idem="b", pf="k", bindings=[["int", 3, None]]))
    j.append_state("p-B", "dispatched")
    j.append_submit(_rec("p-C", idem="b"))
    j.append_state("p-C", "failed", cause="boom")
    j.append_submit(_rec("p-D", opaque=True))
    j.append_state("p-B", "done", digest=222)
    side.journal.reset()
    monkeypatch.delenv(side.prefix + "JOURNAL_DIR")


def test_each_package_replays_the_others_journal(tmp_path, monkeypatch):
    states = {}
    for writer in SIDES:
        _write(writer, tmp_path / writer.name, monkeypatch)
        for reader in SIDES:
            states[(writer.name, reader.name)] = _state(reader.journal.replay(
                str(tmp_path / writer.name)))
    assert len({repr(v) for v in states.values()}) == 1
    seg = {s.name: sorted(p.read_bytes() for p in (tmp_path / s.name).glob("seg-*.jrnl"))
           for s in SIDES}
    assert seg["port"] == seg["reference"]  # the segments themselves, byte for byte


def test_every_byte_prefix_replays_alike(tmp_path, monkeypatch):
    _write(PORT, tmp_path / "src", monkeypatch)
    (seg,) = list((tmp_path / "src").glob("seg-*.jrnl"))
    raw = seg.read_bytes()
    torn = tmp_path / "torn"
    torn.mkdir()
    for cut in range(len(raw) + 1):
        (torn / seg.name).write_bytes(raw[:cut])
        st = [s.journal.replay(str(torn)) for s in SIDES]
        assert _state(st[1]) == _state(st[0]), cut
        inc = st[1].incomplete()
        idems = [r.get("idem") for r in inc if r.get("idem")]
        assert len(idems) == len(set(idems))
        assert st[1].done_digest("a") in (None, ("p-A", 111))
        terminal = {j for j, e in st[1].records.items() if e["state"] in PORT.journal.TERMINAL}
        assert not terminal & {r["jid"] for r in inc}


def _live_open_truncates(side, path, monkeypatch):
    _write(side, path, monkeypatch)
    (seg,) = list(path.glob("seg-*.jrnl"))
    raw = seg.read_bytes()
    seg.write_bytes(raw[: len(raw) - 3])
    monkeypatch.setenv(side.prefix + "JOURNAL_DIR", str(path))
    j = side.journal.active()
    out = (seg.stat().st_size < len(raw) - 3, j.done_digest("b"), [r["jid"] for r in j.incomplete()], j.snapshot()["truncated"])
    side.journal.reset()
    return out


def _torn_write_fault(side, path, monkeypatch):
    monkeypatch.setenv(side.prefix + "JOURNAL_DIR", str(path))
    j = side.journal.active()
    assert j.append_submit(_rec("p-1", idem="a"))
    side.faultinj.configure({"seed": 3, "faults": {"journal.append": {
        "type": "torn_write", "percent": 100, "delayMs": 9}}})
    j.append_state("p-1", "done", digest=7)
    side.faultinj.disable()
    side.journal.reset()
    j2 = side.journal.active()
    out = (j2.done_digest("a"), [r["jid"] for r in j2.incomplete()])
    side.journal.reset()
    return out


@pytest.mark.parametrize("case", [_live_open_truncates, _torn_write_fault],
                         ids=lambda f: f.__name__[1:])
def test_torn_tails_match(case, tmp_path, monkeypatch):
    seen = []
    for s in SIDES:
        c0 = S.counters(s, JOURNAL)
        obs = case(s, tmp_path / s.name, monkeypatch)
        seen.append((obs, S.delta(c0, S.counters(s, JOURNAL))))
    assert seen[1] == seen[0]


def test_degraded_and_opaque_match(tmp_path, monkeypatch):
    seen = []
    for s in SIDES:
        monkeypatch.setenv(s.prefix + "JOURNAL_DIR", str(tmp_path / s.name))
        j = s.journal.active()
        assert j.append_submit(_rec("p-1", idem="a", bindings=[object()], pf="k"))
        s.journal.reset()
        (rec,) = s.journal.active().incomplete()

        class _Sick:
            def write(self, b):
                raise OSError("disk full")

            def close(self):
                pass

        j = s.journal.active()
        j._file = _Sick()
        j._file_bytes = 0
        ok = j.append_submit(_rec("p-2"))
        seen.append((rec.get("opaque"), "bindings" in rec, ok, j.degraded,
                     j.append_state("p-1", "done", digest=1)))
        s.journal.reset()
    assert seen[1] == seen[0] == (True, False, False, True, False)


# ---------------------------------------------------------------------------
# result_digest
# ---------------------------------------------------------------------------


def _tables():
    ints = np.arange(-3, 5, dtype=np.int32)
    valid = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    strs = ["a", None, "", "spark", "naïve", None, "x" * 20, "z"]
    f64 = np.linspace(-2, 2, 8)
    dec = [1, None, -25, 10**20, 0, 3, None, -1]
    r = RTable([RColumn(rdt.INT32, data=jnp.asarray(ints), validity=jnp.asarray(valid)),
                RColumn.from_pylist(strs, rdt.STRING),
                RColumn.from_numpy(f64),
                RColumn.from_pylist(dec, rdt.decimal128(-2))], ["i", "s", "f", "d"])
    p = PTable([PColumn.from_numpy(ints, validity=valid, device="cpu"),
                PColumn.from_pylist(strs, pdt.STRING, device="cpu"),
                PColumn.from_numpy(f64, device="cpu"),
                PColumn.from_pylist(dec, pdt.decimal128(-2), device="cpu")], ["i", "s", "f", "d"])
    return r, p


def test_result_digest_agrees_across_packages():
    r, p = _tables()
    pairs = [
        (r, p),
        ((r, 1.5, {"b": np.float64(2.0), "a": 3}, [None, "x"]),
         (p, 1.5, {"b": np.float64(2.0), "a": 3}, [None, "x"])),
        ((r,), (p,)),
        (np.arange(16, dtype=np.int64), np.arange(16, dtype=np.int64)),
        (None, None),
    ]
    for rv, pv in pairs:
        assert PORT.journal.result_digest(pv) == REF.journal.result_digest(rv)
    assert PORT.journal.result_digest(p) != PORT.journal.result_digest((p,))


# ---------------------------------------------------------------------------
# the scheduler over the journal (the reference's TestSchedulerJournal)
# ---------------------------------------------------------------------------


def _boom():
    raise RuntimeError("boom")


def _lifecycle_and_idempotency(side, path, monkeypatch):
    s = side.serve.Scheduler(max_concurrent=1, name="joff")
    try:
        h = s.submit(lambda: 7, tenant="t")
        off = (h.result(10), h._jid, side.journal.active())
    finally:
        s.shutdown(drain=False, timeout_s=10)
    monkeypatch.setenv(side.prefix + "JOURNAL_DIR", str(path))
    payload = np.arange(16, dtype=np.int64)
    s = side.serve.Scheduler(max_concurrent=1, name="jlife")
    try:
        ok = s.submit(lambda: payload.copy(), tenant="t", idempotency_key="once")
        assert np.array_equal(ok.result(10), payload)
        bad = s.submit(_boom, tenant="t")
        with pytest.raises(RuntimeError):
            bad.result(10)
    finally:
        s.shutdown(drain=False, timeout_s=10)
    side.journal.reset()  # the restarted coordinator
    st = side.journal.active().state
    counts = st.counts()
    s2 = side.serve.Scheduler(max_concurrent=1, name="jidem")
    try:
        ans = s2.submit(_boom, tenant="t", idempotency_key="once").result(10)
    finally:
        s2.shutdown(drain=False, timeout_s=10)
    return (off, counts, isinstance(ans, side.journal.DigestAnswer), ans.digest,
            ans.matches(payload), ans.matches(payload + 1))


def test_lifecycle_and_idempotent_hits_match(tmp_path, monkeypatch):
    seen = []
    for s in SIDES:
        c0 = S.counters(s, JOURNAL)
        obs = _lifecycle_and_idempotency(s, tmp_path / s.name, monkeypatch)
        seen.append((obs, S.delta(c0, S.counters(s, JOURNAL))))
        s.journal.reset()
    assert seen[1] == seen[0]
    assert seen[0][1]["journal.idempotent_hits"] == 1


def _plan_tables():
    from spark_rapids_jni_tpu_torch.columnar import Column, Table

    rng = np.random.default_rng(23)
    rows = 96
    return {"fact": Table([Column.from_numpy(np.arange(rows, dtype=np.int64), device="cpu"),
                           Column.from_numpy(rng.integers(0, 5, rows).astype(np.int64), device="cpu"),
                           Column.from_numpy(rng.random(rows), device="cpu")], ["v", "k", "p"])}


def _mk(P, cut, factor=2.0):
    return P.Aggregate(
        P.Filter(P.Scan("fact"), (P.pcol("v") < P.plit(cut)) & (P.pcol("p") < P.plit(factor))),
        keys=("k",), aggs=(P.AggSpec("v", "sum", "s"),))


def test_recover_resubmits_the_incomplete_bit_for_bit(tmp_path, monkeypatch):
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.plan.rewrites import fingerprint, parameterized_fingerprint

    JM = PORT.journal
    monkeypatch.setenv(PORT.prefix + "JOURNAL_DIR", str(tmp_path))
    tabs = _plan_tables()
    template = _mk(P, 0)
    oracle = P.compile_ir(_mk(P, 40, 0.75), tabs, name="oracle")().to_pydict()
    pf = parameterized_fingerprint(_mk(P, 40, 0.75))
    rec = {"pf": pf.key, "bindings": JM.sanitize_bindings(pf.bindings)}
    rebound = JM.rebind_for_record(_mk(P, 40, 0.75), rec)
    assert rebound is not None and fingerprint(rebound) == fingerprint(_mk(P, 40, 0.75))
    assert JM.rebind_for_record(P.Scan("fact"), rec) is None
    assert JM.rebind_for_record(_mk(P, 40), {"pf": pf.key, "bindings": []}) is None
    j = JM.active()
    j.append_submit(_rec("dead-1", idem="r1", **rec))
    j.append_submit(_rec("o-1", opaque=True))
    JM.reset()
    c0 = S.counters(PORT, JOURNAL)
    s = PORT.serve.Scheduler(max_concurrent=1, name="jrec")
    try:
        report = JM.recover(s, lambda r: (template, tabs) if r.get("pf") == pf.key else None)
        assert report["skipped"] == 1
        ((got, h),) = report["resubmitted"]
        assert got["jid"] == "dead-1"
        assert h.result(60).to_pydict() == oracle
    finally:
        s.shutdown(drain=False, timeout_s=10)
    d = S.delta(c0, S.counters(PORT, JOURNAL))
    assert d["journal.recovered_resubmits"] == 1 and d["journal.recovery_skipped"] == 1
    JM.reset()
    assert JM.active().done_digest("r1") is not None
    # a duplicate of the recovered query is now answered from the digest
    s = PORT.serve.Scheduler(max_concurrent=1, name="jdup")
    try:
        ans = s.submit(_mk(P, 40, 0.75), tabs, tenant="t", idempotency_key="r1").result(10)
    finally:
        s.shutdown(drain=False, timeout_s=10)
    assert isinstance(ans, JM.DigestAnswer)
    assert ans.matches(P.compile_ir(_mk(P, 40, 0.75), tabs, name="again")())
