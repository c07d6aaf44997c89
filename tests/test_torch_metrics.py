"""Port: the metrics registry (``spark_rapids_jni_tpu_torch/utils/metrics.py``)
held against the JAX package's: the same call sequence gives equal
snapshots, counter snapshots, histogram buckets and quantiles, KeyedEwma
values, adaptive timeouts and rendered reports."""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu.utils import metrics as rm
from spark_rapids_jni_tpu.utils import retry as rretry
from spark_rapids_jni_tpu_torch.utils import metrics as pm
from spark_rapids_jni_tpu_torch.utils import retry as pretry

SEED = 1414


def _drive(mod, seed=SEED):
    """One call sequence over a fresh registry of ``mod``."""
    reg = mod.Registry()
    rng = np.random.default_rng(seed)
    for i in range(300):
        reg.counter(f"c.{i % 7}").inc(int(rng.integers(1, 5)))
        reg.histogram(f"h.{i % 3}").record(float(rng.lognormal(4.0, 2.0)))
        reg.gauge("g.last").set(i)
        reg.gauge("g.max").set_max(int(rng.integers(0, 1000)))
    reg.histogram("h.zero").record(0)
    reg.histogram("h.neg").record(-5.0)
    reg.histogram("h.huge").record(float(1 << 70))
    return reg


def test_registry_snapshots_match():
    a, b = _drive(pm).snapshot(), _drive(rm).snapshot()
    assert a == b
    assert set(a["histograms"]) == {"h.0", "h.1", "h.2", "h.zero", "h.neg", "h.huge"}


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_quantiles_match(q):
    a, b = _drive(pm), _drive(rm)
    for name in ("h.0", "h.1", "h.2", "h.zero", "h.huge"):
        assert a.peek(name).quantile(q) == b.peek(name).quantile(q)


def test_quantile_edges_match():
    for mod in (pm, rm):
        with pytest.raises(ValueError):
            mod.Histogram().quantile(1.5)
        assert mod.Histogram().quantile(0.5) is None
    assert [pm.Histogram.bucket_index(v) for v in (0, 1, 2, 3, 4, 7, 8, 1 << 80)] == \
        [rm.Histogram.bucket_index(v) for v in (0, 1, 2, 3, 4, 7, 8, 1 << 80)]


def test_registry_type_clash_and_value():
    for mod in (pm, rm):
        reg = mod.Registry()
        reg.counter("x").inc(3)
        with pytest.raises(TypeError):
            reg.histogram("x")
        assert reg.value("x") == 3 and reg.value("missing", 7) == 7
        assert reg.peek("missing") is None and "missing" not in reg.names()
        reg.reset()
        assert reg.value("x") == 0 and reg.names() == ["x"]


def test_keyed_ewma_matches():
    rng = np.random.default_rng(SEED)
    a, b = pm.KeyedEwma(alpha=0.3, max_keys=5), rm.KeyedEwma(alpha=0.3, max_keys=5)
    for _ in range(200):
        key, v = f"k{int(rng.integers(0, 8))}", float(rng.normal(10, 3))
        assert a.update(key, v) == b.update(key, v)
    assert a.snapshot() == b.snapshot() and len(a) == len(b) == 5
    for k in a.snapshot():
        assert (a.get(k), a.jitter(k), a.count(k)) == (b.get(k), b.jitter(k), b.count(k))
    for mod in (pm, rm):
        with pytest.raises(ValueError):
            mod.KeyedEwma(alpha=0.0)
        with pytest.raises(ValueError):
            mod.KeyedEwma(max_keys=0)


@pytest.fixture
def fresh():
    """Both process registries and retry tallies zeroed (an earlier test
    in the same process may have retried), the gates restored
    afterwards."""
    prev = (pm.is_enabled(), rm.is_enabled())
    _zero()
    yield
    for mod, on in zip((pm, rm), prev):
        (mod.enable if on else mod.disable)()
    _zero()


def _zero():
    pm.reset()
    rm.reset()
    pretry.reset_stats()
    rretry.reset_stats()


def _gated_sequence(mod):
    mod.counter("seq.disarmed").inc()  # a stub: never registered
    with mod.timer("seq.untimed"):
        pass
    with mod.enabled():
        mod.counter("seq.calls").inc(2)
        mod.histogram("seq.h").record(12.5)
        mod.gauge("seq.g").set(4)
        mod.record_op("seq.op", 0.0025)
        mod.record_op("seq.op", 0.004)
    mod.registry().counter("seq.durable").inc()


def test_gated_accessors_and_counters_snapshot(fresh):
    _gated_sequence(pm)
    _gated_sequence(rm)
    pc = {k: v for k, v in pm.counters_snapshot().items() if "seq." in k}
    rc = {k: v for k, v in rm.counters_snapshot().items() if "seq." in k}
    assert pc == rc == {"seq.calls": 2, "op.seq.op.calls": 2, "seq.durable": 1}
    ps, rs = pm.snapshot(), rm.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert ({k: v for k, v in ps[kind].items() if "seq." in k}
                == {k: v for k, v in rs[kind].items() if "seq." in k})
    assert "op.seq.untimed.calls" not in ps["counters"]
    assert isinstance(pm.counter("seq.disarmed"), pm._NullMetric)
    assert pm.histogram("x").quantile(0.5) is None and pm.gauge("x").value == 0


def test_render_report_and_stage_report_match(fresh):
    _gated_sequence(pm)
    _gated_sequence(rm)
    rep_p, rep_r = pm.stage_report("stage"), rm.stage_report("stage")
    assert rep_p == rep_r
    assert pm.render_report(rep_p) == rm.render_report(rep_r)
    assert rep_p["ops"]["seq.op"]["calls"] == 2
    nested = {"a": {"b": 1, "h": {"count": 2, "sum": 3.0, "max": 2.0, "buckets": {}}}, "z": "s"}
    assert pm.render_report(nested) == rm.render_report(nested)


@pytest.mark.parametrize("n", [10, 40, 200])
def test_adaptive_timeout_matches(fresh, n):
    for mod in (pm, rm):
        h = mod.registry().histogram("lat.us")
        for v in np.random.default_rng(n).lognormal(13.0, 1.0, n):
            h.record(float(v))
    for static in (5.0, 60.0, 600.0):
        assert pm.adaptive_timeout_s("lat.us", static) == rm.adaptive_timeout_s("lat.us", static)
    assert pm.adaptive_timeout_s("absent.us", 3.0) == (3.0, False)


def test_fold_worker_counters_matches(fresh):
    snap = {"a": 3, "sidecar.worker.b": 4}
    pm.fold_worker_counters(snap)
    rm.fold_worker_counters(snap)
    assert pm.registry().value("sidecar.worker.a") == rm.registry().value("sidecar.worker.a") == 3
    assert pm.registry().value("sidecar.worker.b") == 4


def test_event_log_lines(fresh, tmp_path):
    path = tmp_path / "events.jsonl"
    pm.event("not.logged", x=1)  # disarmed
    with pm.enabled(log_path=str(path)):
        pm.event("one", x=1)
        pm.event("two", y="z")
    pm.event("after", x=2)  # the scope restored the previous path
    pm.close_log()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["event"] for r in lines] == ["one", "two"]
    assert lines[0]["x"] == 1 and lines[1]["y"] == "z" and "ts" in lines[0]


def test_split_retries_live_in_the_registry(fresh):
    from spark_rapids_jni_tpu_torch.utils import memory

    before = memory.split_retry_count()
    memory._note_split()
    memory._note_split()
    assert memory.split_retry_count() == before + 2
    assert pm.registry().value("memory.split_retries") == before + 2
    assert pm.stage_report("s")["memory"]["split_retries"] == before + 2


def _int_table(pkg):
    """A small INT64 / FLOAT32 table of the same bits in either package."""
    a = np.arange(64, dtype=np.int64) % 7
    b = np.linspace(-1, 1, 64, dtype=np.float32)
    if pkg == "port":
        from spark_rapids_jni_tpu_torch.columnar import Table
        from spark_rapids_jni_tpu_torch.columnar import dtype as dt

        return Table.from_numpy([a, b], [dt.INT64, dt.FLOAT32], names=["k", "v"], device="cpu")
    import jax.numpy as jnp
    from spark_rapids_jni_tpu.columnar import Column, Table
    from spark_rapids_jni_tpu.columnar import dtype as dt

    return Table([Column(dt.INT64, data=jnp.asarray(a)), Column(dt.FLOAT32, data=jnp.asarray(b))],
                 ["k", "v"])


@pytest.mark.parametrize("where", ["payload", "header"])
def test_integrity_counters_match(fresh, where):
    from spark_rapids_jni_tpu.columnar import frames as rfr
    from spark_rapids_jni_tpu.utils import integrity as rint
    from spark_rapids_jni_tpu_torch.columnar import frames as pfr
    from spark_rapids_jni_tpu_torch.utils import errors as perr
    from spark_rapids_jni_tpu_torch.utils import integrity as pint

    buf = pfr.encode_table(_int_table("port"))
    bad = bytearray(buf)
    bad[len(buf) - 3 if where == "payload" else 40] ^= 0x40
    for fr, kw in ((pfr, {"device": "cpu"}), (rfr, {})):
        fr.decode_table(buf, **kw)
        with pytest.raises(Exception, match="CRC mismatch"):
            fr.decode_table(bytes(bad), **kw)
    names = ("sidecar.integrity.frame_decodes_checked", "sidecar.integrity.crc_mismatch",
             "sidecar.integrity.crc_mismatch.columnar.frame",
             "sidecar.integrity.crc_mismatch.columnar.frame.header")
    got = [pm.registry().value(n) for n in names]
    assert got == [rm.registry().value(n) for n in names]
    assert got[0] == 1 and got[1] == 1
    ps, rs = pint.stats_section(), rint.stats_section()
    assert {k: v for k, v in ps.items() if k != "algorithm"} == \
        {k: v for k, v in rs.items() if k != "algorithm"}
    assert issubclass(perr.DataCorruption, perr.RetryableError)


def test_pipeline_counters_match(fresh):
    from spark_rapids_jni_tpu import pipeline as rp
    from spark_rapids_jni_tpu_torch import pipeline as pp

    for mod, pkg in ((pp, "port"), (rp, "reference")):
        plan = mod.PlanSpec(group_by=(mod.GroupKey("k", 7),),
                            aggregates=(mod.Agg("v", "sum"), mod.Agg("v", "count")))
        with (pm if mod is pp else rm).enabled():
            pipe = mod.compile_plan(plan)
            t = _int_table(pkg)
            pipe(t)
            pipe(t, deadline_s=30.0)
    snap = [{k: v for k, v in m.counters_snapshot().items()
             if k.startswith(("pipeline.", "op.compiled_pipeline")) and v} for m in (pm, rm)]
    assert snap[0] == snap[1] == {"pipeline.compiles": 1, "pipeline.batches": 2,
                                  "pipeline.rows": 128, "op.compiled_pipeline.calls": 2}
