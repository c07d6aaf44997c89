"""Port: out-of-core partitioned execution (``spark_rapids_jni_tpu_torch/plan/ooc.py``)
held against the JAX package's.

The JAX side runs once per shape in a module fixture: TPC-H q1's IR over
``gen_lineitem(3000, seed=7)`` in core, and degraded K=4 ways under a
pinched budget (its selection, obligations, fingerprints, result bytes
and counter deltas are recorded). The port's runs are held to those
records: the same selection, K, per-partition peak, fingerprints and
counters (zeros dropped), and result bytes equal to the reference's
in-core answer. The failure paths (resume, lineage recompute, deadline
release), the pin discipline and the metrics artifact run on the port and
are held to the same in-core bytes."""

import dataclasses
import json

import pytest

from torch_memgov_sides import PORT, REF, SIDES, clean, counters, delta

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu import plan as RP
from spark_rapids_jni_tpu.models import tpch as rtpch
from spark_rapids_jni_tpu_torch import plan as PP
from spark_rapids_jni_tpu_torch.models import tpch as ptpch

ROWS, SEED = 3000, 7
OOC_ENV = {"OOC_ENABLED": "1", "OOC_PARTITIONS": "4", "DEVICE_MEMORY_BUDGET": str(36 * 1024)}
COUNTED = ("memgov.", "ooc.", "plan.ooc.")


@pytest.fixture(autouse=True)
def _clean_state():
    for s in SIDES:
        clean(s)
    yield
    for s in SIDES:
        clean(s)


def _q1_ir(P):
    """TPC-H q1's shape through the plan IR: filtered scan -> grouped
    aggregate -> total-order sort over the group keys."""
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


def _col_bytes(side, table):
    return [side.host(c).tobytes() for c in table.columns]


def _env(mp, side, env):
    for k, v in env.items():
        mp.setenv(side.prefix + k, v)


def _selection(cp, P):
    return {
        "ooc": isinstance(cp, P.OutOfCorePlan),
        "partitions": getattr(cp, "partitions", None),
        "est": cp.estimated_memory_bytes,
        "part_peak": getattr(cp, "partition_memory_bytes", None),
        "fired": cp.rewrites_fired.get("partition_for_ooc"),
        "rules": sorted(ob.rule for ob in cp.obligations),
        "fp": getattr(cp, "_fp", None),
        "fp_plan": P.fingerprint(cp.partitioned) if isinstance(cp, P.OutOfCorePlan) else None,
    }


@pytest.fixture(scope="module")
def ref_case():
    """The reference's records, each shape run once."""
    tables = {"lineitem": rtpch.gen_lineitem(ROWS, seed=SEED)}
    ir = _q1_ir(RP)
    incore = RP.compile_ir(ir, tables, name="ooc_oracle")
    out = {"oracle": _col_bytes(REF, incore()), "est": incore.estimated_memory_bytes}
    clean(REF)
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, REF, OOC_ENV)
        with REF.memgov.enabled():
            cp = RP.compile_ir(ir, tables, name="sel")
            out["sel"] = _selection(cp, RP)
            c0 = counters(REF, COUNTED)
            out["ooc_bytes"] = _col_bytes(REF, cp())
            out["ooc_delta"] = delta(c0, counters(REF, COUNTED))
            out["report"] = dict(cp.last_report)
            out["kinds"] = REF.memgov.catalog().kind_stats("partition")
    clean(REF)
    # the model-chosen K at est // 4 (no override) and the auto K at 64 KiB
    for name, env in (("k_model", {"OOC_ENABLED": "1",
                                   "DEVICE_MEMORY_BUDGET": str(max(1024, out["est"] // 4))}),
                      ("k_auto", {"OOC_ENABLED": "1", "OOC_PARTITIONS": "0",
                                  "DEVICE_MEMORY_BUDGET": str(64 * 1024)})):
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("SRJT_OOC_PARTITIONS", raising=False)
            _env(mp, REF, env)
            with REF.memgov.enabled():
                out[name] = _selection(RP.compile_ir(ir, tables, name=name), RP)
    clean(REF)
    return out


@pytest.fixture(scope="module")
def port_case(ref_case):
    """The port's tables and its unconstrained in-core answer, itself held
    to the reference's bit for bit."""
    tables = {"lineitem": ptpch.gen_lineitem(ROWS, seed=SEED, device="cpu")}
    ir = _q1_ir(PP)
    incore = PP.compile_ir(ir, tables, name="ooc_oracle")
    want = _col_bytes(PORT, incore())
    assert want == ref_case["oracle"]
    assert incore.estimated_memory_bytes == ref_case["est"]
    return tables, ir, want


@pytest.fixture
def ooc_env(monkeypatch):
    _env(monkeypatch, PORT, OOC_ENV)


def _kinds():
    return PORT.memgov.catalog().kind_stats("partition")


class TestSelection:
    def test_off_by_default_and_not_when_it_fits(self, port_case, monkeypatch):
        tables, ir, _ = port_case
        monkeypatch.delenv(PORT.prefix + "OOC_ENABLED", raising=False)
        monkeypatch.setenv(PORT.prefix + "DEVICE_MEMORY_BUDGET", str(32 * 1024))
        with PORT.memgov.enabled():
            assert not isinstance(PP.compile_ir(ir, tables, name="off"), PP.OutOfCorePlan)
            monkeypatch.setenv(PORT.prefix + "OOC_ENABLED", "1")
            monkeypatch.setenv(PORT.prefix + "DEVICE_MEMORY_BUDGET", str(1 << 30))
            assert not isinstance(PP.compile_ir(ir, tables, name="fits"), PP.OutOfCorePlan)
        monkeypatch.setenv(PORT.prefix + "DEVICE_MEMORY_BUDGET", str(32 * 1024))
        # the governor disarmed: no out-of-core either
        assert not isinstance(PP.compile_ir(ir, tables, name="unarmed"), PP.OutOfCorePlan)

    def test_selected_and_verifier_discharged_like_the_reference(self, ref_case, port_case,
                                                                 ooc_env):
        tables, ir, _ = port_case
        with PORT.memgov.enabled():
            cp = PP.compile_ir(ir, tables, name="sel")
        assert _selection(cp, PP) == ref_case["sel"]
        assert ref_case["sel"]["ooc"] and ref_case["sel"]["partitions"] == 4
        assert cp.partition_memory_bytes < cp.estimated_memory_bytes
        schemas = {t: {n: c.dtype for n, c in zip(tbl.names, tbl.columns)}
                   for t, tbl in tables.items()}
        assert PP.verify_obligations(cp.obligations, schemas) == []
        assert PP.verify_estimates(cp) == []
        # find_target is the reference's on the reference's own plan
        from spark_rapids_jni_tpu.plan.ooc import find_target as rft
        from spark_rapids_jni_tpu_torch.plan.ooc import find_target as pft

        r, p = rft(_q1_ir(RP)), pft(_q1_ir(PP))
        assert (r.table, r.key_cols) == (p.table, p.key_cols) == (
            "lineitem", ("l_returnflag", "l_linestatus"))

    def test_tampered_partition_branch_fails_discharge(self, port_case, ooc_env):
        from spark_rapids_jni_tpu_torch.plan import exprs as ex
        from spark_rapids_jni_tpu_torch.plan.ooc import partition_rewrite
        from spark_rapids_jni_tpu_torch.plan.verifier import _d_partition_ooc

        tables, ir, _ = port_case
        with PORT.memgov.enabled():
            cp = PP.compile_ir(ir, tables, name="tamper")
        good = next(ob for ob in cp.obligations if ob.rule == "partition_for_ooc")
        agg = good.before
        bad = PP.UnionAll(tuple(
            PP.Aggregate(PP.Filter(agg.input, ex.ppart(agg.keys, 4) == ex.plit(0)),
                         keys=agg.keys, aggs=agg.aggs)
            for _ in partition_rewrite(agg, 4).branches))
        assert _d_partition_ooc(good, None) == []
        assert _d_partition_ooc(dataclasses.replace(good, after=bad), None)


class TestBitIdentical:
    def test_q1_ooc_matches_the_reference_run(self, ref_case, port_case, ooc_env):
        """The degraded run lands on the reference's in-core bytes, spills
        its partitions at rest, releases every partition entry, and moves
        the governor's and the out-of-core counters as the reference's
        degraded run did."""
        tables, ir, want = port_case
        assert ref_case["ooc_bytes"] == ref_case["oracle"]
        with PORT.memgov.enabled():
            cp = PP.compile_ir(ir, tables, name="sel")
            c0 = counters(PORT, COUNTED)
            got = _col_bytes(PORT, cp())
            d = delta(c0, counters(PORT, COUNTED))
        assert got == want == ref_case["oracle"]
        assert d == ref_case["ooc_delta"]
        assert d["memgov.spills"] > 0
        assert _kinds() == ref_case["kinds"] == (0, 0)
        rep = {k: v for k, v in cp.last_report.items() if k != "wall_s"}
        assert rep == {k: v for k, v in ref_case["report"].items() if k != "wall_s"}

    def test_model_and_auto_partition_counts(self, ref_case, port_case, monkeypatch):
        tables, ir, want = port_case
        monkeypatch.delenv(PORT.prefix + "OOC_PARTITIONS", raising=False)
        _env(monkeypatch, PORT, {"OOC_ENABLED": "1",
                                 "DEVICE_MEMORY_BUDGET": str(max(1024, ref_case["est"] // 4))})
        with PORT.memgov.enabled():
            cp = PP.compile_ir(ir, tables, name="k_model")
            assert _selection(cp, PP) == ref_case["k_model"]
            budget = max(1024, ref_case["est"] // 4)
            floor = -(-ref_case["est"] // max(1, budget // 2))
            assert floor <= cp.partitions <= 2 * floor
            assert cp.partition_memory_bytes * 2 <= budget
            assert _col_bytes(PORT, cp()) == want
            _env(monkeypatch, PORT, {"OOC_PARTITIONS": "0",
                                     "DEVICE_MEMORY_BUDGET": str(64 * 1024)})
            cp = PP.compile_ir(ir, tables, name="k_auto")
            assert _selection(cp, PP) == ref_case["k_auto"]
            assert cp.partitions >= 2 and cp.partition_memory_bytes <= 32 * 1024
        from spark_rapids_jni_tpu.plan.stats.model import choose_ooc_partitions as rk
        from spark_rapids_jni_tpu_torch.plan.stats.model import choose_ooc_partitions as pk

        for est, budget in ((16 << 10, 4 << 10), (1 << 30, 1024), (ref_case["est"], 9000)):
            assert pk(est, budget) == rk(est, budget)


class TestFailurePaths:
    def test_midstream_failure_checkpoints_then_resumes(self, port_case, ooc_env):
        tables, ir, want = port_case
        PORT.faultinj.configure({"seed": 1, "faults": {"plan.ooc.partition": {
            "type": "retryable", "percent": 100, "after": 2, "interceptionCount": 1}}})
        with PORT.memgov.enabled():
            cp = PP.compile_ir(ir, tables, name="resume")
            with pytest.raises(PORT.errors.RetryableError):
                cp()
            assert _kinds()[0] >= 1, "checkpoints survive a retryable failure"
            r0 = PORT.metrics.registry().value("ooc.partition_resumes")
            out = cp()
            assert PORT.metrics.registry().value("ooc.partition_resumes") > r0
        assert _col_bytes(PORT, out) == want
        assert _kinds() == (0, 0)

    def test_corrupt_partition_spill_lineage_recomputes(self, port_case, ooc_env,
                                                        monkeypatch):
        tables, ir, want = port_case
        # a tiny host budget cascades the partition spills to disk, where
        # the frame CRCs (and the corrupt rule) live
        monkeypatch.setenv(PORT.prefix + "HOST_MEMORY_BUDGET", "1024")
        PORT.memgov.reset()
        PORT.faultinj.configure({"seed": 2, "faults": {"memgov.spill.frame": {
            "type": "corrupt", "percent": 100, "interceptionCount": 2}}})
        l0 = PORT.metrics.registry().value("ooc.lineage_recomputes")
        with PORT.memgov.enabled():
            out = PP.compile_ir(ir, tables, name="rot")()
        assert _col_bytes(PORT, out) == want
        assert PORT.metrics.registry().value("ooc.lineage_recomputes") > l0
        assert _kinds() == (0, 0)

    def test_deadline_expiry_releases_all_partition_entries(self, port_case, ooc_env):
        tables, ir, _ = port_case
        with PORT.memgov.enabled():
            cp = PP.compile_ir(ir, tables, name="dl")
            with pytest.raises(PORT.errors.DeadlineExceeded):
                with PORT.deadline.scope(0.0001):
                    cp()
        assert _kinds() == (0, 0)


class TestPinDiscipline:
    def test_spill_until_never_touches_pinned_partition(self):
        def case(s):
            cat = s.memgov.BufferCatalog()
            inflight = cat.register("ooc.t.in.0", s.arange(4096), kind="partition")
            atrest = cat.register("ooc.t.in.1", s.arange(4096), kind="partition")
            inflight.pin()
            freed = cat.spill_until(1 << 40, name="pressure")
            out = (inflight.tier, atrest.tier, freed)
            inflight.unpin()
            cat.close()
            return out

        seen = [case(s) for s in SIDES]
        assert seen[0] == seen[1] == ("device", "host", 32768)

    def test_inflight_partition_pinned_during_compute(self, port_case, ooc_env, monkeypatch):
        from spark_rapids_jni_tpu_torch.plan import compiler as compiler_mod

        tables, ir, want = port_case
        real_lower = compiler_mod.lower_ir
        seen = []

        def checking_lower(node, tbls, name="plan", **kw):
            if ".ooc" in name:
                cat = PORT.memgov.catalog()
                pinned = [h for h in list(cat._entries.values())
                          if h.kind == "partition" and h.pinned]
                seen.append(len(pinned))
                cat.spill_until(1 << 40, name="test-squeeze")
                assert all(h.tier == "device" for h in pinned)
            return real_lower(node, tbls, name=name, **kw)

        monkeypatch.setattr(compiler_mod, "lower_ir", checking_lower)
        with PORT.memgov.enabled():
            out = PP.compile_ir(ir, tables, name="pin")()
        assert _col_bytes(PORT, out) == want
        assert seen and all(n >= 1 for n in seen), seen


class TestMetricsArtifact:
    def test_run_report_jsonl(self, port_case, ooc_env, monkeypatch, tmp_path):
        tables, ir, want = port_case
        path = tmp_path / "ooc_metrics.jsonl"
        monkeypatch.setenv(PORT.prefix + "OOC_METRICS", str(path))
        with PORT.memgov.enabled():
            assert _col_bytes(PORT, PP.compile_ir(ir, tables, name="art")()) == want
        lines = [json.loads(ln) for ln in path.read_text().strip().splitlines()]
        assert len(lines) == 1
        rec = lines[0]
        assert rec["ooc"] is True and rec["partitions"] == 4
        assert rec["spills"] > 0 and rec["resumes"] == 0
        assert rec["partition_peak_bytes"] < rec["est_peak_bytes"]
        assert set(rec) == {"query", "ooc", "partitions", "resumes", "lineage_recomputes",
                            "spills", "wall_s", "est_peak_bytes", "partition_peak_bytes"}


def test_one_int32_key_target_runs_b1s_partitioner(monkeypatch):
    """A one-INT32-key aggregate over store_sales (the chip's second
    out-of-core shape): selected, partitioned through
    ``parallel.shuffle.hash_partition`` on its single key, and bit for bit
    the in-core answer."""
    from spark_rapids_jni_tpu_torch.models import tpcds

    tables = {"store_sales": tpcds.gen_store(20_000, seed=3, device="cpu")["store_sales"]}
    ir = PP.Sort(PP.Aggregate(PP.Scan("store_sales"), keys=("ss_item_sk",),
                              aggs=(PP.AggSpec("ss_ext_sales_price", "sum", "rev"),
                                    PP.AggSpec(None, "count_all", "n"))),
                 keys=(("ss_item_sk", True),))
    incore = PP.compile_ir(ir, tables, name="one_key")
    want = _col_bytes(PORT, incore())
    monkeypatch.setenv(PORT.prefix + "OOC_ENABLED", "1")
    monkeypatch.setenv(PORT.prefix + "DEVICE_MEMORY_BUDGET",
                       str(incore.estimated_memory_bytes // 4))
    with PORT.memgov.enabled():
        cp = PP.compile_ir(ir, tables, name="one_key_ooc")
        assert isinstance(cp, PP.OutOfCorePlan) and cp._target.key_cols == ("ss_item_sk",)
        assert _col_bytes(PORT, cp()) == want
    assert cp.last_report["spills"] > 0 and _kinds() == (0, 0)
