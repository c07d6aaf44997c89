"""Port: ``chip_smoke.py``'s analysis path rehearsed on the CPU at a small
size: the armed child (``--analysis-child cpu``) serving its queries and
its pool's hedged group-by, gated by the port's lockdep CLI over the
child's and both workers' reports; planfuzz and plancheck on CPU tables
with every B1 / B4 / B3 call held against its plain version; a world-2
exchange round traced in both ranks and merged with no orphan. On the
CPU no wrapper counts a launch, so the launch gate needs the card."""

import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu_torch.models import tpcds, tpcds_plans


@pytest.fixture
def small_chip_analysis(monkeypatch):
    for name, value in {"ANALYSIS_DEVICE": "cpu", "ANALYSIS_ROWS": 4000,
                        "ANALYSIS_EXCHANGE_ROWS": 4096, "ANALYSIS_FUZZ": (1234, 6)}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return chip_smoke


def test_chip_smoke_analysis_checks_pass_on_the_cpu(small_chip_analysis):
    cs = small_chip_analysis
    tables = {}
    for d in tpcds_plans.PLAN_QUERIES.values():
        fn = d.gen.generator
        tables.setdefault(fn.__name__, fn(600, seed=d.gen.seed, device="cpu"))
    tables.setdefault("gen_store", tpcds.gen_store(600, seed=11, device="cpu"))
    keep = {"plan_inputs": tables}
    entry, launches = cs._analysis_phase(cs._wrappers(), keep)
    assert "plan_inputs" not in keep and sum(launches.values()) == 0
    a = entry["a_armed_serve"]
    assert a["lockdep"]["reports"] == 3 and a["lockdep"]["race_pairs"] == []
    assert a["lockdep"]["cycles"] == [] and a["tracked_objects"] > 0
    assert a["counters"]["sidecar.pool.hedges_launched"] >= 1 and a["counters"]["cache.hits"] >= 1
    b = entry["b_planfuzz_plancheck"]
    assert b["fuzz"]["mismatches"] == 0 and b["fuzz"]["checked"]["probe_paged"] >= 1
    assert b["plancheck"]["violations"] == 0 and b["plancheck"]["plans"] == 29
    c = entry["c_tracemerge"]
    assert c["orphans"] == 0 and c["pids"] == 2 and c["b1_calls_rank0"] >= 1
