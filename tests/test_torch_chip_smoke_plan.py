"""Port: chip_smoke.py's plan path rehearsed on the CPU at a small size
(``PLAN_DEVICE = "cpu"``): its inputs, compiles, counted run, the CPU
comparison, the hand-built and numpy-oracle checks and the ppart
projection run as on the card, and its checks catch a wrong result. No
jax: the path's oracles are numpy and the port's own queries."""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk


def _warm(prefix, ops, stage, watch):
    """``_warm_and_profile`` without the card's memory stats and profiler."""
    warm = {}
    for name, op in ops.items():
        t0 = time.perf_counter()
        op()
        warm[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    warm["end_to_end_ms"] = sum(warm.values())
    return warm, {}, {}


SMALL = {"gen_store_wide": 12_000, "gen_store": 12_000, "gen_catalog": 6_000, "gen_web": 4_000,
         "gen_store_returns": 4_000, "gen_channels": 6_000}


@pytest.fixture
def small_chip_plan(monkeypatch):
    cs = chip_smoke
    monkeypatch.setattr(cs, "PLAN_DEVICE", "cpu")
    monkeypatch.setattr(cs, "PLAN_ROWS", SMALL)
    monkeypatch.setattr(cs, "_warm_and_profile", _warm)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return cs


def test_chip_smoke_plan_checks_pass_on_the_cpu(small_chip_plan):
    cs = small_chip_plan
    wrappers = {"partition_map": hk.partition_map, "probe_paged": hk.probe_paged,
                "groupby_sum_outer": hk.groupby_sum_outer,
                "ragged_compact_many": hk.ragged_compact_many}
    entry, launches = cs._plan_phase(wrappers)
    assert launches == {k: 0 for k in wrappers}  # the CPU launches nothing
    assert len(entry["result_rows"]) == 27
    assert set(entry["oracle_rows"]) == set(cs.PLAN_ORACLES)
    assert all(r > 0 for r in entry["oracle_rows"].values())
    # the operator tier's single-key joins reach B4; B3 never (FLOAT64 sums)
    calls = entry["calls"]
    assert sum(c["probe_paged"] for c in calls.values()) > 0
    assert sum(c["groupby_sum_outer"] for c in calls.values()) == 0
    assert entry["checked"]["probe_paged"] == sum(c["probe_paged"] for c in calls.values())
    for name, c in entry["compile_ms"].items():
        assert c["compile_ms"] >= c["rewrite_ms"] + c["cbo_ms"] > 0, name
    assert all(r["memgov_admitted_bytes"] == 0 for r in entry["reports"].values())
    # var / std are the one FLOAT64 result outside the exact accumulator
    assert entry["float_sum_columns"] == {"q39": {"columns": ["std_q"], "max_rel_err": 0.0}}


def test_float_sum_columns_get_the_tolerance_and_no_more(small_chip_plan):
    cs = small_chip_plan
    from spark_rapids_jni_tpu_torch.models import tpcds_plans as tp

    tabs = tp.PLAN_QUERIES["q39"].gen(4000, device="cpu")
    cp, _ = cs._plan_compile(tp.PLAN_QUERIES["q39"].plan, tabs, "q39")
    assert cs._plan_float_sum_columns(cp) == {"std_q"}
    a, b = cp(), cp()
    col = a.column("std_q").data.view(torch.float64)
    col[0] = col[0] * (1 + 1e-12)
    assert 0 < cs._same_plan_result(a, b, "q39", {"std_q"}) < cs.PLAN_FLOAT_SUM_RTOL
    with pytest.raises(AssertionError, match="std_q differs"):
        cs._same_plan_result(a, b, "q39")
    col[0] = col[0] * (1 + 1e-6)
    with pytest.raises(AssertionError, match="beyond rtol"):
        cs._same_plan_result(a, b, "q39", {"std_q"})


def test_chip_smoke_plan_checks_catch_a_wrong_result(small_chip_plan):
    cs = small_chip_plan
    inputs = cs._plan_inputs("cpu")
    queries = {n: (p, g) for n, p, g, _, _ in cs._plan_queries()}
    for q in cs.PLAN_ORACLES:
        plan, g = queries[q]
        tabs = inputs[g][0]
        cp, parts = cs._plan_compile(plan, tabs, q)
        out = cp()
        h = cs._host_star(tabs)
        assert cs._check_plan_oracle(q, out, h) == out.num_rows
        col = out.columns[-1]
        col.data[0] += 1  # one value off: an integer by one, a float by one ulp
        with pytest.raises(AssertionError, match="numpy oracle"):
            cs._check_plan_oracle(q, out, h)
        other = cs._plan_compile(plan, tabs, q)[0]()
        with pytest.raises(AssertionError, match="differs"):
            cs._same_plan_result(out, other, q)
    pcp, want = cs._plan_ppart(inputs["gen_store_wide"][0])
    assert np.array_equal(pcp().column("p").data.numpy(), want)
