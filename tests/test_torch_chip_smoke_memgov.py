"""Port: chip_smoke.py's memgov path rehearsed on the CPU at a small size
(``MEMGOV_DEVICE = "cpu"``): the world-4 q55 with three CPU worker
processes, both out-of-core runs, the spilled build table, the caches
and the xgboost bridge run as on the card, making the inputs a full run
reuses, and their checks catch a wrong result. No jax."""

import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk


@pytest.fixture
def small_chip_memgov(monkeypatch):
    cs = chip_smoke
    monkeypatch.setattr(cs, "MEMGOV_DEVICE", "cpu")
    monkeypatch.setattr(cs, "PLAN_ROWS", {**cs.PLAN_ROWS, "gen_store": 12_000,
                                          "gen_store_wide": 12_000})
    monkeypatch.setattr(cs, "LINEITEM_ROWS", 6_000)
    monkeypatch.setattr(cs, "CRITEO_ROWS", 20_000)
    monkeypatch.setattr(cs, "FACT_ROWS", 8_192)
    monkeypatch.setattr(cs, "DIM_ROWS", 1_024)
    monkeypatch.setattr(cs, "ITEM_DOMAIN", 2_048)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    return cs


def test_chip_smoke_memgov_checks_pass_on_the_cpu(small_chip_memgov):
    cs = small_chip_memgov
    wrappers = {"partition_map": hk.partition_map, "probe_paged": hk.probe_paged,
                "groupby_sum_outer": hk.groupby_sum_outer}
    entry, launches = cs._memgov_phase(wrappers, {})
    assert launches == {k: 0 for k in wrappers}  # the CPU launches nothing
    assert entry["made_here"] == ["lineitem", "gen_store", "gen_store_wide", "q55_plan", "join"]
    a = entry["a_q55_world4"]
    assert a["world"] == 4 and a["result_rows"] > 0 and len(a["partial_rows"]) == 4
    # B1 partitions the one-key out-of-core plan (and, at the card's size,
    # rank 0's exchange: here its shard keeps no q55 row)
    one = entry["b_ooc_one_key"]
    assert one["keys"] == ["ss_item_sk"] and one["held"]["checked"]["partition_map"] > 0
    q1 = entry["b_ooc_q1"]
    assert q1["keys"] == ["l_returnflag", "l_linestatus"] and q1["partitions"] >= 2
    assert q1["held"]["checked"]["partition_map"] == 0  # two INT8 keys: no B1
    for b in (q1, one):
        assert b["spills"] > 0 and b["budget_bytes"] == b["est_bytes"] // 4
    c = entry["c_spilled_builds"]
    assert c["build_rows"] == 1_024 and c["build_bytes"] > 0
    d = entry["d_caches"]
    assert d["counters"]["misses"] == 1 and d["counters"]["rebinds"] == 1
    assert d["counters"]["sub_hits"] >= 1
    e = entry["e_xgboost_bridge"]
    assert (e["rows"], e["features"], e["max_bins"]) == (20_000, 39, 256)
    assert 0 < e["missing_fraction"] < 1


def test_chip_smoke_memgov_checks_catch_a_wrong_result(small_chip_memgov, monkeypatch):
    cs = small_chip_memgov
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.models import tpcds

    tables = {"store_sales": tpcds.gen_store(12_000, seed=42, device="cpu")["store_sales"]}
    ir = P.Sort(P.Aggregate(P.Scan("store_sales"), keys=("ss_item_sk",),
                            aggs=(P.AggSpec("ss_ext_sales_price", "sum", "r"),)),
                keys=(("ss_item_sk", True),))
    real = P.OutOfCorePlan.__call__

    def off_by_one(self):
        out = real(self)
        out.columns[-1].data[0] += 1
        return out

    monkeypatch.setattr(P.OutOfCorePlan, "__call__", off_by_one)
    with pytest.raises(AssertionError, match="out of core against in core"):
        cs._memgov_ooc(ir, tables, "wrong")
    monkeypatch.setattr(P.OutOfCorePlan, "__call__", real)
    from spark_rapids_jni_tpu_torch.models import xgboost_bridge as xb

    real_q = xb.quantize
    calls = []

    def skewed(features, cuts):
        ids = real_q(features, cuts)
        calls.append(1)
        if len(calls) == 1:  # the first (the "card") run only
            ids[0, 0] += 1
        return ids

    monkeypatch.setattr(xb, "quantize", skewed)
    with pytest.raises(AssertionError, match="differ from the CPU run"):
        cs._memgov_bridge(2_000)
    assert np.isfinite(cs.CRITEO_BINS)
