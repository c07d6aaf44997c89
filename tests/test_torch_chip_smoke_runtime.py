"""Port: chip_smoke.py's runtime path rehearsed on the CPU at a small size:
the boundary's cost, the armed runs of the fixed and join paths against
their disarmed runs (op calls, flight-recorder spans), the seeded
retryable and fatal faults and retry_with_split under a budget. The
profiler's ranges, the hang against a deadline and the real
out-of-memory need the card. No jax."""

import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
from spark_rapids_jni_tpu_torch.parallel import shuffle

ROWS = 4096


@pytest.fixture
def cs(monkeypatch):
    m = chip_smoke
    monkeypatch.setattr(m, "ROWS", ROWS)
    monkeypatch.setattr(m, "ORACLE_ROWS", 64)
    monkeypatch.setattr(m, "FACT_ROWS", 8192)
    monkeypatch.setattr(m, "DIM_ROWS", 1024)
    monkeypatch.setattr(m, "ITEM_DOMAIN", 2048)
    # a budget that splits the small batch as the card's splits the full one
    monkeypatch.setattr(m, "RUNTIME_SPLIT_BUDGET", ROWS * 792 * 3 // 8)
    monkeypatch.setattr(m, "_ranges_enclose", lambda run, expect: {"ranges": {}, "traces": 0})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return m


WRAPPERS = {"expand_u32_planes": rb.expand_u32_planes, "rows_to_planes": rb.rows_to_planes,
            "groupby_sum_outer": hk.groupby_sum_outer, "partition_map": hk.partition_map,
            "probe_paged": hk.probe_paged}


def test_runtime_fixed_rehearses_on_the_cpu(cs, monkeypatch):
    from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

    dtypes = cs._schema(pdt)
    layout = rc.compute_row_layout(dtypes)
    arrays, valids = cs._host_table(dtypes, ROWS, cs.SEED)
    table = Table.from_numpy(arrays, dtypes, valids, device="cpu")
    rows, dec, sums, counts, _ = cs._main_path(table, dtypes, key=0, value=1)
    cs._check_main_path(layout, arrays, valids, rows, dec, sums, counts)
    # on the CPU no wrapper launches: the launch check is the card's
    monkeypatch.setattr(cs, "FIXED_PATH_KERNELS", ())
    stats, launches = cs._runtime_fixed(WRAPPERS, table, dtypes, layout, rows, dec, sums, counts)
    assert stats["op_calls"] == {"convert_to_rows": 1, "convert_from_rows": 1}
    assert stats["spans"] == 2 and stats["sums_bit_identical"]
    assert stats["dispatch_tiers"] == {}  # the fixed schema has no STRING column
    assert 1 <= stats["retryable"]["fires"] == stats["retryable"]["predicted"] < 4
    assert stats["split"]["splits"] == 3 and stats["split"]["batches"] == 4
    assert set(launches.values()) == {0}


def test_runtime_join_rehearses_on_the_cpu(cs, monkeypatch):
    side = cs._join_inputs(cs.SEED + 2)
    (fa, fv), (da, dv) = side
    fact = Table(carry_table(fa, [cs._pdtype(pdt, t) for _, t in cs.FACT_COLS], fv,
                             device="cpu").columns, [n for n, _ in cs.FACT_COLS])
    dim = Table(carry_table(da, [cs._pdtype(pdt, t) for _, t in cs.DIM_COLS], dv,
                            device="cpu").columns, [n for n, _ in cs.DIM_COLS])
    part, offsets, joined, sums, counts, _ = cs._join_path(fact, dim)
    monkeypatch.setattr(cs, "JOIN_PATH_KERNELS", ())
    stats, _ = cs._runtime_join(WRAPPERS, fact, dim, part, offsets, joined, sums, counts)
    assert stats["op_calls"] == {"hash_partition": 1, "inner_join": 1}
    assert stats["dispatch_tiers"] == {"dispatch.tier.torch": 1}  # the join's note


def test_runtime_checks_catch_a_different_result(cs):
    t = Table.from_numpy([np.arange(8, dtype=np.int64)], [pdt.INT64], names=["k"], device="cpu")
    u = Table.from_numpy([np.arange(8, dtype=np.int64) + (np.arange(8) == 3)], [pdt.INT64],
                         device="cpu")
    assert cs._same_columns(t, t) and not cs._same_columns(t, u)
    with pytest.raises(AssertionError, match="tolerance"):
        cs._same_sums(torch.ones(4), torch.ones(4) * 2, "x")
    assert cs._split_plan(1_000_000, 792, 300 << 20, 3) == (3, 4)
    assert cs._split_plan(10, 1, 100, 3) == (0, 1)
    with pytest.raises(AssertionError, match="op calls"):
        cs._armed_run("x", lambda: shuffle.hash_partition(t, 2, ["k"]), {"inner_join": 1})


def test_boundary_cost_runs_on_the_cpu(cs):
    cost = cs._boundary_cost()
    assert set(cost) == {"bare_us", "disarmed_us", "armed_us"}
    assert 0 < cost["bare_us"] < cost["armed_us"]
