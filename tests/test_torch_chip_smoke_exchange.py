"""Port: chip_smoke.py's exchange path rehearsed on the CPU at a small size
(``EXCHANGE_DEVICE = "cpu"``): (a) the in-process world of four ranks under
both plans against the numpy plans, with the B1 prediction, and (b) one
cross-process run of a two-rank world (one ``--device cpu`` worker) bit
for bit the single-host group-by. The chaos run of (b) needs four
processes: it runs on the card, and its steps on the CPU in
``tests/test_torch_cluster.py::TestClusterChaosFourRank``. No jax."""

import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

WRAPPERS = {"partition_map": hk.partition_map, "probe_paged": hk.probe_paged}


@pytest.fixture
def cs(monkeypatch):
    m = chip_smoke
    monkeypatch.setattr(m, "EXCHANGE_DEVICE", "cpu")
    monkeypatch.setattr(m, "FACT_ROWS", 8192)
    monkeypatch.setattr(m, "DIM_ROWS", 1024)
    monkeypatch.setattr(m, "ITEM_DOMAIN", 2048)
    monkeypatch.setattr(m, "EXCHANGE_ROWS", 6000)
    monkeypatch.setattr(m, "EXCHANGE_WARM", 1)
    monkeypatch.setattr(m, "_profile_phase", lambda run, top=8, watch=None: (run(), None)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    return m


def test_chip_smoke_exchange_in_process_world4_on_the_cpu(cs, monkeypatch):
    monkeypatch.setattr(cs, "EXCHANGE_FLEETS", ())
    entry, launches = cs._exchange_phase(WRAPPERS)
    assert launches == {"partition_map": 0, "probe_paged": 0}  # the CPU launches nothing
    assert entry["b1_calls"] == entry["b1_predicted"] == {"a_all_to_all": 4, "a_tree": 8}
    a = entry["in_process"]
    for plan in ("all_to_all", "tree"):
        # the frames' headers and CRCs ride on the dense rows that moved
        assert a[plan]["wire_bytes"] > a[plan]["dense_bytes_moved"] > 0
    # the tree forwards some rows twice
    assert a["tree"]["rows_moved"] > a["all_to_all"]["rows_moved"]
    assert entry["split"]["frames"] == 3 and entry["split"]["frame_bytes"] > 0


def test_chip_smoke_exchange_cross_process_world2_on_the_cpu(cs, monkeypatch):
    """The one run of (b) on the CPU: a two-rank world with a cluster, one
    ``--device cpu`` worker, two rounds."""
    monkeypatch.setattr(cs, "EXCHANGE_WORLD", 2)
    monkeypatch.setattr(cs, "EXCHANGE_FLEETS", (("cluster", True, 2, False),))
    entry, launches = cs._exchange_phase(WRAPPERS)
    assert entry["b1_calls"] == entry["b1_predicted"] == {"a_all_to_all": 2, "a_tree": 2,
                                                          "b_cluster": 2}
    b = entry["cross_process"]["cluster"]
    assert len(b["round_ms"]) == 2 and b["startup_s"] > 0
    assert b["counters"] == {"cluster.deaths": 0, "cluster.transitions": 0,
                             "cluster.recoveries": 0}


def test_chip_smoke_exchange_checks_catch_a_wrong_row(cs):
    from spark_rapids_jni_tpu_torch.columnar import Table
    from spark_rapids_jni_tpu_torch.ops.copying import gather

    dev = torch.device("cpu")
    fa, fv, table = cs._exchange_inputs(5, dev)
    names = list(table.names)
    dest = cs._np_partition(fa[1], fv[1], 4)
    want, moved = cs._np_exchange_plans(dest, 4)
    # the two plans deliver the same rows to each rank, in other orders
    for r in range(4):
        assert np.array_equal(np.sort(want["all_to_all"][r]), np.sort(want["tree"][r]))
        assert np.array_equal(np.sort(want["tree"][r]), np.flatnonzero(dest == r))
    rows = want["all_to_all"][1]
    got = gather(table, torch.from_numpy(rows))
    cs._check_exchanged(got, fa, fv, rows, names, "rank 1")
    with pytest.raises(AssertionError, match="another order"):
        cs._check_exchanged(gather(table, torch.from_numpy(rows[::-1].copy())), fa, fv, rows,
                            names, "rank 1")
    bad = Table([c for c in got.columns], names)
    bad.columns[4].data[0] += 1  # ss_quantity
    with pytest.raises(AssertionError, match="ss_quantity"):
        cs._check_exchanged(bad, fa, fv, rows, names, "rank 1")
    other = rows.copy()
    other[0] = want["all_to_all"][2][0]  # a row of rank 2's
    with pytest.raises(AssertionError, match="not the rows routed here"):
        cs._check_exchanged(got, fa, fv, other, names, "rank 1")
