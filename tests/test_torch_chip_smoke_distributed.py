"""Port: chip_smoke.py's distributed path rehearsed on the CPU at a small
size (8 shards repeating the ``cpu`` device, ``DIST_DEVICE = "cpu"``): its
inputs, operations, numpy oracles and B1 routing prediction run as on the
card, and its checks catch a wrong result. No jax: the path's oracles are
numpy and the port's own single-chip queries."""

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


@pytest.fixture
def small_chip_dist(monkeypatch):
    cs = chip_smoke
    monkeypatch.setattr(cs, "DIST_DEVICE", "cpu")
    monkeypatch.setattr(cs, "DIST_ROWS", 8 * 2048)
    monkeypatch.setattr(cs, "FACT_ROWS", 8 * 2048)
    monkeypatch.setattr(cs, "DIM_ROWS", 8 * 256)
    monkeypatch.setattr(cs, "ITEM_DOMAIN", 4096)
    monkeypatch.setattr(cs, "TPCDS_ROWS", {"store10": 100, "web10": 12_000, "store1": 24_000,
                                           "web1": 100})
    monkeypatch.setattr(cs, "_warm_and_profile", _warm)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    stars = cs._tpcds_inputs(device="cpu")
    return cs, {s: stars[s] for _, s in cs.DIST_QUERIES}


def test_chip_smoke_distributed_checks_pass_on_the_cpu(small_chip_dist):
    cs, stars = small_chip_dist
    wrappers = {"partition_map": hk.partition_map, "probe_paged": hk.probe_paged}
    entry, launches = cs._dist_phase(wrappers, stars)
    assert launches == {"partition_map": 0, "probe_paged": 0}  # the CPU launches nothing
    calls = entry["b1_calls"]
    # the routing rule: one B1 call a shard for a single-key group-by, two
    # sides for a join, one call for exchange_by_key, none for composite
    # keys or the sort
    assert calls["groupby_sum"] == 8 and calls["groupby_sum_multi"] == 0
    assert calls["groupby_sum_one_shard_a_card"] == 1 and calls["exchange_by_key"] == 1
    assert calls["inner_join"] == 16 and calls["exchange_table"] == 8
    assert all(calls[k] == 0 for k in calls if k.startswith("sort"))
    assert all(entry["query_rows"][q] > 0 for q, _ in cs.DIST_QUERIES)
    assert entry["retry_capacity"] >= 8 * 2048 // 8 // cs.DIST_SPLIT


def test_chip_smoke_distributed_checks_catch_a_wrong_row(small_chip_dist):
    cs, stars = small_chip_dist
    dev = torch.device("cpu")
    from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
    from spark_rapids_jni_tpu_torch.parallel import shuffle

    mesh = pmesh.make_mesh({"data": 8}, devices=[dev] * 8)
    h, t, side, fact, dim = cs._dist_inputs(5, dev)
    (fa, fv), _ = side
    pairs, mask, _ = shuffle.exchange_by_key(pmesh.shard_table_rows(fact, mesh), ["item_sk"], mesh)
    dest = cs._np_partition(fa[1], fv[1], 8)
    cs._check_exchange(fa, fv, pairs, mask, dest, "exchange")
    data = pairs[4][0]  # ss_quantity
    first = int(np.flatnonzero(mask.reshape(-1).numpy())[0])
    data.reshape(-1)[first] += 1
    with pytest.raises(AssertionError, match="ss_quantity"):
        cs._check_exchange(fa, fv, pairs, mask, dest, "exchange")
    with pytest.raises(AssertionError, match="rows by shard"):
        cs._check_exchange(fa, fv, pairs, mask, (dest + 1) % 8, "exchange")
    # a query result one bit off is caught
    from spark_rapids_jni_tpu_torch.models import tpcds

    want = tpcds.q55(stars["store1"])
    cs._same_result(want, want, "q55")
    bad = tpcds.q55(stars["store1"])
    bad.columns[-1].data[0] ^= 1
    with pytest.raises(AssertionError, match="ext_price"):
        cs._same_result(bad, want, "q55")
    # the numpy routing hash is B1's
    keys = torch.from_numpy(h["keys"])
    assert np.array_equal(cs._np_pmod(cs._np_murmur([h["keys"]]), 8),
                          hk.partition_map_plain(keys, 8).numpy())
