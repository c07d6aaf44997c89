"""Port: the plan tier's distributed run (``TestDistributedPlanQuery`` of
``tests/test_cluster.py``). The q55 plan with exchange stages runs on a
4-rank fabric of port exchanges with rank 1 dead: unbound, the plan is its
own single-host oracle; each live rank aggregates its key partition under
an exchange binding; the dead rank's exchange input is replayed from the
lineage the stage installed; the coordinator rebuilds the destination
side's hole; and ``merge_partials`` re-applies the plan's total-order
sort. The merged result is held bit for bit to the port's oracle and to
the JAX package's single-host q55 on the same seeded tables."""

import threading

import numpy as np

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu import plan as RP
from spark_rapids_jni_tpu.models import tpcds as rtpcds, tpcds_plans as rtp
from spark_rapids_jni_tpu_torch import plan as P
from spark_rapids_jni_tpu_torch.models import tpcds, tpcds_plans as tp
from spark_rapids_jni_tpu_torch.ops.copying import slice_table
from spark_rapids_jni_tpu_torch.parallel import shuffle
from spark_rapids_jni_tpu_torch.parallel.cluster import ClusterView
from spark_rapids_jni_tpu_torch.plan import nodes as pn
from spark_rapids_jni_tpu_torch.plan.distribute import merge_partials
from spark_rapids_jni_tpu_torch.utils import metrics, retry


def _counter(name):
    return metrics.registry().counter(name).value


def test_q55x4_bit_identical_with_dead_rank():
    world, rows = 4, 8000
    tables = tpcds.gen_store(rows, seed=12, device="cpu")
    plan = P.insert_exchanges(tp.q55_plan(), world)
    sort_keys = (("ext_price", False), ("i_brand_id", True))
    ref = P.compile_ir(plan, tables, name="q55x4-oracle")()
    assert ref.num_rows > 0
    jref = RP.compile_ir(RP.insert_exchanges(rtp.q55_plan(), world),
                         rtpcds.gen_store(rows, seed=12), name="q55x4-jax")()

    fact_rows = tables["store_sales"].num_rows

    def shard_tables(r):
        lo, hi = shuffle._shard_bounds(fact_rows, world, r)
        return {"store_sales": slice_table(tables["store_sales"], lo, hi),
                "date_dim": tables["date_dim"], "item": tables["item"]}

    exs = {r: shuffle.TcpExchange(r, device="cpu") for r in (0, 2, 3)}
    addrs = {r: (exs[r].address if r in exs else "127.0.0.1:9") for r in range(world)}
    kw = dict(heartbeat_s=0.05, heartbeat_timeout_s=0.2, suspect_misses=1, dead_misses=2)
    views = {r: ClusterView(r, addrs, exs[r], **kw) for r in exs}
    recov0 = _counter("cluster.recoveries")
    res, errs = {}, []

    def run_rank(rank):
        try:
            peers = {r: a for r, a in addrs.items() if r != rank}
            with P.exchange_context(exs[rank], peers, cluster=views[rank],
                                    shard_tables=shard_tables), \
                    retry.enabled(max_attempts=20, base_delay_ms=5, max_delay_ms=50):
                res[rank] = P.compile_ir(plan, shard_tables(rank), name=f"q55x4-r{rank}")()
        except BaseException as e:  # surfaced below
            errs.append(e)

    try:
        for v in views.values():
            v.start()
        threads = [threading.Thread(target=run_rank, args=(r,)) for r in exs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errs, errs
        assert set(res) == set(exs)
        # the destination-side hole: rank 1's key partition, rebuilt from
        # the lineage the exchange stage installed on rank 0's view
        hole = views[0].recompute_dead_partition(1, ["i_brand_id"], world)
        res[1] = P.compile_ir(
            pn.Aggregate(pn.Scan("hole"), keys=("i_brand_id",),
                         aggs=(pn.AggSpec("ss_ext_sales_price", "sum", "ext_price"),)),
            {"hole": hole}, name="q55x4-hole")()
        got = merge_partials([res[r] for r in range(world)], sort_keys)
        assert got.num_rows == ref.num_rows == jref.num_rows
        for name in ("i_brand_id", "ext_price"):
            g = got.column(name).to_numpy()
            assert np.array_equal(g, ref.column(name).to_numpy()), name
            assert np.array_equal(g, np.asarray(jref.column(name).data)), name
        for v in views.values():
            assert v.dead_ranks() == [1]
            assert v.generation() == 2
        assert _counter("cluster.recoveries") >= recov0 + 1
    finally:
        for v in views.values():
            v.stop()
        for ex in exs.values():
            ex.close()
