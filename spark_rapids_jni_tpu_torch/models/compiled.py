"""TPC-H q1 and q6 through the compiled-plan mechanism (port of the JAX
package's ``models/compiled.py``): each query a short ``PlanSpec`` run by
``CompiledPipeline``, the path a Spark stage takes when it is offloaded
whole. The results equal the operator tier's (``models/tpch.py``) bit for
bit: both compute one float64 product per expression node and sum
exactly.
"""

from __future__ import annotations

import numpy as np

from ..columnar import Table
from ..ops.expressions import col, lit
from ..pipeline import Agg, CompiledPipeline, GroupKey, PlanSpec, compile_plan
from .tpch import D_1998_12_01, _D_1994_01_01, _D_1995_01_01

__all__ = ["q6_fused", "q1_fused", "q6_pipeline", "q1_pipeline"]


def q6_pipeline() -> CompiledPipeline:
    """TPC-H q6: filter + masked revenue sum, no row materialized."""
    return compile_plan(
        PlanSpec(
            filter=(
                (col("l_shipdate") >= lit(np.int32(_D_1994_01_01)))
                & (col("l_shipdate") < lit(np.int32(_D_1995_01_01)))
                & (col("l_discount") >= lit(0.05))
                & (col("l_discount") <= lit(0.07))
                & (col("l_quantity") < lit(24.0))
            ),
            project=(("revenue", col("l_extendedprice") * col("l_discount")),),
            aggregates=(Agg("revenue", "sum"),),
        )
    )


_Q6 = None


def q6_fused(lineitem: Table) -> float:
    global _Q6
    if _Q6 is None:
        _Q6 = q6_pipeline()
    out = _Q6(lineitem)
    return float(out.column("revenue_sum").to_pylist()[0] or 0.0)


def q1_pipeline(delta_days: int = 90) -> CompiledPipeline:
    """TPC-H q1: filtered grouped sums and means over the 3 x 2 dictionary
    domain of (returnflag, linestatus): dense segments, no sort."""
    cutoff = D_1998_12_01 - delta_days
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = (col("l_extendedprice") * (lit(1.0) - col("l_discount"))) * (
        lit(1.0) + col("l_tax")
    )
    return compile_plan(
        PlanSpec(
            filter=col("l_shipdate") <= lit(np.int32(cutoff)),
            project=(("disc_price", disc_price), ("charge", charge)),
            group_by=(GroupKey("l_returnflag", 3), GroupKey("l_linestatus", 2)),
            aggregates=(
                Agg("l_quantity", "sum", "qty_sum"),
                Agg("l_extendedprice", "sum", "price_sum"),
                Agg("disc_price", "sum", "disc_price_sum"),
                Agg("charge", "sum", "charge_sum"),
                Agg("l_quantity", "mean", "qty_mean"),
                Agg("l_extendedprice", "mean", "price_mean"),
                Agg("l_discount", "mean", "disc_mean"),
                Agg("l_quantity", "count_all", "count"),
            ),
        )
    )


_Q1 = {}


def q1_fused(lineitem: Table, delta_days: int = 90):
    """TPC-H q1 through the pipeline. Returns a dict of [6] arrays ordered
    by (returnflag, linestatus), dense over the domain (empty groups
    zero-filled)."""
    pipe = _Q1.get(delta_days)
    if pipe is None:
        pipe = _Q1[delta_days] = q1_pipeline(delta_days)
    out = pipe(lineitem)
    rf = out.column("l_returnflag").to_numpy()
    ls = out.column("l_linestatus").to_numpy()
    slot = rf * 2 + ls
    res = {}
    for name in ("qty_sum", "price_sum", "disc_price_sum", "charge_sum",
                 "qty_mean", "price_mean", "disc_mean"):
        dense = np.zeros(6, np.float64)
        dense[slot] = [v or 0.0 for v in out.column(name).to_pylist()]
        res[name] = dense
    cnt = np.zeros(6, np.int64)
    cnt[slot] = out.column("count").to_pylist()
    res["count"] = cnt
    return res
