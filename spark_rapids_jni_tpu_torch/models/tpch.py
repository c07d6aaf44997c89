"""TPC-H q1 and q6 on the operator tier (port of the JAX package's
``models/tpch.py``, BASELINE.json configs[1]): scan, filter, expressions
and a sort-based group aggregate, no join.

Data: a deterministic ``lineitem`` generator at a row count. Flag columns
are dictionary codes (INT8: l_returnflag 0='A', 1='N', 2='R';
l_linestatus 0='F', 1='O'), dates TIMESTAMP_DAYS since 1992-01-01, money
columns FLOAT64 (IEEE bits in int64 lanes). Each query runs eagerly:
``evaluate`` the predicate -> ``apply_boolean_mask`` (one host sync for
the row count) -> ``evaluate`` the projections -> ``groupby_aggregate``,
whose FLOAT64 sums and means are exact (``ops/f64acc``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..ops import copying
from ..ops.aggregate import groupby_aggregate
from ..ops.expressions import col, lit
from .datagen import Profile, create_random_table

__all__ = ["gen_lineitem", "q1", "q6"]

_LINEITEM_SCHEMA = [
    ("l_quantity", dt.FLOAT64, Profile(lower=1, upper=50)),
    ("l_extendedprice", dt.FLOAT64, Profile(lower=900, upper=105_000)),
    ("l_discount", dt.FLOAT64, Profile(lower=0.0, upper=0.1)),
    ("l_tax", dt.FLOAT64, Profile(lower=0.0, upper=0.08)),
    ("l_returnflag", dt.INT8, Profile(lower=0, upper=2)),
    ("l_linestatus", dt.INT8, Profile(lower=0, upper=1)),
    # days since 1992-01-01; TPC-H dates span 1992-01-01..1998-12-31 (~2557d)
    ("l_shipdate", dt.TIMESTAMP_DAYS, Profile(lower=0, upper=2557)),
]


def gen_lineitem(num_rows: int, seed: int = 42, device=None) -> Table:
    """The lineitem table, bit for bit the JAX package's for the same
    (num_rows, seed); ``device=None`` means the card."""
    names = [n for n, _, _ in _LINEITEM_SCHEMA]
    dtypes = [d for _, d, _ in _LINEITEM_SCHEMA]
    profiles = {i: p for i, (_, _, p) in enumerate(_LINEITEM_SCHEMA)}
    return create_random_table(dtypes, num_rows, seed=seed, profiles=profiles, names=names,
                               device=device)


# TPC-H dates as days since 1992-01-01 (the generator's epoch)
D_1998_12_01 = 2526
_D_1994_01_01 = 731
_D_1995_01_01 = 1096


def q1(lineitem: Table, delta_days: int = 90) -> Table:
    """Pricing summary report. SQL:

        SELECT l_returnflag, l_linestatus, sum(qty), sum(price),
               sum(price*(1-disc)), sum(price*(1-disc)*(1+tax)),
               avg(qty), avg(price), avg(disc), count(*)
        FROM lineitem WHERE l_shipdate <= date '1998-12-01' - delta days
        GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2
    """
    cutoff = D_1998_12_01 - delta_days
    pred = (col("l_shipdate") <= lit(np.int32(cutoff))).evaluate(lineitem)
    t = copying.apply_boolean_mask(lineitem, pred)

    disc_price = (col("l_extendedprice") * (lit(1.0) - col("l_discount"))).evaluate(t)
    charge = (
        col("l_extendedprice") * (lit(1.0) - col("l_discount")) * (lit(1.0) + col("l_tax"))
    ).evaluate(t)
    values = Table(
        [t.column("l_quantity"), t.column("l_extendedprice"), disc_price, charge,
         t.column("l_discount")],
        ["qty", "price", "disc_price", "charge", "disc"],
    )
    keys = t.select(["l_returnflag", "l_linestatus"])
    # key-sorted rows == ORDER BY 1, 2
    return groupby_aggregate(
        keys,
        values,
        [
            ("qty", "sum"),
            ("price", "sum"),
            ("disc_price", "sum"),
            ("charge", "sum"),
            ("qty", "mean"),
            ("price", "mean"),
            ("disc", "mean"),
            ("qty", "count_all"),
        ],
    )


def q6(lineitem: Table) -> float:
    """Forecasting revenue change. SQL:

        SELECT sum(l_extendedprice * l_discount) FROM lineitem
        WHERE l_shipdate >= date '1994-01-01'
          AND l_shipdate < date '1995-01-01'
          AND l_discount BETWEEN 0.05 AND 0.07
          AND l_quantity < 24

    Returns the scalar revenue (the exact sum's float64, read from its bits).
    """
    pred = (
        (col("l_shipdate") >= lit(np.int32(_D_1994_01_01)))
        & (col("l_shipdate") < lit(np.int32(_D_1995_01_01)))
        & (col("l_discount") >= lit(0.05))
        & (col("l_discount") <= lit(0.07))
        & (col("l_quantity") < lit(24.0))
    ).evaluate(lineitem)
    t = copying.apply_boolean_mask(lineitem, pred)
    revenue = (col("l_extendedprice") * col("l_discount")).evaluate(t)
    # single-group aggregate: a constant key
    key = Table([Column(dt.INT8, data=torch.zeros((t.num_rows,), dtype=torch.int8,
                                                  device=revenue.device))], ["g"])
    out = groupby_aggregate(key, Table([revenue], ["revenue"]), [("revenue", "sum")])
    if out.num_rows == 0:
        return 0.0
    return float(out.column("revenue_sum").data[:1].cpu().numpy().view(np.float64)[0])
