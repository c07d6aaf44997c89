"""TPC-H ``lineitem`` (the seven columns q1 reads) and q1, in plain numpy.

The generator follows the rules of the TPC-H specification (v3.0.1,
4.2.3) for the columns q1 reads, from one
``numpy.random.default_rng(seed)``: orders of 1 to 7 lines, each order's
date uniform from 1992-01-01 to 1998-08-02 (ENDDATE less 151 days);
a line's quantity an integer 1-50, its part key 1 to 200,000 x SF, its
extended price the quantity times that part's retail price (to the
cent), its discount k/100 for k in 0-10 and its tax k/100 for k in 0-8;
its ship date the order's date plus 1-121 days, its receipt date the
ship date plus 1-30; its return flag R or A at random where the receipt
date is on or before CURRENTDATE (1995-06-17), else N; its line status O
where the ship date is after CURRENTDATE, else F. So q1 finds the
specification's four skewed groups (A-F, N-F at about 1%, N-O, R-F).
The lines are the orders' lines in order, cut at the table's row count.
Flags are dictionary codes (l_returnflag 0='A', 1='N', 2='R';
l_linestatus 0='F', 1='O'), dates days since 1992-01-01, the decimal
columns the nearest float64 of their exact values.

``q1_exact`` is the query with every sum and mean the nearest float64 of
the exact rational result, and the row products float64 products, one
rounding an operator (Spark's ``sum(double)`` and ``avg(double)`` on
exact accumulation). ``q1_lower`` is the same query computed in a lower
precision: the control that has to fail the comparison.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Tuple

import numpy as np
import torch

# (name, storage dtype) of the columns the generator makes
LINEITEM = (
    ("l_quantity", np.float64),
    ("l_extendedprice", np.float64),
    ("l_discount", np.float64),
    ("l_tax", np.float64),
    ("l_returnflag", np.int8),
    ("l_linestatus", np.int8),
    ("l_shipdate", np.int32),
)

# days since 1992-01-01 (STARTDATE)
D_1995_06_17 = 1263  # CURRENTDATE
D_1998_08_02 = 2405  # ENDDATE (1998-12-31) less 151 days: the last order date
D_1998_12_01 = 2526
PARTS_PER_SF = 200_000
LINES_PER_ORDER = (1, 7)
SLOTS = 6  # returnflag * 2 + linestatus over 3 x 2 codes; the data fills 4
SUMS = (("qty_sum", "l_quantity"), ("price_sum", "l_extendedprice"),
        ("disc_price_sum", "disc_price"), ("charge_sum", "charge"))
MEANS = (("qty_mean", "l_quantity"), ("price_mean", "l_extendedprice"),
         ("disc_mean", "l_discount"))


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents: 90000 + ((key / 10) mod 20001) + 100 (key mod 1000)."""
    return 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)


def gen_lineitem(n: int, seed: int, scale_factor: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lo, hi = LINES_PER_ORDER
    lines = np.zeros(0, np.int64)
    while lines.sum() < n:  # enough orders to hold n lines (about n / 4)
        lines = np.concatenate([lines, rng.integers(lo, hi, n // 4 + n // 64 + 8, endpoint=True)])
    orders = int(np.searchsorted(np.cumsum(lines), n)) + 1
    order_date = rng.integers(0, D_1998_08_02, orders, endpoint=True)
    order_date = np.repeat(order_date, lines[:orders])[:n]
    partkey = rng.integers(1, PARTS_PER_SF * scale_factor, n, endpoint=True)
    qty = rng.integers(1, 50, n, endpoint=True)
    discount = rng.integers(0, 10, n, endpoint=True)
    tax = rng.integers(0, 8, n, endpoint=True)
    ship = order_date + rng.integers(1, 121, n, endpoint=True)
    receipt = ship + rng.integers(1, 30, n, endpoint=True)
    returned = rng.integers(0, 1, n, endpoint=True)  # R (1) or A (0) where received
    return {
        "l_quantity": qty.astype(np.float64),
        "l_extendedprice": (qty * retail_price_cents(partkey)) / 100.0,
        "l_discount": discount / 100.0,
        "l_tax": tax / 100.0,
        "l_returnflag": np.where(receipt <= D_1995_06_17, 2 * returned, 1).astype(np.int8),
        "l_linestatus": (ship > D_1995_06_17).astype(np.int8),
        "l_shipdate": ship.astype(np.int32),
    }


def _kept(h: Dict[str, np.ndarray], delta_days: int):
    keep = h["l_shipdate"] <= D_1998_12_01 - delta_days
    grp = (h["l_returnflag"].astype(np.int64) * 2 + h["l_linestatus"])[keep]
    return keep, grp


def exact_sums(x: np.ndarray, group: np.ndarray, num: int):
    """Exact per-group sums of float64 values as Python integers over a
    common power of two: each value is an integer mantissa times 2^e; the
    mantissas, split into 27-bit halves so that every float64 partial sum
    stays an exact integer below 2^53, are summed per (group, e) and
    combined in Python integers. Returns ([num] numerators, exponent)."""
    m, e = np.frexp(x)
    mi = (m * 2.0**53).astype(np.int64)
    e = e.astype(np.int64) - 53
    e0 = int(e.min()) if e.size else 0
    es = np.unique(e)
    key = group * es.shape[0] + np.searchsorted(es, e)
    hi = np.bincount(key, weights=(mi >> 27).astype(np.float64), minlength=num * es.shape[0])
    lo = np.bincount(key, weights=(mi & ((1 << 27) - 1)).astype(np.float64),
                     minlength=num * es.shape[0])
    out = [0] * num
    for g in range(num):
        for j, ej in enumerate(es):
            k = g * es.shape[0] + j
            out[g] += ((int(hi[k]) << 27) + int(lo[k])) << int(ej - e0)
    return out, e0


def nearest(num: int, e0: int, den: int = 1) -> float:
    """The float64 nearest to num * 2^e0 / den."""
    return float(Fraction(num * 2 ** max(e0, 0), den * 2 ** max(-e0, 0)))


def q1_exact(h: Dict[str, np.ndarray], delta_days: int = 90) -> Tuple[dict, int]:
    """q1 dense over the 6 slots (slot = returnflag * 2 + linestatus):
    ({output name: [6] float64 or int64}, kept rows)."""
    keep, grp = _kept(h, delta_days)
    cols = {k: h[k][keep] for k in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    cols["disc_price"] = cols["l_extendedprice"] * (1.0 - cols["l_discount"])
    cols["charge"] = cols["l_extendedprice"] * (1.0 - cols["l_discount"]) * (1.0 + cols["l_tax"])
    count = np.bincount(grp, minlength=SLOTS).astype(np.int64)
    out = {"count": count}
    for name, src in SUMS:
        nums, e0 = exact_sums(cols[src], grp, SLOTS)
        out[name] = np.array([nearest(v, e0) for v in nums])
    for name, src in MEANS:
        nums, e0 = exact_sums(cols[src], grp, SLOTS)
        out[name] = np.array([nearest(v, e0, int(c)) if c else 0.0 for v, c in zip(nums, count)])
    return out, int(keep.sum())


def q1_lower(h: Dict[str, np.ndarray], dtype: torch.dtype, device, delta_days: int = 90
             ) -> Tuple[dict, int]:
    """q1 as ``q1_exact`` shapes it, with every value, product, sum and
    mean computed in ``dtype`` on ``device``."""
    keep, grp = _kept(h, delta_days)
    g = torch.from_numpy(grp).to(device)
    cols = {k: torch.from_numpy(h[k][keep]).to(device).to(dtype)
            for k in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    cols["disc_price"] = cols["l_extendedprice"] * (1.0 - cols["l_discount"])
    cols["charge"] = cols["l_extendedprice"] * (1.0 - cols["l_discount"]) * (1.0 + cols["l_tax"])
    count = torch.bincount(g, minlength=SLOTS)
    out = {"count": count.cpu().numpy().astype(np.int64)}
    for name, src in SUMS + MEANS:
        s = torch.zeros(SLOTS, dtype=dtype, device=device).index_add_(0, g, cols[src])
        if name.endswith("_mean"):
            s = s / count.clamp_min(1).to(dtype)
        out[name] = s.to(torch.float64).cpu().numpy()
    return out, int(keep.sum())
