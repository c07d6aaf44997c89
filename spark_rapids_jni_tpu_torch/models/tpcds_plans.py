"""TPC-DS queries expressed as LOGICAL PLANS (port of the JAX package's
``models/tpcds_plans.py``: the same generators, seeds and rows for a
seed, the same plans; the generators take ``device=``, None the card).

Every query here was a QUERIES.md "lowers" entry — operator surface
present, assembly missing — and goes green through the plan compiler
ALONE: the function builds an IR tree that transliterates the SQL, and
``plan.compile_ir`` performs the rewrites (decorrelation, ROLLUP
expansion, set-op/EXISTS/HAVING lowering, pushdown) plus the fused
``CompiledPipeline`` lowering that the hand-built greens in
``models/tpcds.py`` encode by hand. Dictionary-coded int lanes stand in
for string dimension values, as everywhere in this tier; parameter
defaults are calibrated to the generators here, not to the spec's
literals — the RELATIONAL SHAPE (which joins, which rewrites, which
aggregates) is the part under test against pandas oracles.

Two hand-built greens (q3, q55) are also re-expressed as plans
(``q3_plan`` / ``q55_plan``): the compiler must reproduce their fused
pipelines' outputs BIT-identically (tests/test_plan_queries.py pins
it), which is the evidence the mechanical lowering matches the
hand-fused originals.

``PLAN_QUERIES`` is the registry the tests, the ledger, and the
ci/premerge.sh compiler tier iterate: name -> (generator, plan builder,
runner, default rows).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from .. import plan as P
from ..columnar import Table
from ..columnar import dtype as dt
from ..columnar.column import resolve_device
from .tpcds import _f64_col, _int_col, gen_store_wide, gen_web

__all__ = [
    "gen_store_returns", "gen_catalog", "gen_channels",
    "q1", "q8", "q9", "q10", "q13", "q15", "q20", "q26", "q27", "q28",
    "q30", "q32", "q34", "q35", "q38", "q39", "q43", "q48", "q65", "q69",
    "q73", "q87", "q88", "q92", "q96", "q3_plan", "q55_plan",
    "PLAN_QUERIES", "PlanQueryDef",
]


# ---------------------------------------------------------------------------
# generators (star schemas the gen_store/gen_web family does not cover)
# ---------------------------------------------------------------------------


def gen_store_returns(num_returns: int, seed: int = 21, device=None) -> Dict[str, Table]:
    """store_returns + date_dim + store + customer for the q1 family
    (per-customer return totals vs the per-store average)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_dates, n_store, n_cust = 365 * 3, 12, 1500
    date_dim = Table(
        [_int_col(np.arange(n_dates), dev), _int_col(1998 + np.arange(n_dates) // 365, dev)],
        ["d_date_sk", "d_year"],
    )
    store = Table(
        [_int_col(np.arange(n_store), dev), _int_col(rng.integers(0, 8, n_store), dev)],
        ["s_store_sk", "s_state"],
    )
    customer = Table(
        [_int_col(np.arange(n_cust), dev), _int_col(rng.permutation(n_cust), dev)],
        ["c_customer_sk", "c_customer_id"],
    )
    store_returns = Table(
        [
            _int_col(rng.integers(0, n_dates, num_returns), dev),  # sr_returned_date_sk
            _int_col(rng.integers(0, n_cust, num_returns), dev),  # sr_customer_sk
            _int_col(rng.integers(0, n_store, num_returns), dev),  # sr_store_sk
            _f64_col(rng.uniform(1, 500, num_returns).round(2), dev),  # sr_return_amt
        ],
        ["sr_returned_date_sk", "sr_customer_sk", "sr_store_sk", "sr_return_amt"],
    )
    return {"store_returns": store_returns, "date_dim": date_dim,
            "store": store, "customer": customer}


def gen_catalog(num_sales: int, seed: int = 23, device=None) -> Dict[str, Table]:
    """catalog_sales star for the q26 (q7 catalog twin) and q20
    (partition-ratio reporting) shapes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_dates, n_items, n_cdemo, n_promo = 365 * 5, 800, 150, 40
    date_dim = Table(
        [
            _int_col(np.arange(n_dates), dev),
            _int_col(1998 + np.arange(n_dates) // 365, dev),
            _int_col(1 + (np.arange(n_dates) % 365) // 31, dev),
        ],
        ["d_date_sk", "d_year", "d_moy"],
    )
    item = Table(
        [
            _int_col(np.arange(n_items), dev),  # i_item_sk
            _int_col(rng.permutation(n_items), dev),  # i_item_id
            _int_col(rng.integers(1, 11, n_items), dev),  # i_category_id
            _int_col(rng.integers(1, 30, n_items), dev),  # i_class_id
        ],
        ["i_item_sk", "i_item_id", "i_category_id", "i_class_id"],
    )
    customer_demographics = Table(
        [
            _int_col(np.arange(n_cdemo), dev),
            _int_col(rng.integers(0, 2, n_cdemo), dev),  # cd_gender
            _int_col(rng.integers(0, 5, n_cdemo), dev),  # cd_marital_status
            _int_col(rng.integers(0, 7, n_cdemo), dev),  # cd_education_status
        ],
        ["cd_demo_sk", "cd_gender", "cd_marital_status", "cd_education_status"],
    )
    promotion = Table(
        [
            _int_col(np.arange(n_promo), dev),
            _int_col(rng.integers(0, 2, n_promo), dev),  # p_channel_email
            _int_col(rng.integers(0, 2, n_promo), dev),  # p_channel_event
        ],
        ["p_promo_sk", "p_channel_email", "p_channel_event"],
    )
    catalog_sales = Table(
        [
            _int_col(rng.integers(0, n_dates, num_sales), dev),  # cs_sold_date_sk
            _int_col(rng.integers(0, n_items, num_sales), dev),  # cs_item_sk
            _int_col(rng.integers(0, n_cdemo, num_sales), dev),  # cs_bill_cdemo_sk
            _int_col(rng.integers(0, n_promo, num_sales), dev),  # cs_promo_sk
            _int_col(rng.integers(1, 100, num_sales), dev),  # cs_quantity
            _f64_col(rng.uniform(1, 200, num_sales).round(2), dev),  # cs_list_price
            _f64_col(rng.uniform(0, 50, num_sales).round(2), dev),  # cs_coupon_amt
            _f64_col(rng.uniform(1, 150, num_sales).round(2), dev),  # cs_sales_price
            _f64_col(rng.uniform(1, 1000, num_sales).round(2), dev),  # cs_ext_sales_price
        ],
        [
            "cs_sold_date_sk", "cs_item_sk", "cs_bill_cdemo_sk", "cs_promo_sk",
            "cs_quantity", "cs_list_price", "cs_coupon_amt", "cs_sales_price",
            "cs_ext_sales_price",
        ],
    )
    return {"catalog_sales": catalog_sales, "date_dim": date_dim, "item": item,
            "customer_demographics": customer_demographics, "promotion": promotion}


def gen_channels(num_rows: int, seed: int = 29, device=None) -> Dict[str, Table]:
    """Three sales channels sharing one customer population — the
    INTERSECT/EXCEPT (q38/q87) and EXISTS/NOT-EXISTS (q69) families."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_dates, n_cust, n_cdemo, n_addr = 365 * 3, 1200, 120, 300
    date_dim = Table(
        [
            _int_col(np.arange(n_dates), dev),
            _int_col(1998 + np.arange(n_dates) // 365, dev),
            _int_col(1 + (np.arange(n_dates) % 365) // 31, dev),
        ],
        ["d_date_sk", "d_year", "d_moy"],
    )
    customer = Table(
        [
            _int_col(np.arange(n_cust), dev),
            _int_col(rng.permutation(n_cust), dev),  # c_customer_id
            _int_col(rng.integers(0, n_cdemo, n_cust), dev),  # c_current_cdemo_sk
            _int_col(rng.integers(0, n_addr, n_cust), dev),  # c_current_addr_sk
        ],
        ["c_customer_sk", "c_customer_id", "c_current_cdemo_sk", "c_current_addr_sk"],
    )
    customer_address = Table(
        [_int_col(np.arange(n_addr), dev), _int_col(rng.integers(0, 10, n_addr), dev)],
        ["ca_address_sk", "ca_state"],
    )
    customer_demographics = Table(
        [
            _int_col(np.arange(n_cdemo), dev),
            _int_col(rng.integers(0, 2, n_cdemo), dev),  # cd_gender
            _int_col(rng.integers(0, 5, n_cdemo), dev),  # cd_marital_status
            _int_col(rng.integers(0, 7, n_cdemo), dev),  # cd_education_status
        ],
        ["cd_demo_sk", "cd_gender", "cd_marital_status", "cd_education_status"],
    )

    def fact(cust_col: str, date_col: str, n: int) -> Table:
        return Table(
            [_int_col(rng.integers(0, n_cust, n), dev), _int_col(rng.integers(0, n_dates, n), dev)],
            [cust_col, date_col],
        )

    tables = {
        "date_dim": date_dim,
        "customer": customer,
        "customer_address": customer_address,
        "customer_demographics": customer_demographics,
        "store_sales": fact("ss_customer_sk", "ss_sold_date_sk", num_rows),
        "web_sales": fact("ws_bill_customer_sk", "ws_sold_date_sk", max(num_rows // 2, 1)),
        "catalog_sales": fact("cs_ship_customer_sk", "cs_sold_date_sk", max(num_rows // 2, 1)),
    }
    # extension — the q35 dependent-count lane is
    # drawn AFTER every pre-existing draw (the gen_store_wide append
    # pattern), so the original columns' random sequences are untouched.
    tables["customer_demographics"] = Table(
        list(customer_demographics.columns)
        + [_int_col(rng.integers(0, 10, n_cdemo), dev)],  # cd_dep_count
        list(customer_demographics.names) + ["cd_dep_count"],
    )
    return tables


# ---------------------------------------------------------------------------
# plan builders + runners
# ---------------------------------------------------------------------------


def _run(plan: P.Node, tables: Dict[str, Table], name: str) -> Table:
    return P.compile_ir(plan, tables, name=name)()


def q1_plan(year: int = 1998, state: int = 3) -> P.Node:
    """TPC-DS q1 — the flagship decorrelation shape. SQL:

        WITH customer_total_return AS (
          SELECT sr_customer_sk, sr_store_sk,
                 sum(sr_return_amt) ctr_total_return
          FROM store_returns, date_dim
          WHERE sr_returned_date_sk = d_date_sk AND d_year = :yr
          GROUP BY sr_customer_sk, sr_store_sk)
        SELECT c_customer_id
        FROM customer_total_return ctr1, store, customer
        WHERE ctr1.ctr_total_return >
              (SELECT avg(ctr_total_return) * 1.2
               FROM customer_total_return ctr2
               WHERE ctr1.sr_store_sk = ctr2.sr_store_sk)
          AND s_store_sk = ctr1.sr_store_sk AND s_state = :state
          AND ctr1.sr_customer_sk = c_customer_sk
        ORDER BY c_customer_id LIMIT 100

    The CTE is ONE shared node used twice (the compiler evaluates it
    once); the correlated average decorrelates to agg + join."""
    ctr = P.Aggregate(
        P.Join(
            P.Scan("store_returns"),
            P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
            on=(("sr_returned_date_sk", "d_date_sk"),), bounded=True,
        ),
        keys=("sr_customer_sk", "sr_store_sk"),
        aggs=(P.AggSpec("sr_return_amt", "sum", "ctr_total_return"),),
    )
    x = P.CorrelatedAggFilter(
        ctr, ctr, on=("sr_store_sk", "sr_store_sk"),
        agg=P.AggSpec("ctr_total_return", "mean", "ctr_avg"),
        predicate=P.pcol("ctr_total_return") > P.pcol("ctr_avg") * P.plit(1.2),
    )
    x = P.Join(x, P.Filter(P.Scan("store"), P.pcol("s_state") == P.plit(state)),
               on=(("sr_store_sk", "s_store_sk"),))
    x = P.Join(x, P.Scan("customer"), on=(("sr_customer_sk", "c_customer_sk"),))
    x = P.Project(x, (("c_customer_id", P.pcol("c_customer_id")),))
    return P.Limit(P.Sort(x, (("c_customer_id", True),)), 100)


def q1(tables: Dict[str, Table], year: int = 1998, state: int = 3) -> Table:
    return _run(q1_plan(year, state), tables, "q1")


def q92_plan(manufact: int = 35, lo: int = 200, hi: int = 290) -> P.Node:
    """TPC-DS q92 (excess discount amount) — decorrelate avg * 1.3. SQL:

        SELECT sum(ws_ext_discount_amt)
        FROM web_sales, item, date_dim
        WHERE i_manufact_id = :m AND i_item_sk = ws_item_sk
          AND d_date_sk = ws_sold_date_sk AND d_date BETWEEN :lo AND :hi
          AND ws_ext_discount_amt >
              (SELECT 1.3 * avg(ws_ext_discount_amt)
               FROM web_sales, date_dim
               WHERE ws_item_sk = i_item_sk
                 AND d_date_sk = ws_sold_date_sk
                 AND d_date BETWEEN :lo AND :hi)

    The date-filtered web_sales is one shared node (fact side AND
    subquery side); the decorrelated per-item average joins back as a
    MATERIALIZED build inside the fused final aggregation."""
    dated = P.Join(
        P.Scan("web_sales"),
        P.Filter(P.Scan("date_dim"),
                 (P.pcol("d_date_sk") >= P.plit(lo))
                 & (P.pcol("d_date_sk") <= P.plit(hi))),
        on=(("ws_sold_date_sk", "d_date_sk"),), bounded=True,
    )
    main = P.Join(
        dated,
        P.Filter(P.Scan("item"), P.pcol("i_manufact_id") == P.plit(manufact)),
        on=(("ws_item_sk", "i_item_sk"),), bounded=True,
    )
    x = P.CorrelatedAggFilter(
        main, dated, on=("ws_item_sk", "ws_item_sk"),
        agg=P.AggSpec("ws_ext_discount_amt", "mean", "avg_disc"),
        predicate=P.pcol("ws_ext_discount_amt") > P.plit(1.3) * P.pcol("avg_disc"),
    )
    return P.Aggregate(x, keys=(),
                       aggs=(P.AggSpec("ws_ext_discount_amt", "sum", "excess"),))


def q92(tables, manufact: int = 35, lo: int = 200, hi: int = 290) -> Table:
    return _run(q92_plan(manufact, lo, hi), tables, "q92")


def q26_plan(gender: int = 1, marital: int = 2, education: int = 3,
             year: int = 2000) -> P.Node:
    """TPC-DS q26 — q7's catalog-channel twin: 4-way star with exact
    FLOAT64/int AVG aggregates, fully fused. SQL:

        SELECT i_item_id, avg(cs_quantity), avg(cs_list_price),
               avg(cs_coupon_amt), avg(cs_sales_price)
        FROM catalog_sales, customer_demographics, date_dim, item, promotion
        WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
          AND cs_bill_cdemo_sk = cd_demo_sk AND cs_promo_sk = p_promo_sk
          AND cd_gender = :g AND cd_marital_status = :m
          AND cd_education_status = :e
          AND (p_channel_email = 'N' OR p_channel_event = 'N')
          AND d_year = :y
        GROUP BY i_item_id ORDER BY i_item_id
    """
    x = P.Scan("catalog_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
               on=(("cs_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(
        x,
        P.Filter(P.Scan("customer_demographics"),
                 (P.pcol("cd_gender") == P.plit(gender))
                 & (P.pcol("cd_marital_status") == P.plit(marital))
                 & (P.pcol("cd_education_status") == P.plit(education))),
        on=(("cs_bill_cdemo_sk", "cd_demo_sk"),), bounded=True,
    )
    x = P.Join(
        x,
        P.Filter(P.Scan("promotion"),
                 (P.pcol("p_channel_email") == P.plit(0))
                 | (P.pcol("p_channel_event") == P.plit(0))),
        on=(("cs_promo_sk", "p_promo_sk"),), bounded=True,
    )
    x = P.Join(x, P.Scan("item"), on=(("cs_item_sk", "i_item_sk"),), bounded=True)
    agg = P.Aggregate(
        x, keys=("i_item_id",),
        aggs=(
            P.AggSpec("cs_quantity", "mean", "agg1"),
            P.AggSpec("cs_list_price", "mean", "agg2"),
            P.AggSpec("cs_coupon_amt", "mean", "agg3"),
            P.AggSpec("cs_sales_price", "mean", "agg4"),
        ),
    )
    return P.Sort(agg, (("i_item_id", True),))


def q26(tables, gender: int = 1, marital: int = 2, education: int = 3,
        year: int = 2000) -> Table:
    return _run(q26_plan(gender, marital, education, year), tables, "q26")


def q20_plan(cats=(2, 5, 8), lo: int = 700, hi: int = 730) -> P.Node:
    """TPC-DS q20 — the partition-sum-ratio reporting family (q12/q20/
    q98) on the catalog channel: class revenue plus each class's share
    of its category, via the window tier over a fused aggregation. SQL:

        SELECT i_category_id, i_class_id, sum(cs_ext_sales_price) itemrevenue,
               sum(cs_ext_sales_price) * 100 /
                 sum(sum(cs_ext_sales_price)) OVER (PARTITION BY i_category_id)
        FROM catalog_sales, item, date_dim
        WHERE cs_item_sk = i_item_sk AND i_category_id IN (:a,:b,:c)
          AND cs_sold_date_sk = d_date_sk AND d_date BETWEEN :lo AND :hi
        GROUP BY i_category_id, i_class_id
        ORDER BY i_category_id, revenueratio, i_class_id
    """
    in_list = None
    for c in cats:
        e = P.pcol("i_category_id") == P.plit(c)
        in_list = e if in_list is None else (in_list | e)
    x = P.Scan("catalog_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"),
                           (P.pcol("d_date_sk") >= P.plit(lo))
                           & (P.pcol("d_date_sk") <= P.plit(hi))),
               on=(("cs_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(x, P.Filter(P.Scan("item"), in_list),
               on=(("cs_item_sk", "i_item_sk"),), bounded=True)
    agg = P.Aggregate(x, keys=("i_category_id", "i_class_id"),
                      aggs=(P.AggSpec("cs_ext_sales_price", "sum", "itemrevenue"),))
    w = P.Window(agg, partition_by=("i_category_id",), order_by=(),
                 aggs=(("itemrevenue", "sum", "cat_total"),))
    proj = P.Project(w, (
        ("i_category_id", P.pcol("i_category_id")),
        ("i_class_id", P.pcol("i_class_id")),
        ("itemrevenue", P.pcol("itemrevenue")),
        ("revenueratio",
         (P.pcol("itemrevenue") * P.plit(100.0)) / P.pcol("cat_total")),
    ))
    return P.Sort(proj, (("i_category_id", True), ("revenueratio", True),
                         ("i_class_id", True)))


def q20(tables, cats=(2, 5, 8), lo: int = 700, hi: int = 730) -> Table:
    return _run(q20_plan(cats, lo, hi), tables, "q20")


def q27_plan(gender: int = 1, marital: int = 2, education: int = 3,
             year: int = 2000, states=(1, 4, 7)) -> P.Node:
    """TPC-DS q27 — ROLLUP over the store star: the optimizer expands
    ``rollup(i_item_id, s_state)`` into a UnionAll of three fused
    group-bys with null-filled rolled keys. SQL:

        SELECT i_item_id, s_state, grouping(s_state),
               avg(ss_quantity), avg(ss_list_price),
               avg(ss_coupon_amt), avg(ss_sales_price)
        FROM store_sales, customer_demographics, date_dim, store, item
        WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
          AND ss_store_sk = s_store_sk AND ss_cdemo_sk = cd_demo_sk
          AND cd_gender = :g AND cd_marital_status = :m
          AND cd_education_status = :e AND d_year = :y
          AND s_state IN (:states)
        GROUP BY ROLLUP(i_item_id, s_state)
    """
    in_states = None
    for s in states:
        e = P.pcol("s_state") == P.plit(s)
        in_states = e if in_states is None else (in_states | e)
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(
        x,
        P.Filter(P.Scan("customer_demographics"),
                 (P.pcol("cd_gender") == P.plit(gender))
                 & (P.pcol("cd_marital_status") == P.plit(marital))
                 & (P.pcol("cd_education_status") == P.plit(education))),
        on=(("ss_cdemo_sk", "cd_demo_sk"),), bounded=True,
    )
    x = P.Join(x, P.Filter(P.Scan("store"), in_states),
               on=(("ss_store_sk", "s_store_sk"),), bounded=True)
    x = P.Join(x, P.Scan("item"), on=(("ss_item_sk", "i_item_sk"),), bounded=True)
    return P.Aggregate(
        x, keys=("i_item_id", "s_state"),
        aggs=(
            P.AggSpec("ss_quantity", "mean", "agg1"),
            P.AggSpec("ss_list_price", "mean", "agg2"),
            P.AggSpec("ss_coupon_amt", "mean", "agg3"),
            P.AggSpec("ss_sales_price", "mean", "agg4"),
        ),
        grouping_sets=P.rollup("i_item_id", "s_state"),
    )


def q27(tables, gender: int = 1, marital: int = 2, education: int = 3,
        year: int = 2000, states=(1, 4, 7)) -> Table:
    return _run(q27_plan(gender, marital, education, year, states), tables, "q27")


def q43_plan(year: int = 2000) -> P.Node:
    """TPC-DS q43 — the day-name CASE pivot: per-store weekly sales
    matrix via seven CASE-WHEN projections summed in ONE fused program.
    SQL shape:

        SELECT s_store_sk,
               sum(CASE WHEN d_dow = 0 THEN ss_sales_price END) sun_sales,
               ... (mon..sat) ...
        FROM date_dim, store_sales
        WHERE d_date_sk = ss_sold_date_sk AND d_year = :y
        GROUP BY s_store_sk(-> ss_store_sk code) ORDER BY s_store_sk
    """
    x = P.Join(
        P.Scan("store_sales"),
        P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
        on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True,
    )
    days = ("sun", "mon", "tue", "wed", "thu", "fri", "sat")
    exprs = [("ss_store_sk", P.pcol("ss_store_sk"))]
    for i, day in enumerate(days):
        exprs.append((
            f"{day}_sales",
            P.pwhen(P.pcol("d_dow") == P.plit(i), P.pcol("ss_sales_price"),
                    P.plit(None, dt.FLOAT64)),
        ))
    proj = P.Project(x, tuple(exprs))
    agg = P.Aggregate(
        proj, keys=("ss_store_sk",),
        aggs=tuple(P.AggSpec(f"{d}_sales", "sum", f"{d}_sales_sum") for d in days),
    )
    return P.Sort(agg, (("ss_store_sk", True),))


def q43(tables, year: int = 2000) -> Table:
    return _run(q43_plan(year), tables, "q43")


def q88_plan(deps=(2, 7), hours=(8, 9, 10, 11)) -> P.Node:
    """TPC-DS q88 — eight half-hour time-band store traffic counts, one
    fused global-count star per band, UNION ALLed into a (band, cnt)
    report. SQL shape (per band):

        SELECT count(*) FROM store_sales, household_demographics, time_dim
        WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
          AND t_hour = :h AND t_minute [< | >=] 30
          AND (hd_dep_count = :d1 OR hd_dep_count = :d2)
    """
    hd_filter = ((P.pcol("hd_dep_count") == P.plit(deps[0]))
                 | (P.pcol("hd_dep_count") == P.plit(deps[1])))
    branches = []
    band = 0
    for h in hours:
        for half in (0, 1):
            tf = P.pcol("t_hour") == P.plit(h)
            tf = tf & ((P.pcol("t_minute") < P.plit(30)) if half == 0
                       else (P.pcol("t_minute") >= P.plit(30)))
            x = P.Scan("store_sales")
            x = P.Join(x, P.Filter(P.Scan("time_dim"), tf),
                       on=(("ss_sold_time_sk", "t_time_sk"),), bounded=True)
            x = P.Join(x, P.Filter(P.Scan("household_demographics"), hd_filter),
                       on=(("ss_hdemo_sk", "hd_demo_sk"),), bounded=True)
            agg = P.Aggregate(x, keys=(), aggs=(P.AggSpec(None, "count_all", "cnt"),))
            branches.append(P.Project(agg, (
                ("band", P.plit(np.int32(band))), ("cnt", P.pcol("cnt")),
            )))
            band += 1
    return P.UnionAll(tuple(branches))


def q88(tables, deps=(2, 7), hours=(8, 9, 10, 11)) -> Table:
    return _run(q88_plan(deps, hours), tables, "q88")


def q96_plan(hour: int = 20, dep: int = 5) -> P.Node:
    """TPC-DS q96 — one half-hour demographic count (q88's single-band
    sibling), a fused global COUNT(*) star. SQL:

        SELECT count(*) FROM store_sales, household_demographics, time_dim
        WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
          AND t_hour = :h AND t_minute >= 30 AND hd_dep_count = :d
    """
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("time_dim"),
                           (P.pcol("t_hour") == P.plit(hour))
                           & (P.pcol("t_minute") >= P.plit(30))),
               on=(("ss_sold_time_sk", "t_time_sk"),), bounded=True)
    x = P.Join(x, P.Filter(P.Scan("household_demographics"),
                           P.pcol("hd_dep_count") == P.plit(dep)),
               on=(("ss_hdemo_sk", "hd_demo_sk"),), bounded=True)
    return P.Aggregate(x, keys=(), aggs=(P.AggSpec(None, "count_all", "cnt"),))


def q96(tables, hour: int = 20, dep: int = 5) -> Table:
    return _run(q96_plan(hour, dep), tables, "q96")


def _channel_customers(fact: str, cust_col: str, year: int, moy_lo: int,
                       moy_hi: int) -> P.Node:
    """Customer ids active on one channel inside a month window — the
    shared branch of the q38/q87 set-op chains."""
    x = P.Join(
        P.Scan(fact),
        P.Filter(P.Scan("date_dim"),
                 (P.pcol("d_year") == P.plit(year))
                 & (P.pcol("d_moy") >= P.plit(moy_lo))
                 & (P.pcol("d_moy") <= P.plit(moy_hi))),
        on=((f"{cust_col[:2]}_sold_date_sk", "d_date_sk"),), bounded=True,
    )
    x = P.Join(x, P.Scan("customer"), on=((cust_col, "c_customer_sk"),),
               bounded=True)
    return P.Project(x, (("c_customer_id", P.pcol("c_customer_id")),))


def q38_plan(year: int = 1999, moy_lo: int = 1, moy_hi: int = 7) -> P.Node:
    """TPC-DS q38 — INTERSECT chain: customers active on ALL THREE
    channels in the window; the optimizer lowers both INTERSECTs to
    semi-joins on deduplicated keys. SQL shape:

        SELECT count(*) FROM (
          SELECT c_customer_id FROM store_sales, date_dim, customer WHERE ...
          INTERSECT SELECT ... FROM catalog_sales ...
          INTERSECT SELECT ... FROM web_sales ...) hot_cust
    """
    s = _channel_customers("store_sales", "ss_customer_sk", year, moy_lo, moy_hi)
    c = _channel_customers("catalog_sales", "cs_ship_customer_sk", year, moy_lo, moy_hi)
    w = _channel_customers("web_sales", "ws_bill_customer_sk", year, moy_lo, moy_hi)
    chain = P.SetOp(P.SetOp(s, c, "intersect"), w, "intersect")
    return P.Aggregate(chain, keys=(), aggs=(P.AggSpec(None, "count_all", "cnt"),))


def q38(tables, year: int = 1999, moy_lo: int = 1, moy_hi: int = 7) -> Table:
    return _run(q38_plan(year, moy_lo, moy_hi), tables, "q38")


def q87_plan(year: int = 1999, moy_lo: int = 1, moy_hi: int = 7) -> P.Node:
    """TPC-DS q87 — the EXCEPT twin of q38: store customers with NO
    catalog and NO web activity in the window (anti-joins on deduped
    keys)."""
    s = _channel_customers("store_sales", "ss_customer_sk", year, moy_lo, moy_hi)
    c = _channel_customers("catalog_sales", "cs_ship_customer_sk", year, moy_lo, moy_hi)
    w = _channel_customers("web_sales", "ws_bill_customer_sk", year, moy_lo, moy_hi)
    chain = P.SetOp(P.SetOp(s, c, "except"), w, "except")
    return P.Aggregate(chain, keys=(), aggs=(P.AggSpec(None, "count_all", "cnt"),))


def q87(tables, year: int = 1999, moy_lo: int = 1, moy_hi: int = 7) -> Table:
    return _run(q87_plan(year, moy_lo, moy_hi), tables, "q87")


def q69_plan(states=(2, 5, 8), year: int = 1999, moy_lo: int = 1,
             moy_hi: int = 3) -> P.Node:
    """TPC-DS q69 — demographic counts of customers with store activity
    but NO web/catalog activity in the window: one EXISTS plus two NOT
    EXISTS, all lowered to semi/anti joins that FUSE into the one
    compiled program over the customer table (the subquery sides
    materialize as build tables). SQL shape:

        SELECT cd_gender, cd_marital_status, cd_education_status, count(*)
        FROM customer c, customer_address ca, customer_demographics
        WHERE c_current_addr_sk = ca_address_sk AND ca_state IN (:states)
          AND cd_demo_sk = c_current_cdemo_sk
          AND EXISTS (SELECT * FROM store_sales, date_dim WHERE ...)
          AND NOT EXISTS (SELECT * FROM web_sales, date_dim WHERE ...)
          AND NOT EXISTS (SELECT * FROM catalog_sales, date_dim WHERE ...)
        GROUP BY cd_gender, cd_marital_status, cd_education_status
        ORDER BY cd_gender, cd_marital_status, cd_education_status
    """
    in_states = None
    for s in states:
        e = P.pcol("ca_state") == P.plit(s)
        in_states = e if in_states is None else (in_states | e)
    dates = P.Filter(P.Scan("date_dim"),
                     (P.pcol("d_year") == P.plit(year))
                     & (P.pcol("d_moy") >= P.plit(moy_lo))
                     & (P.pcol("d_moy") <= P.plit(moy_hi)))

    def active(fact: str, cust_col: str) -> P.Node:
        prefix = cust_col.split("_")[0]
        return P.Join(P.Scan(fact), dates,
                      on=((f"{prefix}_sold_date_sk", "d_date_sk"),), bounded=True)

    x = P.Join(P.Scan("customer"),
               P.Filter(P.Scan("customer_address"), in_states),
               on=(("c_current_addr_sk", "ca_address_sk"),), bounded=True)
    x = P.Join(x, P.Scan("customer_demographics"),
               on=(("c_current_cdemo_sk", "cd_demo_sk"),), bounded=True)
    x = P.Exists(x, active("store_sales", "ss_customer_sk"),
                 on=(("c_customer_sk", "ss_customer_sk"),))
    x = P.Exists(x, active("web_sales", "ws_bill_customer_sk"),
                 on=(("c_customer_sk", "ws_bill_customer_sk"),), negated=True)
    x = P.Exists(x, active("catalog_sales", "cs_ship_customer_sk"),
                 on=(("c_customer_sk", "cs_ship_customer_sk"),), negated=True)
    agg = P.Aggregate(
        x, keys=("cd_gender", "cd_marital_status", "cd_education_status"),
        aggs=(P.AggSpec(None, "count_all", "cnt"),),
    )
    return P.Sort(agg, (("cd_gender", True), ("cd_marital_status", True),
                        ("cd_education_status", True)))


def q69(tables, states=(2, 5, 8), year: int = 1999, moy_lo: int = 1,
        moy_hi: int = 3) -> Table:
    return _run(q69_plan(states, year, moy_lo, moy_hi), tables, "q69")


def q73_plan(year: int = 2000, buys=(1, 4), lo: int = 1, hi: int = 2) -> P.Node:
    """TPC-DS q73 — the HAVING count band: per-(ticket, customer) item
    counts filtered to a band, joined back to customer. The inner
    aggregation fuses; HAVING lowers to a post-aggregate Filter; the
    join-back runs on the (small) aggregate output. SQL shape:

        SELECT c_customer_id, cnt FROM (
          SELECT ss_ticket_number, ss_customer_sk, count(*) cnt
          FROM store_sales, date_dim, household_demographics
          WHERE ss_sold_date_sk = d_date_sk AND ss_hdemo_sk = hd_demo_sk
            AND d_year = :y AND hd_buy_potential IN (:b1, :b2)
          GROUP BY ss_ticket_number, ss_customer_sk) dj, customer
        WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN :lo AND :hi
        ORDER BY cnt DESC, c_customer_id
    """
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(
        x,
        P.Filter(P.Scan("household_demographics"),
                 (P.pcol("hd_buy_potential") == P.plit(buys[0]))
                 | (P.pcol("hd_buy_potential") == P.plit(buys[1]))),
        on=(("ss_hdemo_sk", "hd_demo_sk"),), bounded=True,
    )
    agg = P.Aggregate(x, keys=("ss_ticket_number", "ss_customer_sk"),
                      aggs=(P.AggSpec(None, "count_all", "cnt"),))
    hv = P.Having(agg, (P.pcol("cnt") >= P.plit(lo)) & (P.pcol("cnt") <= P.plit(hi)))
    j = P.Join(hv, P.Scan("customer"), on=(("ss_customer_sk", "c_customer_sk"),))
    proj = P.Project(j, (("c_customer_id", P.pcol("c_customer_id")),
                         ("cnt", P.pcol("cnt"))))
    return P.Sort(proj, (("cnt", False), ("c_customer_id", True)))


def q73(tables, year: int = 2000, buys=(1, 4), lo: int = 1, hi: int = 2) -> Table:
    return _run(q73_plan(year, buys, lo, hi), tables, "q73")


def q13_plan(year: int = 2000) -> P.Node:
    """TPC-DS q13 — the OR'ed demographic/price band star over six
    joined dimensions, global exact averages; the whole chain (six
    inner joins + the cross-dimension band filter + four aggregates)
    fuses into ONE compiled program under the new srjt-plancheck
    verifier. SQL shape:

        SELECT avg(ss_quantity), avg(ss_list_price), avg(ss_coupon_amt),
               sum(ss_sales_price)
        FROM store_sales, store, customer_demographics,
             household_demographics, customer, customer_address, date_dim
        WHERE d_year = :y AND ss_store_sk = s_store_sk
          AND ss_cdemo_sk = cd_demo_sk AND ss_hdemo_sk = hd_demo_sk
          AND ss_customer_sk = c_customer_sk
          AND c_current_addr_sk = ca_address_sk
          AND ((cd_marital_status = 'M' AND cd_education_status = ... AND
                ss_sales_price BETWEEN .. AND hd_dep_count = ..) OR (...))
          AND (ca_state IN (...) ...)

    Dictionary codes stand in for the string bands (ca_zip5 for the
    address band), as everywhere in this tier."""
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(x, P.Scan("store"), on=(("ss_store_sk", "s_store_sk"),),
               bounded=True)
    x = P.Join(x, P.Scan("customer_demographics"),
               on=(("ss_cdemo_sk", "cd_demo_sk"),), bounded=True)
    x = P.Join(x, P.Scan("household_demographics"),
               on=(("ss_hdemo_sk", "hd_demo_sk"),), bounded=True)
    x = P.Join(x, P.Scan("customer"), on=(("ss_customer_sk", "c_customer_sk"),),
               bounded=True)
    x = P.Join(x, P.Scan("customer_address"),
               on=(("c_current_addr_sk", "ca_address_sk"),), bounded=True)
    band1 = ((P.pcol("cd_marital_status") <= P.plit(2))
             & (P.pcol("cd_education_status") >= P.plit(3))
             & (P.pcol("ss_sales_price") >= P.plit(50.0))
             & (P.pcol("hd_dep_count") <= P.plit(5)))
    band2 = ((P.pcol("cd_marital_status") >= P.plit(3))
             & (P.pcol("cd_education_status") <= P.plit(2))
             & (P.pcol("ss_sales_price") <= P.plit(100.0))
             & (P.pcol("hd_dep_count") >= P.plit(4)))
    zips = (P.pcol("ca_zip5") < P.plit(120)) | (P.pcol("ca_zip5") >= P.plit(210))
    x = P.Filter(x, (band1 | band2) & zips)
    return P.Aggregate(
        x, keys=(),
        aggs=(
            P.AggSpec("ss_quantity", "mean", "avg_qty"),
            P.AggSpec("ss_list_price", "mean", "avg_list"),
            P.AggSpec("ss_coupon_amt", "mean", "avg_coupon"),
            P.AggSpec("ss_sales_price", "sum", "sum_sales"),
        ),
    )


def q13(tables: Dict[str, Table], year: int = 2000) -> Table:
    return _run(q13_plan(year), tables, "q13")


def q48_plan(year: int = 2000) -> P.Node:
    """TPC-DS q48 — q13's global-sum sibling: demographic/price bands
    OR'ed with address bands over the store star, one fused global
    SUM(ss_quantity). SQL shape:

        SELECT sum(ss_quantity)
        FROM store_sales, store, customer_demographics, customer,
             customer_address, date_dim
        WHERE d_year = :y AND ss_store_sk = s_store_sk AND ...
          AND ((cd_marital_status = .. AND cd_education_status = .. AND
                ss_sales_price BETWEEN ..) OR (...))
          AND ((ca_state IN (..) AND ss_net_profit BETWEEN ..) OR (...))
    """
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(x, P.Scan("store"), on=(("ss_store_sk", "s_store_sk"),),
               bounded=True)
    x = P.Join(x, P.Scan("customer_demographics"),
               on=(("ss_cdemo_sk", "cd_demo_sk"),), bounded=True)
    x = P.Join(x, P.Scan("customer"), on=(("ss_customer_sk", "c_customer_sk"),),
               bounded=True)
    x = P.Join(x, P.Scan("customer_address"),
               on=(("c_current_addr_sk", "ca_address_sk"),), bounded=True)
    demo = (((P.pcol("cd_marital_status") == P.plit(2))
             & (P.pcol("cd_education_status") == P.plit(3))
             & (P.pcol("ss_sales_price") >= P.plit(50.0))
             & (P.pcol("ss_sales_price") <= P.plit(150.0)))
            | ((P.pcol("cd_marital_status") == P.plit(1))
               & (P.pcol("cd_education_status") == P.plit(4))
               & (P.pcol("ss_sales_price") <= P.plit(100.0))))
    addr = ((P.pcol("ca_zip5") < P.plit(100))
            | ((P.pcol("ca_zip5") >= P.plit(150)) & (P.pcol("ca_zip5") < P.plit(250))))
    x = P.Filter(x, demo & addr)
    return P.Aggregate(x, keys=(),
                       aggs=(P.AggSpec("ss_quantity", "sum", "qty_sum"),))


def q48(tables: Dict[str, Table], year: int = 2000) -> Table:
    return _run(q48_plan(year), tables, "q48")


def q65_plan(lo: int = 400, hi: int = 1100, frac: float = 0.5) -> P.Node:
    """TPC-DS q65 — low-revenue items per store: per-(store, item)
    revenue compared against a fraction of the per-store AVERAGE
    revenue — the correlated scalar subquery decorrelates exactly like
    q1, and the inner (store, item) revenue aggregate FUSES (both keys
    dense INT32 domains); the comparison + item join-back run on the
    small aggregate output. SQL:

        SELECT s_store_sk, i_item_id, revenue FROM store, item,
          (SELECT ss_store_sk, ss_item_sk, sum(ss_sales_price) revenue
           FROM store_sales, date_dim
           WHERE ss_sold_date_sk = d_date_sk AND d_date_sk BETWEEN :lo AND :hi
           GROUP BY ss_store_sk, ss_item_sk) sa
        WHERE sa.revenue <= :frac *
              (SELECT avg(revenue) FROM sa sb
               WHERE sb.ss_store_sk = sa.ss_store_sk)
          AND ss_item_sk = i_item_sk
        ORDER BY s_store_sk, i_item_id
    """
    sa = P.Aggregate(
        P.Join(
            P.Scan("store_sales"),
            P.Filter(P.Scan("date_dim"),
                     (P.pcol("d_date_sk") >= P.plit(lo))
                     & (P.pcol("d_date_sk") <= P.plit(hi))),
            on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True,
        ),
        keys=("ss_store_sk", "ss_item_sk"),
        aggs=(P.AggSpec("ss_sales_price", "sum", "revenue"),),
    )
    x = P.CorrelatedAggFilter(
        sa, sa, on=("ss_store_sk", "ss_store_sk"),
        agg=P.AggSpec("revenue", "mean", "ave"),
        predicate=P.pcol("revenue") <= P.plit(frac) * P.pcol("ave"),
    )
    x = P.Join(x, P.Scan("item"), on=(("ss_item_sk", "i_item_sk"),))
    x = P.Project(x, (("ss_store_sk", P.pcol("ss_store_sk")),
                      ("i_item_id", P.pcol("i_item_id")),
                      ("revenue", P.pcol("revenue"))))
    return P.Sort(x, (("ss_store_sk", True), ("i_item_id", True)))


def q65(tables: Dict[str, Table], lo: int = 400, hi: int = 1100,
        frac: float = 0.5) -> Table:
    return _run(q65_plan(lo, hi, frac), tables, "q65")


# ---------------------------------------------------------------------------
# mass-green campaign — ten more lowers go green
# through the compiler; the multi-join chains among them (q8/q15/q30/
# q34/q35) double as checked-in exercise for the cost-based join
# enumeration (cbo_reorder_joins / cbo_build_side / cbo_join_strategy).
# ---------------------------------------------------------------------------


def q9_plan(thresholds=(2100, 2100, 2100, 2100, 1800)) -> P.Node:
    """TPC-DS q9 — the bucketed CASE report: five quantity bands over
    store_sales alone; each band's output column picks one of two
    global averages depending on the band's row count. SQL shape (per
    bucket)::

        SELECT CASE WHEN (SELECT count(*) FROM store_sales
                          WHERE ss_quantity BETWEEN :lo AND :hi) > :t
                    THEN (SELECT avg(ss_ext_sales_price) ...)
                    ELSE (SELECT avg(ss_coupon_amt) ...) END bucket_n

    Each bucket is one fused global aggregate; the CASE is a projection
    over the aggregate's (cnt, avg, avg) row; buckets UNION ALL into a
    (bucket, val) report."""
    branches = []
    for i, th in enumerate(thresholds):
        lo, hi = 1 + 20 * i, 20 + 20 * i
        band = (P.pcol("ss_quantity") >= P.plit(lo)) & (P.pcol("ss_quantity") <= P.plit(hi))
        agg = P.Aggregate(
            P.Filter(P.Scan("store_sales"), band), keys=(),
            aggs=(
                P.AggSpec(None, "count_all", "cnt"),
                P.AggSpec("ss_ext_sales_price", "mean", "avg_ext"),
                P.AggSpec("ss_coupon_amt", "mean", "avg_coup"),
            ),
        )
        branches.append(P.Project(agg, (
            ("bucket", P.plit(np.int32(i))),
            ("val", P.pwhen(P.pcol("cnt") > P.plit(th),
                            P.pcol("avg_ext"), P.pcol("avg_coup"))),
        )))
    return P.UnionAll(tuple(branches))


def q9(tables: Dict[str, Table], thresholds=(2100, 2100, 2100, 2100, 1800)) -> Table:
    return _run(q9_plan(thresholds), tables, "q9")


def q28_plan() -> P.Node:
    """TPC-DS q28 — six band aggregates over store_sales alone:
    per quantity band (with OR'ed list-price/coupon side bands),
    avg / count / count(DISTINCT) of ss_list_price, UNION ALLed. SQL
    shape (per band)::

        SELECT avg(ss_list_price), count(ss_list_price),
               count(DISTINCT ss_list_price)
        FROM store_sales
        WHERE ss_quantity BETWEEN :lo AND :hi
          AND (ss_list_price BETWEEN :a AND :b
               OR ss_coupon_amt BETWEEN :c AND :d)
    """
    branches = []
    for i in range(6):
        qlo, qhi = 1 + 16 * i, 16 + 16 * i
        pred = ((P.pcol("ss_quantity") >= P.plit(qlo))
                & (P.pcol("ss_quantity") <= P.plit(qhi))
                & (((P.pcol("ss_list_price") >= P.plit(20.0 + 10 * i))
                    & (P.pcol("ss_list_price") <= P.plit(120.0 + 10 * i)))
                   | ((P.pcol("ss_coupon_amt") >= P.plit(5.0 * i))
                      & (P.pcol("ss_coupon_amt") <= P.plit(20.0 + 5.0 * i)))))
        agg = P.Aggregate(
            P.Filter(P.Scan("store_sales"), pred), keys=(),
            aggs=(
                P.AggSpec("ss_list_price", "mean", "avg_lp"),
                P.AggSpec("ss_list_price", "count", "cnt_lp"),
                P.AggSpec("ss_list_price", "nunique", "uniq_lp"),
            ),
        )
        branches.append(P.Project(agg, (
            ("band", P.plit(np.int32(i))),
            ("avg_lp", P.pcol("avg_lp")),
            ("cnt_lp", P.pcol("cnt_lp")),
            ("uniq_lp", P.pcol("uniq_lp")),
        )))
    return P.UnionAll(tuple(branches))


def q28(tables: Dict[str, Table]) -> Table:
    return _run(q28_plan(), tables, "q28")


def q15_plan(year: int = 2000, moy_lo: int = 1, moy_hi: int = 3,
             price: float = 120.0) -> P.Node:
    """TPC-DS q15 — the zip-band catalog star on the store channel:
    fact -> customer -> customer_address chain plus the date dim, kept
    rows are (zip band) OR (big ticket), revenue grouped by zip. The
    customer/address hops form a DEPENDENT join chain (the address key
    only exists after the customer join) — the enumeration's schema
    guard must keep that order while still reordering the independent
    date dim. SQL shape::

        SELECT ca_zip, sum(cs_sales_price)
        FROM catalog_sales, customer, customer_address, date_dim
        WHERE cs_bill_customer_sk = c_customer_sk
          AND c_current_addr_sk = ca_address_sk
          AND (substr(ca_zip,1,5) IN (...) OR cs_sales_price > 500)
          AND cs_sold_date_sk = d_date_sk AND d_qoy = :q AND d_year = :y
        GROUP BY ca_zip ORDER BY ca_zip
    """
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"),
                           (P.pcol("d_year") == P.plit(year))
                           & (P.pcol("d_moy") >= P.plit(moy_lo))
                           & (P.pcol("d_moy") <= P.plit(moy_hi))),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(x, P.Scan("customer"), on=(("ss_customer_sk", "c_customer_sk"),),
               bounded=True)
    x = P.Join(x, P.Scan("customer_address"),
               on=(("c_current_addr_sk", "ca_address_sk"),), bounded=True)
    zips = ((P.pcol("ca_zip5") < P.plit(40))
            | ((P.pcol("ca_zip5") >= P.plit(120)) & (P.pcol("ca_zip5") < P.plit(160)))
            | (P.pcol("ca_zip5") >= P.plit(260)))
    x = P.Filter(x, zips | (P.pcol("ss_sales_price") >= P.plit(price)))
    agg = P.Aggregate(x, keys=("ca_zip5",),
                      aggs=(P.AggSpec("ss_sales_price", "sum", "sum_sales"),))
    return P.Sort(agg, (("ca_zip5", True),))


def q15(tables: Dict[str, Table], year: int = 2000, moy_lo: int = 1,
        moy_hi: int = 3, price: float = 120.0) -> Table:
    return _run(q15_plan(year, moy_lo, moy_hi, price), tables, "q15")


def q8_plan(year: int = 2000, moy_lo: int = 10, moy_hi: int = 12,
            id_cut: int = 400) -> P.Node:
    """TPC-DS q8 — store revenue restricted to zip prefixes in the
    INTERSECT of a literal zip band and the zips of preferred
    customers; the set op lowers to a semi-join on deduped keys, and
    the store restriction is itself an EXISTS (semi-join) against that
    set. SQL shape::

        SELECT s_store_name, sum(ss_net_profit)
        FROM store_sales, date_dim, store,
          (SELECT zip FROM (zip_list INTERSECT
            SELECT ca_zip FROM customer_address, customer
            WHERE ca_address_sk = c_current_addr_sk
              AND c_preferred_cust_flag = 'Y' ...)) v
        WHERE ss_store_sk = s_store_sk AND d_qoy = ..
          AND substr(s_zip,1,2) = substr(v.zip,1,2)
        GROUP BY s_store_name

    ``c_customer_id < :cut`` stands in for the preferred flag, as
    dictionary codes do everywhere in this tier."""
    band = ((P.pcol("ca_zip5") < P.plit(30))
            | ((P.pcol("ca_zip5") >= P.plit(100)) & (P.pcol("ca_zip5") < P.plit(130)))
            | (P.pcol("ca_zip5") >= P.plit(270)))
    a1 = P.Project(P.Filter(P.Scan("customer_address"), band),
                   (("zip5", P.pcol("ca_zip5")),))
    pref = P.Join(P.Filter(P.Scan("customer"),
                           P.pcol("c_customer_id") < P.plit(id_cut)),
                  P.Scan("customer_address"),
                  on=(("c_current_addr_sk", "ca_address_sk"),), bounded=True)
    a2 = P.Project(pref, (("zip5", P.pcol("ca_zip5")),))
    zips = P.SetOp(a1, a2, "intersect")
    stores = P.Exists(P.Scan("store"), zips, on=(("s_zip5", "zip5"),))
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"),
                           (P.pcol("d_year") == P.plit(year))
                           & (P.pcol("d_moy") >= P.plit(moy_lo))
                           & (P.pcol("d_moy") <= P.plit(moy_hi))),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(x, stores, on=(("ss_store_sk", "s_store_sk"),), bounded=True)
    agg = P.Aggregate(x, keys=("ss_store_sk",),
                      aggs=(P.AggSpec("ss_ext_sales_price", "sum", "net"),))
    return P.Sort(agg, (("ss_store_sk", True),))


def q8(tables: Dict[str, Table], year: int = 2000, moy_lo: int = 10,
       moy_hi: int = 12, id_cut: int = 400) -> Table:
    return _run(q8_plan(year, moy_lo, moy_hi, id_cut), tables, "q8")


def q34_plan(year: int = 2000, moy_lo: int = 4, moy_hi: int = 6,
             buys=(0, 3), lo: int = 1, hi: int = 3) -> P.Node:
    """TPC-DS q34 — q73's wider HAVING band: per-(ticket, customer)
    item counts in a count band, demographic filter includes the
    vehicle lane, join-back to customer. SQL shape::

        SELECT c_customer_id, cnt FROM (
          SELECT ss_ticket_number, ss_customer_sk, count(*) cnt
          FROM store_sales, date_dim, household_demographics
          WHERE ss_sold_date_sk = d_date_sk AND ss_hdemo_sk = hd_demo_sk
            AND d_year = :y AND d_moy BETWEEN :l AND :h
            AND hd_buy_potential IN (:b1, :b2) AND hd_vehicle_count > 0
          GROUP BY ss_ticket_number, ss_customer_sk) dj, customer
        WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN :lo AND :hi
        ORDER BY cnt DESC, c_customer_id
    """
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"),
                           (P.pcol("d_year") == P.plit(year))
                           & (P.pcol("d_moy") >= P.plit(moy_lo))
                           & (P.pcol("d_moy") <= P.plit(moy_hi))),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(
        x,
        P.Filter(P.Scan("household_demographics"),
                 ((P.pcol("hd_buy_potential") == P.plit(buys[0]))
                  | (P.pcol("hd_buy_potential") == P.plit(buys[1])))
                 & (P.pcol("hd_vehicle_count") > P.plit(0))),
        on=(("ss_hdemo_sk", "hd_demo_sk"),), bounded=True,
    )
    agg = P.Aggregate(x, keys=("ss_ticket_number", "ss_customer_sk"),
                      aggs=(P.AggSpec(None, "count_all", "cnt"),))
    hv = P.Having(agg, (P.pcol("cnt") >= P.plit(lo)) & (P.pcol("cnt") <= P.plit(hi)))
    j = P.Join(hv, P.Scan("customer"), on=(("ss_customer_sk", "c_customer_sk"),))
    proj = P.Project(j, (("c_customer_id", P.pcol("c_customer_id")),
                         ("cnt", P.pcol("cnt"))))
    return P.Sort(proj, (("cnt", False), ("c_customer_id", True)))


def q34(tables: Dict[str, Table], year: int = 2000, moy_lo: int = 4,
        moy_hi: int = 6, buys=(0, 3), lo: int = 1, hi: int = 3) -> Table:
    return _run(q34_plan(year, moy_lo, moy_hi, buys, lo, hi), tables, "q34")


def q39_plan(cov: float = 0.55) -> P.Node:
    """TPC-DS q39 — the native stdev/mean shape: per-(store, month)
    quantity mean and sample standard deviation, kept where the
    coefficient of variation clears a bar (HAVING over agg outputs).
    SQL shape::

        SELECT w_warehouse_sk, d_moy, avg(inv_quantity_on_hand) mean,
               stddev_samp(inv_quantity_on_hand) stdev
        FROM inventory, date_dim, warehouse WHERE ...
        GROUP BY w_warehouse_sk, d_moy
        HAVING stdev / mean > 1.0

    store_sales/store stand in for inventory/warehouse (same relational
    shape; the var/std aggregates are the part under test)."""
    x = P.Join(P.Scan("store_sales"), P.Scan("date_dim"),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    agg = P.Aggregate(
        x, keys=("ss_store_sk", "d_moy"),
        aggs=(
            P.AggSpec("ss_quantity", "mean", "mean_q"),
            P.AggSpec("ss_quantity", "std", "std_q"),
        ),
    )
    hv = P.Having(agg, P.pcol("std_q") > P.pcol("mean_q") * P.plit(cov))
    return P.Sort(hv, (("ss_store_sk", True), ("d_moy", True)))


def q39(tables: Dict[str, Table], cov: float = 0.55) -> Table:
    return _run(q39_plan(cov), tables, "q39")


def q30_plan(year: int = 1999, factor: float = 1.2) -> P.Node:
    """TPC-DS q30 — the STATE-level decorrelation (q1's shape one
    grouping level up): per-(customer, state) return totals vs the
    per-state average * 1.2. SQL shape::

        WITH customer_total_return AS (
          SELECT wr_returning_customer_sk ctr_customer_sk, ca_state,
                 sum(wr_return_amt) ctr_total_return
          FROM web_returns, date_dim, customer_address WHERE d_year = :y ...
          GROUP BY wr_returning_customer_sk, ca_state)
        SELECT c_customer_id, ... FROM customer_total_return ctr1, customer
        WHERE ctr1.ctr_total_return >
              (SELECT avg(ctr_total_return) * 1.2 FROM customer_total_return
               ctr2 WHERE ctr1.ca_state = ctr2.ca_state)
          AND ctr1.ctr_customer_sk = c_customer_sk
        ORDER BY c_customer_id LIMIT 100

    store_returns/store(s_state) stand in for web_returns/
    customer_address(ca_state)."""
    ctr = P.Aggregate(
        P.Join(
            P.Join(
                P.Scan("store_returns"),
                P.Filter(P.Scan("date_dim"), P.pcol("d_year") == P.plit(year)),
                on=(("sr_returned_date_sk", "d_date_sk"),), bounded=True,
            ),
            P.Scan("store"),
            on=(("sr_store_sk", "s_store_sk"),), bounded=True,
        ),
        keys=("sr_customer_sk", "s_state"),
        aggs=(P.AggSpec("sr_return_amt", "sum", "ctr_total_return"),),
    )
    x = P.CorrelatedAggFilter(
        ctr, ctr, on=("s_state", "s_state"),
        agg=P.AggSpec("ctr_total_return", "mean", "ctr_avg"),
        predicate=P.pcol("ctr_total_return") > P.pcol("ctr_avg") * P.plit(factor),
    )
    x = P.Join(x, P.Scan("customer"), on=(("sr_customer_sk", "c_customer_sk"),))
    x = P.Project(x, (("c_customer_id", P.pcol("c_customer_id")),
                      ("ctr_total_return", P.pcol("ctr_total_return"))))
    # a customer can clear the bar in several states — the total is a
    # deterministic tie-break for those duplicate ids
    return P.Limit(P.Sort(x, (("c_customer_id", True),
                              ("ctr_total_return", True))), 100)


def q30(tables: Dict[str, Table], year: int = 1999, factor: float = 1.2) -> Table:
    return _run(q30_plan(year, factor), tables, "q30")


def q32_plan(category: int = 4, lo: int = 300, hi: int = 390,
             factor: float = 1.3) -> P.Node:
    """TPC-DS q32 — q92's catalog-channel twin (excess discount): sum
    of discounts exceeding 1.3x the per-item average inside a date
    window; the date-filtered fact is ONE shared node on both sides of
    the correlation. SQL shape::

        SELECT sum(cs_ext_discount_amt)
        FROM catalog_sales, item, date_dim
        WHERE i_manufact_id = :m AND i_item_sk = cs_item_sk
          AND d_date_sk = cs_sold_date_sk AND d_date BETWEEN :lo AND :hi
          AND cs_ext_discount_amt >
              (SELECT 1.3 * avg(cs_ext_discount_amt) FROM catalog_sales,
               date_dim WHERE cs_item_sk = i_item_sk AND ...)

    cs_coupon_amt stands in for the discount lane; the category id
    stands in for the manufacturer filter."""
    dated = P.Join(
        P.Scan("catalog_sales"),
        P.Filter(P.Scan("date_dim"),
                 (P.pcol("d_date_sk") >= P.plit(lo))
                 & (P.pcol("d_date_sk") <= P.plit(hi))),
        on=(("cs_sold_date_sk", "d_date_sk"),), bounded=True,
    )
    main = P.Join(
        dated,
        P.Filter(P.Scan("item"), P.pcol("i_category_id") == P.plit(category)),
        on=(("cs_item_sk", "i_item_sk"),), bounded=True,
    )
    x = P.CorrelatedAggFilter(
        main, dated, on=("cs_item_sk", "cs_item_sk"),
        agg=P.AggSpec("cs_coupon_amt", "mean", "avg_disc"),
        predicate=P.pcol("cs_coupon_amt") > P.plit(factor) * P.pcol("avg_disc"),
    )
    return P.Aggregate(x, keys=(),
                       aggs=(P.AggSpec("cs_coupon_amt", "sum", "excess"),))


def q32(tables: Dict[str, Table], category: int = 4, lo: int = 300,
        hi: int = 390, factor: float = 1.3) -> Table:
    return _run(q32_plan(category, lo, hi, factor), tables, "q32")


def _any_channel_active(year: int, moy_lo: int, moy_hi: int) -> P.Node:
    """Customer sks with web OR catalog activity in the window — the
    OR of two EXISTS is one EXISTS over the UNION ALL of the
    subqueries, which is how the q10/q35 family lowers."""
    dates = P.Filter(P.Scan("date_dim"),
                     (P.pcol("d_year") == P.plit(year))
                     & (P.pcol("d_moy") >= P.plit(moy_lo))
                     & (P.pcol("d_moy") <= P.plit(moy_hi)))
    web = P.Join(P.Scan("web_sales"), dates,
                 on=(("ws_sold_date_sk", "d_date_sk"),), bounded=True)
    cat = P.Join(P.Scan("catalog_sales"), dates,
                 on=(("cs_sold_date_sk", "d_date_sk"),), bounded=True)
    return P.UnionAll((
        P.Project(web, (("any_customer_sk", P.pcol("ws_bill_customer_sk")),)),
        P.Project(cat, (("any_customer_sk", P.pcol("cs_ship_customer_sk")),)),
    ))


def q10_plan(states=(1, 4, 7), year: int = 1999, moy_lo: int = 1,
             moy_hi: int = 4) -> P.Node:
    """TPC-DS q10 — demographic counts of in-county customers with
    store activity AND (web OR catalog) activity in the window: the OR
    of EXISTS lowers as one EXISTS over a UNION ALL, then both EXISTS
    become semi-joins. SQL shape::

        SELECT cd_gender, cd_marital_status, cd_education_status, count(*)
        FROM customer c, customer_address ca, customer_demographics
        WHERE c_current_addr_sk = ca_address_sk AND ca_county IN (...)
          AND cd_demo_sk = c_current_cdemo_sk
          AND EXISTS (SELECT * FROM store_sales, date_dim WHERE ...)
          AND (EXISTS (SELECT * FROM web_sales, date_dim WHERE ...)
               OR EXISTS (SELECT * FROM catalog_sales, date_dim WHERE ...))
        GROUP BY ... ORDER BY ...
    """
    in_states = None
    for s in states:
        e = P.pcol("ca_state") == P.plit(s)
        in_states = e if in_states is None else (in_states | e)
    dates = P.Filter(P.Scan("date_dim"),
                     (P.pcol("d_year") == P.plit(year))
                     & (P.pcol("d_moy") >= P.plit(moy_lo))
                     & (P.pcol("d_moy") <= P.plit(moy_hi)))
    x = P.Join(P.Scan("customer"),
               P.Filter(P.Scan("customer_address"), in_states),
               on=(("c_current_addr_sk", "ca_address_sk"),), bounded=True)
    x = P.Join(x, P.Scan("customer_demographics"),
               on=(("c_current_cdemo_sk", "cd_demo_sk"),), bounded=True)
    x = P.Exists(x, P.Join(P.Scan("store_sales"), dates,
                           on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True),
                 on=(("c_customer_sk", "ss_customer_sk"),))
    x = P.Exists(x, _any_channel_active(year, moy_lo, moy_hi),
                 on=(("c_customer_sk", "any_customer_sk"),))
    agg = P.Aggregate(
        x, keys=("cd_gender", "cd_marital_status", "cd_education_status"),
        aggs=(P.AggSpec(None, "count_all", "cnt"),),
    )
    return P.Sort(agg, (("cd_gender", True), ("cd_marital_status", True),
                        ("cd_education_status", True)))


def q10(tables: Dict[str, Table], states=(1, 4, 7), year: int = 1999,
        moy_lo: int = 1, moy_hi: int = 4) -> Table:
    return _run(q10_plan(states, year, moy_lo, moy_hi), tables, "q10")


def q35_plan(year: int = 1999, moy_lo: int = 1, moy_hi: int = 6) -> P.Node:
    """TPC-DS q35 — q10's reporting sibling: state-level demographic
    stats (count plus max/sum/avg of the dependent count) over the same
    EXISTS-store AND (EXISTS-web OR EXISTS-catalog) population. SQL
    shape::

        SELECT ca_state, cd_gender, cd_marital_status, count(*),
               max(cd_dep_count), sum(cd_dep_count), avg(cd_dep_count)
        FROM customer c, customer_address ca, customer_demographics
        WHERE c_current_addr_sk = ca_address_sk
          AND cd_demo_sk = c_current_cdemo_sk
          AND EXISTS (...store...) AND (EXISTS (...web...) OR EXISTS (...catalog...))
        GROUP BY ca_state, cd_gender, cd_marital_status ORDER BY ...
    """
    dates = P.Filter(P.Scan("date_dim"),
                     (P.pcol("d_year") == P.plit(year))
                     & (P.pcol("d_moy") >= P.plit(moy_lo))
                     & (P.pcol("d_moy") <= P.plit(moy_hi)))
    x = P.Join(P.Scan("customer"), P.Scan("customer_address"),
               on=(("c_current_addr_sk", "ca_address_sk"),), bounded=True)
    x = P.Join(x, P.Scan("customer_demographics"),
               on=(("c_current_cdemo_sk", "cd_demo_sk"),), bounded=True)
    x = P.Exists(x, P.Join(P.Scan("store_sales"), dates,
                           on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True),
                 on=(("c_customer_sk", "ss_customer_sk"),))
    x = P.Exists(x, _any_channel_active(year, moy_lo, moy_hi),
                 on=(("c_customer_sk", "any_customer_sk"),))
    agg = P.Aggregate(
        x, keys=("ca_state", "cd_gender", "cd_marital_status"),
        aggs=(
            P.AggSpec(None, "count_all", "cnt"),
            P.AggSpec("cd_dep_count", "max", "max_dep"),
            P.AggSpec("cd_dep_count", "sum", "sum_dep"),
            P.AggSpec("cd_dep_count", "mean", "avg_dep"),
        ),
    )
    return P.Sort(agg, (("ca_state", True), ("cd_gender", True),
                        ("cd_marital_status", True)))


def q35(tables: Dict[str, Table], year: int = 1999, moy_lo: int = 1,
        moy_hi: int = 6) -> Table:
    return _run(q35_plan(year, moy_lo, moy_hi), tables, "q35")


# ---------------------------------------------------------------------------
# hand-built greens re-expressed as plans (bit-identity contract)
# ---------------------------------------------------------------------------


def q3_plan(manufact_id: int = 128, month: int = 11) -> P.Node:
    """``models/tpcds.py::q3`` as IR: same dense bounded-domain star
    joins, same group keys, same ORDER BY — the compiled plan's output
    must be BIT-identical to the hand-fused original."""
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"), P.pcol("d_moy") == P.plit(month)),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = P.Join(x, P.Filter(P.Scan("item"),
                           P.pcol("i_manufact_id") == P.plit(manufact_id)),
               on=(("ss_item_sk", "i_item_sk"),), bounded=True)
    agg = P.Aggregate(
        x, keys=("d_year", "i_brand_id"),
        aggs=(P.AggSpec("ss_ext_sales_price", "sum", "ss_ext_sales_price_sum"),),
    )
    return P.Sort(agg, (("d_year", True), ("ss_ext_sales_price_sum", False),
                        ("i_brand_id", True)))


def q55_plan(manager_id: int = 28, month: int = 11, year: int = 1999) -> P.Node:
    """``models/tpcds.py::q55`` as IR: the sort-merge star (no bounded
    hint, matching the hand pipeline's num_keys=None lowering)."""
    x = P.Scan("store_sales")
    x = P.Join(x, P.Filter(P.Scan("date_dim"),
                           (P.pcol("d_moy") == P.plit(month))
                           & (P.pcol("d_year") == P.plit(year))),
               on=(("ss_sold_date_sk", "d_date_sk"),))
    x = P.Join(x, P.Filter(P.Scan("item"),
                           P.pcol("i_manager_id") == P.plit(manager_id)),
               on=(("ss_item_sk", "i_item_sk"),))
    agg = P.Aggregate(x, keys=("i_brand_id",),
                      aggs=(P.AggSpec("ss_ext_sales_price", "sum", "ext_price"),))
    return P.Sort(agg, (("ext_price", False), ("i_brand_id", True)))


# ---------------------------------------------------------------------------
# registry (tests, ledger, and the premerge compiler tier iterate this)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanQueryDef:
    name: str
    gen: Callable[..., Dict[str, Table]]  # (rows, seed=, device=)
    plan: Callable[[], "P.Node"]
    run: Callable[[Dict[str, Table]], Table]
    rows: int  # default oracle scale


def _gen(fn, seed: int):
    """A registry generator: ``gen(rows, s=seed, device=None)``; its
    ``generator`` and ``seed`` name what it calls, so that queries of one
    generator can share its tables."""
    def gen(n, s=seed, device=None):
        return fn(n, seed=s, device=device)

    gen.generator, gen.seed = fn, seed
    return gen


PLAN_QUERIES: Dict[str, PlanQueryDef] = {
    d.name: d
    for d in (
        PlanQueryDef("q1", _gen(gen_store_returns, 21), q1_plan, q1, 8000),
        PlanQueryDef("q8", _gen(gen_store_wide, 42), q8_plan, q8, 10000),
        PlanQueryDef("q9", _gen(gen_store_wide, 42), q9_plan, q9, 10000),
        PlanQueryDef("q10", _gen(gen_channels, 29), q10_plan, q10, 6000),
        PlanQueryDef("q13", _gen(gen_store_wide, 42), q13_plan, q13, 10000),
        PlanQueryDef("q15", _gen(gen_store_wide, 42), q15_plan, q15, 10000),
        PlanQueryDef("q20", _gen(gen_catalog, 23), q20_plan, q20, 10000),
        PlanQueryDef("q26", _gen(gen_catalog, 23), q26_plan, q26, 10000),
        PlanQueryDef("q27", _gen(gen_store_wide, 42), q27_plan, q27, 10000),
        PlanQueryDef("q28", _gen(gen_store_wide, 42), q28_plan, q28, 10000),
        PlanQueryDef("q30", _gen(gen_store_returns, 21), q30_plan, q30, 8000),
        PlanQueryDef("q32", _gen(gen_catalog, 23), q32_plan, q32, 10000),
        PlanQueryDef("q34", _gen(gen_store_wide, 42), q34_plan, q34, 10000),
        PlanQueryDef("q35", _gen(gen_channels, 29), q35_plan, q35, 6000),
        PlanQueryDef("q38", _gen(gen_channels, 29), q38_plan, q38, 6000),
        PlanQueryDef("q39", _gen(gen_store_wide, 42), q39_plan, q39, 10000),
        PlanQueryDef("q43", _gen(gen_store_wide, 42), q43_plan, q43, 10000),
        PlanQueryDef("q48", _gen(gen_store_wide, 42), q48_plan, q48, 10000),
        PlanQueryDef("q65", _gen(gen_store_wide, 42), q65_plan, q65, 10000),
        PlanQueryDef("q69", _gen(gen_channels, 29), q69_plan, q69, 6000),
        PlanQueryDef("q73", _gen(gen_store_wide, 42), q73_plan, q73, 10000),
        PlanQueryDef("q87", _gen(gen_channels, 29), q87_plan, q87, 6000),
        PlanQueryDef("q88", _gen(gen_store_wide, 42), q88_plan, q88, 10000),
        PlanQueryDef("q92", _gen(gen_web, 7), q92_plan, q92, 8000),
        PlanQueryDef("q96", _gen(gen_store_wide, 42), q96_plan, q96, 10000),
    )
}
