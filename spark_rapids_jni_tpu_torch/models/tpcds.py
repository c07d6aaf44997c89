"""TPC-DS single-chip queries (port of the JAX package's
``models/tpcds.py``, BASELINE.json configs[2] and [3]): q3 (a two-way
star join, GROUP BY and ORDER BY), the reporting family q42/q52/q55,
q7 and q19 (four- and five-way star joins), q94/q95 (per-order
multi-warehouse detection, semi and anti joins, exact totals) and q98
(a star-join aggregation, then a partitioned window sum).

Dimension values that are strings in the specification are dictionary
codes in INT32 lanes; money columns are FLOAT64 (IEEE bits in int64
lanes). The generators draw on the host with numpy, draw for draw as the
JAX package draws them, so the same (rows, seed) gives the same table
bits in both packages; the columns then land on ``device`` (None means
the card). Each star query runs through one ``pipeline.CompiledPipeline``
stage whose bounded domains come from host reads of the dimension
tables; FLOAT64 sums and means are exact (``ops/f64acc``).

The ``*_distributed`` variants need the mesh operators, which are not
ported yet, and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.column import resolve_device
from ..ops import copying
from ..ops.aggregate import groupby_aggregate
from ..ops.expressions import col, lit
from ..ops.f64acc import segment_sum_f64bits
from ..ops.join import left_anti_join, left_semi_join
from ..ops.sort import sort_by_key
from ..ops.window import window_aggregate
from ..pipeline import Agg, GroupKey, JoinSpec, PlanSpec, compile_plan

__all__ = [
    "gen_store", "gen_store_wide", "gen_web",
    "q3", "q7", "q7_distributed", "q19", "q19_distributed",
    "q42", "q52", "q52_distributed", "q55", "q55_distributed",
    "q94", "q94_distributed", "q95", "q95_distributed", "q98",
]

_DISTRIBUTED = ("the distributed Table operators are not ported yet "
                "(ROADMAP.md, Open items, section 1, item 10)")


def _exact_total(c: Column) -> float:
    """Exact grand total of a FLOAT64 column: a one-segment exact
    accumulation, read back as float64."""
    bits = c.data
    if bits.shape[0] == 0:
        return 0.0
    seg = torch.zeros((bits.shape[0],), dtype=torch.int32, device=bits.device)
    return float(segment_sum_f64bits(bits, seg, 1).cpu().numpy().view(np.float64)[0])


def _int_col(arr: np.ndarray, dev: torch.device) -> Column:
    return Column.from_numpy(arr, dt.INT32, device=dev)


def _f64_col(arr: np.ndarray, dev: torch.device) -> Column:
    return Column.from_numpy(arr, dt.FLOAT64, device=dev)


def _max(t: Table, name: str) -> int:
    """Host read of a (dimension) column's largest value."""
    return int(t.column(name).data.max())


def gen_store(num_sales: int, seed: int = 42, device=None) -> Dict[str, Table]:
    """store_sales + date_dim + item star for q3 (and q42/q52/q55/q98)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_dates, n_items = 365 * 5, 1000

    date_dim = Table(
        [
            _int_col(np.arange(n_dates), dev),  # d_date_sk
            _int_col(1998 + np.arange(n_dates) // 365, dev),  # d_year
            _int_col(1 + (np.arange(n_dates) % 365) // 31, dev),  # d_moy (approx calendar)
        ],
        ["d_date_sk", "d_year", "d_moy"],
    )
    item = Table(
        [
            _int_col(np.arange(n_items), dev),  # i_item_sk
            _int_col(rng.integers(1, 1000, n_items), dev),  # i_manufact_id
            _int_col(rng.integers(1, 500, n_items), dev),  # i_brand_id (dict code)
            _int_col(rng.integers(1, 100, n_items), dev),  # i_manager_id
        ],
        ["i_item_sk", "i_manufact_id", "i_brand_id", "i_manager_id"],
    )
    store_sales = Table(
        [
            _int_col(rng.integers(0, n_dates, num_sales), dev),  # ss_sold_date_sk
            _int_col(rng.integers(0, n_items, num_sales), dev),  # ss_item_sk
            _f64_col(rng.uniform(1, 1000, num_sales).round(2), dev),  # ss_ext_sales_price
        ],
        ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    )
    # drawn after the fact columns, as the reference draws it
    item = Table(
        list(item.columns) + [_int_col(rng.integers(1, 12, n_items), dev)],  # i_category_id
        list(item.names) + ["i_category_id"],
    )
    return {"store_sales": store_sales, "date_dim": date_dim, "item": item}


def gen_store_wide(num_sales: int, seed: int = 42, device=None) -> Dict[str, Table]:
    """The store-sales star for the q7/q19 class: fact + date_dim + item +
    customer_demographics + promotion + customer + customer_address +
    store (+ household_demographics and time_dim)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_dates, n_items = 365 * 5, 1000
    n_cdemo, n_promo, n_cust, n_addr, n_store = 200, 50, 2000, 500, 20

    def ints(lo, hi, n):
        return _int_col(rng.integers(lo, hi, n), dev)

    date_dim = Table(
        [
            _int_col(np.arange(n_dates), dev),  # d_date_sk
            _int_col(1998 + np.arange(n_dates) // 365, dev),  # d_year
            _int_col(1 + (np.arange(n_dates) % 365) // 31, dev),  # d_moy
        ],
        ["d_date_sk", "d_year", "d_moy"],
    )
    item = Table(
        [
            _int_col(np.arange(n_items), dev),  # i_item_sk
            _int_col(rng.permutation(n_items), dev),  # i_item_id (distinct code)
            ints(1, 500, n_items),  # i_brand_id
            ints(1, 1000, n_items),  # i_manufact_id
            ints(1, 100, n_items),  # i_manager_id
        ],
        ["i_item_sk", "i_item_id", "i_brand_id", "i_manufact_id", "i_manager_id"],
    )
    customer_demographics = Table(
        [
            _int_col(np.arange(n_cdemo), dev),  # cd_demo_sk
            ints(0, 2, n_cdemo),  # cd_gender (code: 1 = 'M')
            ints(0, 5, n_cdemo),  # cd_marital_status (2 = 'S')
            ints(0, 7, n_cdemo),  # cd_education_status (3 = College)
        ],
        ["cd_demo_sk", "cd_gender", "cd_marital_status", "cd_education_status"],
    )
    promotion = Table(
        [
            _int_col(np.arange(n_promo), dev),  # p_promo_sk
            ints(0, 2, n_promo),  # p_channel_email (0 = 'N')
            ints(0, 2, n_promo),  # p_channel_event (0 = 'N')
        ],
        ["p_promo_sk", "p_channel_email", "p_channel_event"],
    )
    customer = Table(
        [_int_col(np.arange(n_cust), dev), ints(0, n_addr, n_cust)],
        ["c_customer_sk", "c_current_addr_sk"],
    )
    customer_address = Table(
        [_int_col(np.arange(n_addr), dev), ints(0, 300, n_addr)],  # ca_zip5 (prefix code)
        ["ca_address_sk", "ca_zip5"],
    )
    store = Table(
        [_int_col(np.arange(n_store), dev), ints(0, 300, n_store)],  # s_zip5
        ["s_store_sk", "s_zip5"],
    )
    store_sales = Table(
        [
            ints(0, n_dates, num_sales),  # ss_sold_date_sk
            ints(0, n_items, num_sales),  # ss_item_sk
            ints(0, n_cdemo, num_sales),  # ss_cdemo_sk
            ints(0, n_promo, num_sales),  # ss_promo_sk
            ints(0, n_cust, num_sales),  # ss_customer_sk
            ints(0, n_store, num_sales),  # ss_store_sk
            ints(1, 100, num_sales),  # ss_quantity
            _f64_col(rng.uniform(1, 200, num_sales).round(2), dev),  # ss_list_price
            _f64_col(rng.uniform(0, 50, num_sales).round(2), dev),  # ss_coupon_amt
            _f64_col(rng.uniform(1, 150, num_sales).round(2), dev),  # ss_sales_price
            _f64_col(rng.uniform(1, 1000, num_sales).round(2), dev),  # ss_ext_sales_price
        ],
        [
            "ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk", "ss_promo_sk",
            "ss_customer_sk", "ss_store_sk", "ss_quantity", "ss_list_price",
            "ss_coupon_amt", "ss_sales_price", "ss_ext_sales_price",
        ],
    )
    # the star's later columns and tables, drawn after every column above,
    # in the reference's order
    n_hdemo, n_times = 100, 1440
    store = Table(
        list(store.columns) + [ints(0, 10, n_store)],  # s_state (code)
        list(store.names) + ["s_state"],
    )
    store_sales = Table(
        list(store_sales.columns) + [
            ints(0, max(num_sales // 8, 1), num_sales),  # ss_ticket_number
            ints(0, n_hdemo, num_sales),  # ss_hdemo_sk
            ints(0, n_times, num_sales),  # ss_sold_time_sk
        ],
        list(store_sales.names) + ["ss_ticket_number", "ss_hdemo_sk", "ss_sold_time_sk"],
    )
    customer = Table(
        list(customer.columns) + [_int_col(rng.permutation(n_cust), dev)],  # c_customer_id
        list(customer.names) + ["c_customer_id"],
    )
    household_demographics = Table(
        [
            _int_col(np.arange(n_hdemo), dev),  # hd_demo_sk
            ints(0, 10, n_hdemo),  # hd_dep_count
            ints(0, 5, n_hdemo),  # hd_vehicle_count
            ints(0, 6, n_hdemo),  # hd_buy_potential (code)
        ],
        ["hd_demo_sk", "hd_dep_count", "hd_vehicle_count", "hd_buy_potential"],
    )
    time_dim = Table(  # one row per minute
        [
            _int_col(np.arange(n_times), dev),  # t_time_sk
            _int_col(np.arange(n_times) // 60, dev),  # t_hour
            _int_col(np.arange(n_times) % 60, dev),  # t_minute
        ],
        ["t_time_sk", "t_hour", "t_minute"],
    )
    date_dim = Table(
        list(date_dim.columns) + [_int_col(np.arange(n_dates) % 7, dev)],  # d_dow
        list(date_dim.names) + ["d_dow"],
    )
    return {
        "store_sales": store_sales,
        "date_dim": date_dim,
        "item": item,
        "customer_demographics": customer_demographics,
        "promotion": promotion,
        "customer": customer,
        "customer_address": customer_address,
        "store": store,
        "household_demographics": household_demographics,
        "time_dim": time_dim,
    }


def gen_web(num_sales: int, seed: int = 7, device=None) -> Dict[str, Table]:
    """web_sales + web_returns + date_dim (+ item) for q94/q95. Orders have
    about two line items; some span several warehouses; a tenth of the
    orders are returned."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_orders = max(num_sales // 2, 1)
    n_dates = 365 * 5

    order_of_row = rng.integers(0, n_orders, num_sales)
    web_sales = Table(
        [
            _int_col(order_of_row, dev),  # ws_order_number
            _int_col(rng.integers(0, 15, num_sales), dev),  # ws_warehouse_sk
            _int_col(rng.integers(0, n_dates, num_sales), dev),  # ws_ship_date_sk
            _f64_col(rng.uniform(1, 100, num_sales).round(2), dev),  # ws_ext_ship_cost
            _f64_col(rng.uniform(-50, 200, num_sales).round(2), dev),  # ws_net_profit
        ],
        ["ws_order_number", "ws_warehouse_sk", "ws_ship_date_sk", "ws_ext_ship_cost",
         "ws_net_profit"],
    )
    returned = rng.choice(n_orders, size=max(n_orders // 10, 1), replace=False)
    web_returns = Table([_int_col(returned, dev)], ["wr_order_number"])
    date_dim = Table([_int_col(np.arange(n_dates), dev)], ["d_date_sk"])
    # drawn after every column above, in the reference's order
    n_items = 200
    web_sales = Table(
        list(web_sales.columns) + [
            _int_col(rng.integers(0, n_dates, num_sales), dev),  # ws_sold_date_sk
            _int_col(rng.integers(0, n_items, num_sales), dev),  # ws_item_sk
            _f64_col(rng.uniform(0, 100, num_sales).round(2), dev),  # ws_ext_discount_amt
        ],
        list(web_sales.names) + ["ws_sold_date_sk", "ws_item_sk", "ws_ext_discount_amt"],
    )
    item = Table(
        [
            _int_col(np.arange(n_items), dev),  # i_item_sk
            _int_col(rng.integers(1, 100, n_items), dev),  # i_manufact_id
        ],
        ["i_item_sk", "i_manufact_id"],
    )
    return {"web_sales": web_sales, "web_returns": web_returns,
            "date_dim": date_dim, "item": item}


# -- q3 --------------------------------------------------------------------------


def q3(tables: Dict[str, Table], manufact_id: int = 128, month: int = 11) -> Table:
    """SELECT d_year, i_brand_id, sum(ss_ext_sales_price) sum_agg
    FROM date_dim, store_sales, item
    WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
      AND i_manufact_id = :m AND d_moy = :mo
    GROUP BY d_year, i_brand_id
    ORDER BY d_year, sum_agg DESC, i_brand_id
    """
    item = tables["item"]
    dates = tables["date_dim"]
    # the bounded domains come from the dimension tables (host reads)
    year_lo = int(dates.column("d_year").data.min())
    year_hi = _max(dates, "d_year")
    agg = _q3_pipeline(
        year_lo, year_hi - year_lo + 1, _max(item, "i_brand_id") + 1,
        _max(dates, "d_date_sk") + 1, _max(item, "i_item_sk") + 1, int(manufact_id), int(month),
    )(tables["store_sales"], {"date_dim": dates, "item": item})
    agg = Table(
        [
            Column(dt.INT32, data=agg.column("year_idx").data + year_lo),
            agg.column("i_brand_id"),
            agg.column("ss_ext_sales_price_sum"),
        ],
        ["d_year", "i_brand_id", "ss_ext_sales_price_sum"],
    )
    order_keys = Table(
        [agg.column("d_year"), agg.column("ss_ext_sales_price_sum"), agg.column("i_brand_id")],
        ["d_year", "s", "b"],
    )
    return sort_by_key(agg, order_keys, ascending=[True, False, True])


def _q3_pipeline(year_lo: int, n_years: int, n_brands: int, n_dates: int, n_items: int,
                 manufact_id: int, month: int):
    return compile_plan(
        PlanSpec(
            joins=(
                JoinSpec(
                    build="date_dim", probe_key="ss_sold_date_sk", build_key="d_date_sk",
                    num_keys=n_dates, payload=("d_year",),
                    build_filter=col("d_moy") == lit(np.int32(month)),
                ),
                JoinSpec(
                    build="item", probe_key="ss_item_sk", build_key="i_item_sk",
                    num_keys=n_items, payload=("i_brand_id",),
                    build_filter=col("i_manufact_id") == lit(np.int32(manufact_id)),
                ),
            ),
            project=(("year_idx", col("d_year") - lit(np.int32(year_lo))),),
            group_by=(GroupKey("year_idx", n_years), GroupKey("i_brand_id", n_brands)),
            aggregates=(Agg("ss_ext_sales_price", "sum", "ss_ext_sales_price_sum"),),
        )
    )


# -- q7 / q19 ----------------------------------------------------------------------


def q7(
    tables: Dict[str, Table],
    gender: int = 1,
    marital: int = 2,
    education: int = 3,
    year: int = 2000,
) -> Table:
    """TPC-DS q7, the four-way star join with four exact means. SQL:

        SELECT i_item_id, avg(ss_quantity) agg1, avg(ss_list_price) agg2,
               avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
        FROM store_sales, customer_demographics, date_dim, item, promotion
        WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
          AND ss_cdemo_sk = cd_demo_sk AND ss_promo_sk = p_promo_sk
          AND cd_gender = :g AND cd_marital_status = :m
          AND cd_education_status = :e
          AND (p_channel_email = 'N' OR p_channel_event = 'N')
          AND d_year = :y
        GROUP BY i_item_id ORDER BY i_item_id

    The integer mean goes through ``f64acc.mean_i64_div``, the FLOAT64
    means through ``f64acc.segment_mean_f64bits``."""
    item = tables["item"]
    agg = _q7_pipeline(
        _max(item, "i_item_id") + 1, _max(tables["date_dim"], "d_date_sk") + 1,
        _max(item, "i_item_sk") + 1, _max(tables["customer_demographics"], "cd_demo_sk") + 1,
        _max(tables["promotion"], "p_promo_sk") + 1,
        int(gender), int(marital), int(education), int(year),
    )(
        tables["store_sales"],
        {
            "date_dim": tables["date_dim"],
            "item": item,
            "customer_demographics": tables["customer_demographics"],
            "promotion": tables["promotion"],
        },
    )
    return sort_by_key(agg, agg.select(["i_item_id"]), ascending=[True])


def _q7_pipeline(n_item_ids: int, n_dates: int, n_items: int, n_cdemo: int,
                 n_promo: int, gender: int, marital: int, education: int, year: int):
    return compile_plan(
        PlanSpec(
            joins=(
                JoinSpec(
                    build="date_dim", probe_key="ss_sold_date_sk", build_key="d_date_sk",
                    num_keys=n_dates,
                    build_filter=col("d_year") == lit(np.int32(year)),
                ),
                JoinSpec(
                    build="customer_demographics", probe_key="ss_cdemo_sk",
                    build_key="cd_demo_sk", num_keys=n_cdemo,
                    build_filter=(col("cd_gender") == lit(np.int32(gender)))
                    & (col("cd_marital_status") == lit(np.int32(marital)))
                    & (col("cd_education_status") == lit(np.int32(education))),
                ),
                JoinSpec(
                    build="promotion", probe_key="ss_promo_sk", build_key="p_promo_sk",
                    num_keys=n_promo,
                    build_filter=(col("p_channel_email") == lit(np.int32(0)))
                    | (col("p_channel_event") == lit(np.int32(0))),
                ),
                JoinSpec(
                    build="item", probe_key="ss_item_sk", build_key="i_item_sk",
                    num_keys=n_items, payload=("i_item_id",),
                ),
            ),
            group_by=(GroupKey("i_item_id", n_item_ids),),
            aggregates=(
                Agg("ss_quantity", "mean", "agg1"),
                Agg("ss_list_price", "mean", "agg2"),
                Agg("ss_coupon_amt", "mean", "agg3"),
                Agg("ss_sales_price", "mean", "agg4"),
            ),
        )
    )


def q7_distributed(tables: Dict[str, Table], mesh, gender: int = 1, marital: int = 2,
                   education: int = 3, year: int = 2000) -> Table:
    raise NotImplementedError(_DISTRIBUTED)


def q19(
    tables: Dict[str, Table], manager_id: int = 8, month: int = 11, year: int = 1998
) -> Table:
    """TPC-DS q19, a five-way star join with a cross-dimension inequality
    (customer zip != store zip) on joined payload columns. SQL:

        SELECT i_brand_id, i_manufact_id, sum(ss_ext_sales_price) ext_price
        FROM date_dim, store_sales, item, customer, customer_address, store
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = :mgr AND d_moy = :moy AND d_year = :yr
          AND ss_customer_sk = c_customer_sk
          AND c_current_addr_sk = ca_address_sk
          AND substr(ca_zip,1,5) <> substr(s_zip,1,5)
          AND ss_store_sk = s_store_sk
        GROUP BY i_brand_id, i_manufact_id
        ORDER BY ext_price DESC, i_brand_id, i_manufact_id

    The customer join's payload (c_current_addr_sk) is the next join's
    probe key, and the zip comparison is the plan filter over two
    payloads."""
    item = tables["item"]
    agg = _q19_pipeline(
        _max(item, "i_brand_id") + 1, _max(item, "i_manufact_id") + 1,
        _max(tables["date_dim"], "d_date_sk") + 1, _max(item, "i_item_sk") + 1,
        _max(tables["customer"], "c_customer_sk") + 1,
        _max(tables["customer_address"], "ca_address_sk") + 1,
        _max(tables["store"], "s_store_sk") + 1,
        int(manager_id), int(month), int(year),
    )(
        tables["store_sales"],
        {
            "date_dim": tables["date_dim"],
            "item": item,
            "customer": tables["customer"],
            "customer_address": tables["customer_address"],
            "store": tables["store"],
        },
    )
    order_keys = Table(
        [agg.column("ext_price"), agg.column("i_brand_id"), agg.column("i_manufact_id")],
        ["p", "b", "m"],
    )
    return sort_by_key(agg, order_keys, ascending=[False, True, True])


def _q19_pipeline(n_brands: int, n_manufact: int, n_dates: int, n_items: int,
                  n_cust: int, n_addr: int, n_store: int, manager_id: int,
                  month: int, year: int):
    return compile_plan(
        PlanSpec(
            joins=(
                JoinSpec(
                    build="date_dim", probe_key="ss_sold_date_sk", build_key="d_date_sk",
                    num_keys=n_dates,
                    build_filter=(col("d_moy") == lit(np.int32(month)))
                    & (col("d_year") == lit(np.int32(year))),
                ),
                JoinSpec(
                    build="item", probe_key="ss_item_sk", build_key="i_item_sk",
                    num_keys=n_items, payload=("i_brand_id", "i_manufact_id"),
                    build_filter=col("i_manager_id") == lit(np.int32(manager_id)),
                ),
                JoinSpec(
                    build="customer", probe_key="ss_customer_sk",
                    build_key="c_customer_sk", num_keys=n_cust,
                    payload=("c_current_addr_sk",),
                ),
                JoinSpec(
                    # the probe key is the previous join's payload
                    build="customer_address", probe_key="c_current_addr_sk",
                    build_key="ca_address_sk", num_keys=n_addr, payload=("ca_zip5",),
                ),
                JoinSpec(
                    build="store", probe_key="ss_store_sk", build_key="s_store_sk",
                    num_keys=n_store, payload=("s_zip5",),
                ),
            ),
            filter=col("ca_zip5") != col("s_zip5"),
            group_by=(
                GroupKey("i_brand_id", n_brands),
                GroupKey("i_manufact_id", n_manufact),
            ),
            aggregates=(Agg("ss_ext_sales_price", "sum", "ext_price"),),
        )
    )


def q19_distributed(tables: Dict[str, Table], mesh, manager_id: int = 8, month: int = 11,
                    year: int = 1998) -> Table:
    raise NotImplementedError(_DISTRIBUTED)


# -- the reporting family: q42, q52, q55 --------------------------------------------


def _attach_year_and_sort(agg: Table, year: int, key_col: str, order_cols, ascending) -> Table:
    """Epilogue of q42/q52: re-attach the constant d_year the year filter
    consumed, then ORDER BY."""
    agg = Table(
        [
            Column(dt.INT32, data=torch.full((agg.num_rows,), year, dtype=torch.int32,
                                             device=agg.columns[0].device)),
            agg.column(key_col),
            agg.column("ext_price"),
        ],
        ["d_year", key_col, "ext_price"],
    )
    order_keys = Table(
        [agg.column(c) for c in order_cols], [f"k{i}" for i in range(len(order_cols))]
    )
    return sort_by_key(agg, order_keys, ascending=list(ascending))


def q42(tables: Dict[str, Table], manager_id: int = 1, month: int = 11, year: int = 2000) -> Table:
    """TPC-DS q42 (category revenue for a manager-month). SQL:

        SELECT d_year, i_category_id, sum(ss_ext_sales_price)
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = :mgr AND d_moy = :moy AND d_year = :yr
        GROUP BY d_year, i_category_id
        ORDER BY sum DESC, d_year, i_category_id
    """
    item = tables["item"]
    agg = _q42_pipeline(_max(item, "i_category_id") + 1, int(manager_id), int(month), int(year))(
        tables["store_sales"], {"date_dim": tables["date_dim"], "item": item}
    )
    return _attach_year_and_sort(
        agg, year, "i_category_id",
        ["ext_price", "d_year", "i_category_id"], [False, True, True],
    )


def _manager_month_joins(manager_id: int, month: int, year: int, payload):
    """The date and item sort-merge joins (``num_keys=None``) of the
    manager-month reports."""
    return (
        JoinSpec(
            build="date_dim", probe_key="ss_sold_date_sk",
            build_key="d_date_sk", num_keys=None,
            build_filter=(col("d_moy") == lit(month)) & (col("d_year") == lit(year)),
        ),
        JoinSpec(
            build="item", probe_key="ss_item_sk",
            build_key="i_item_sk", num_keys=None, payload=payload,
            build_filter=col("i_manager_id") == lit(manager_id),
        ),
    )


def _q42_pipeline(n_cats: int, manager_id: int, month: int, year: int):
    return compile_plan(
        PlanSpec(
            joins=_manager_month_joins(manager_id, month, year, ("i_category_id",)),
            group_by=(GroupKey("i_category_id", n_cats),),
            aggregates=(Agg("ss_ext_sales_price", "sum", "ext_price"),),
        )
    )


def q52(tables: Dict[str, Table], manager_id: int = 1, month: int = 11, year: int = 2000) -> Table:
    """TPC-DS q52 (brand revenue for a manager-month, d_year carried
    through; q55's plan). SQL:

        SELECT d_year, i_brand_id, sum(ss_ext_sales_price) ext_price
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = :mgr AND d_moy = :moy AND d_year = :yr
        GROUP BY d_year, i_brand_id ORDER BY d_year, ext_price DESC, i_brand_id
    """
    item = tables["item"]
    agg = _q55_pipeline(_max(item, "i_brand_id") + 1, int(manager_id), int(month), int(year))(
        tables["store_sales"], {"date_dim": tables["date_dim"], "item": item}
    )
    return _attach_year_and_sort(
        agg, year, "i_brand_id", ["d_year", "ext_price", "i_brand_id"], [True, False, True]
    )


def q52_distributed(tables: Dict[str, Table], mesh, manager_id: int = 1, month: int = 11,
                    year: int = 2000) -> Table:
    raise NotImplementedError(_DISTRIBUTED)


def q55(tables: Dict[str, Table], manager_id: int = 28, month: int = 11, year: int = 1999) -> Table:
    """TPC-DS q55 (brand revenue for one manager-month). SQL:

        SELECT i_brand_id, sum(ss_ext_sales_price) ext_price
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = :mgr AND d_moy = :moy AND d_year = :yr
        GROUP BY i_brand_id ORDER BY ext_price DESC, i_brand_id

    Both star joins are the pipeline's sort-merge lowering: no bounded
    join domain is declared."""
    item = tables["item"]
    agg = _q55_pipeline(_max(item, "i_brand_id") + 1, int(manager_id), int(month), int(year))(
        tables["store_sales"], {"date_dim": tables["date_dim"], "item": item}
    )
    order_keys = Table([agg.column("ext_price"), agg.column("i_brand_id")], ["p", "b"])
    return sort_by_key(agg, order_keys, ascending=[False, True])


def _q55_pipeline(n_brands: int, manager_id: int, month: int, year: int):
    return compile_plan(
        PlanSpec(
            joins=_manager_month_joins(manager_id, month, year, ("i_brand_id",)),
            group_by=(GroupKey("i_brand_id", n_brands),),
            aggregates=(Agg("ss_ext_sales_price", "sum", "ext_price"),),
        )
    )


def q55_distributed(tables: Dict[str, Table], mesh, manager_id: int = 28, month: int = 11,
                    year: int = 1999) -> Table:
    raise NotImplementedError(_DISTRIBUTED)


# -- q98 -------------------------------------------------------------------------


def q98(tables: Dict[str, Table], month: int = 11, year: int = 2000) -> Table:
    """TPC-DS q98's shape, the window-ratio report: item revenue with each
    item's share of its category. SQL shape:

        SELECT i_category, i_class(-> brand here), sum(ss_ext_sales_price) itemrevenue,
               sum(ss_ext_sales_price) * 100 /
                 sum(sum(ss_ext_sales_price)) OVER (PARTITION BY i_category) revenueratio
        FROM store_sales, item, date_dim
        WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
          AND d_moy = :moy AND d_year = :yr
        GROUP BY i_category, i_class ORDER BY i_category, revenueratio

    The partitioned sum is exact, so the ratio's numerator and
    denominator are both correctly rounded."""
    item = tables["item"]
    agg = _q98_pipeline(_max(item, "i_category_id") + 1, _max(item, "i_brand_id") + 1,
                        int(month), int(year))(
        tables["store_sales"], {"date_dim": tables["date_dim"], "item": item}
    )
    w = window_aggregate(agg, ["i_category_id"], [], [("itemrevenue", "sum", "cat_total")])
    ratio = ((col("itemrevenue") * lit(100.0)) / col("cat_total")).evaluate(w)
    out = Table(
        [w.column("i_category_id"), w.column("i_brand_id"), w.column("itemrevenue"), ratio],
        ["i_category_id", "i_brand_id", "itemrevenue", "revenueratio"],
    )
    order_keys = Table(
        [out.column("i_category_id"), out.column("revenueratio"), out.column("i_brand_id")],
        ["c", "r", "b"],
    )
    return sort_by_key(out, order_keys, ascending=[True, True, True])


def _q98_pipeline(n_cats: int, n_brands: int, month: int, year: int):
    return compile_plan(
        PlanSpec(
            joins=(
                JoinSpec(
                    build="date_dim", probe_key="ss_sold_date_sk",
                    build_key="d_date_sk", num_keys=None,
                    build_filter=(col("d_moy") == lit(month)) & (col("d_year") == lit(year)),
                ),
                JoinSpec(
                    build="item", probe_key="ss_item_sk",
                    build_key="i_item_sk", num_keys=None,
                    payload=("i_category_id", "i_brand_id"),
                ),
            ),
            group_by=(
                GroupKey("i_category_id", n_cats),
                GroupKey("i_brand_id", n_brands),
            ),
            aggregates=(Agg("ss_ext_sales_price", "sum", "itemrevenue"),),
        )
    )


# -- q94 / q95 -------------------------------------------------------------------


def _q95_family(tables: Dict[str, Table], returns_how: str, ship_lo: int, ship_hi: int) -> dict:
    """The plan q95 (EXISTS returns) and q94 (NOT EXISTS returns) share:
    per-order multi-warehouse detection, the ship-date filter, a semi join
    on the multi-warehouse orders, then a semi (q95) or anti (q94) join on
    the returned orders, per-order sums and exact totals."""
    ws = tables["web_sales"]
    per_order = groupby_aggregate(
        ws.select(["ws_order_number"]),
        ws.select(["ws_warehouse_sk"]),
        [("ws_warehouse_sk", "min"), ("ws_warehouse_sk", "max")],
    )
    multi = (col("ws_warehouse_sk_min") != col("ws_warehouse_sk_max")).evaluate(per_order)
    ws_wh = copying.apply_boolean_mask(per_order, multi).select(["ws_order_number"])

    wr = tables["web_returns"]
    wr_keys = Table(wr.select(["wr_order_number"]).columns, ["ws_order_number"])

    pred = (
        (col("ws_ship_date_sk") >= lit(np.int32(ship_lo)))
        & (col("ws_ship_date_sk") <= lit(np.int32(ship_hi)))
    ).evaluate(ws)
    ws1 = copying.apply_boolean_mask(ws, pred)
    ws1 = left_semi_join(ws1, ws_wh, on=["ws_order_number"])
    join2 = left_anti_join if returns_how == "left_anti" else left_semi_join
    ws1 = join2(ws1, wr_keys, on=["ws_order_number"])
    per = groupby_aggregate(
        ws1.select(["ws_order_number"]),
        ws1.select(["ws_ext_ship_cost", "ws_net_profit"]),
        [("ws_ext_ship_cost", "sum"), ("ws_net_profit", "sum")],
    )
    return {
        "order_count": int(per.num_rows),
        "total_shipping_cost": _exact_total(per.column("ws_ext_ship_cost_sum")),
        "total_net_profit": _exact_total(per.column("ws_net_profit_sum")),
    }


def q94(tables: Dict[str, Table], ship_lo: int = 400, ship_hi: int = 460) -> dict:
    """TPC-DS q94, q95's NOT EXISTS variant: returned orders are excluded
    through a left anti join."""
    return _q95_family(tables, "left_anti", int(ship_lo), int(ship_hi))


def q94_distributed(tables: Dict[str, Table], mesh, ship_lo: int = 400,
                    ship_hi: int = 460) -> dict:
    raise NotImplementedError(_DISTRIBUTED)


def q95(tables: Dict[str, Table], ship_lo: int = 400, ship_hi: int = 460) -> dict:
    """Returned-order shipping report. SQL shape:

        WITH ws_wh AS (SELECT ws_order_number FROM web_sales
                       GROUP BY ws_order_number
                       HAVING count(distinct ws_warehouse_sk) > 1)
        SELECT count(distinct ws_order_number), sum(ws_ext_ship_cost),
               sum(ws_net_profit)
        FROM web_sales ws1
        WHERE ws_ship_date_sk BETWEEN :lo AND :hi
          AND ws_order_number IN (SELECT * FROM ws_wh)
          AND ws_order_number IN (SELECT wr_order_number FROM web_returns)

    The IN-subqueries run as left semi joins (the plan Spark produces for
    IN)."""
    return _q95_family(tables, "left_semi", int(ship_lo), int(ship_hi))


def q95_distributed(tables: Dict[str, Table], mesh, ship_lo: int = 400,
                    ship_hi: int = 460) -> dict:
    raise NotImplementedError(_DISTRIBUTED)
