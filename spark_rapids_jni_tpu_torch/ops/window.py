"""Window functions: ranks, row numbers, lag/lead, and partitioned
aggregates over ordered frames (port of the JAX package's
``ops/window.py``).

The formulation is the reference's, sort + segmented scans:

1. one stable sort by (partition keys, order keys) (``ops/sort``),
2. segment ids from partition-key neighbour equality (``ops/aggregate``),
3. ranks and cumulative frames as segmented scans: a segmented cumsum is
   ``cumsum(x) - running_total_at_segment_entry``; rank ties resolve with
   one global cummax over tie-run start positions (every segment start
   opens a run),
4. full-partition aggregates reuse the exact group-by reductions
   (``aggregate._agg_column``: FLOAT64 sums and means through
   ``ops/f64acc``, min/max through the total-order keys), gathered back
   per row,
5. results come back in the caller's original row order through the
   inverse sort permutation.

Exactness: ranks, counts, row numbers, lag/lead and integer cumsums are
exact; full-partition FLOAT64 SUM/MEAN are correctly rounded. A FLOAT64
cumsum is a float64 scan, so its error is relative to the GLOBAL prefix
at each row (the segment-entry subtraction), not to the partition's own
sum; the scan's association is the backend's, so its bits are not the
reference's. The port computes in float64 everywhere and has no
double-f32 branch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import TypeId
from . import bitutils
from .aggregate import _agg_column, _keys_equal_neighbor, _segment_ids
from .sort import sorted_order
from ..utils.dispatch import op_boundary

__all__ = ["window_aggregate"]

_RANKS = ("row_number", "rank", "dense_rank")
_SHIFTS = ("lag", "lead")
_FULL_AGGS = ("sum", "mean", "min", "max", "count", "var", "std",
              "var_pop", "stddev_pop")
_SUPPORTED = _RANKS + _SHIFTS + _FULL_AGGS + ("cumsum",)
# order-defined results: ranking, shifting or scanning an arbitrary sort
# order would be a wrong answer, not a default
_ORDER_REQUIRED = ("rank", "dense_rank", "lag", "lead", "cumsum")


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    n = order.shape[0]
    inv = torch.empty((n,), dtype=torch.int64, device=order.device)
    inv[order.to(torch.int64)] = torch.arange(n, dtype=torch.int64, device=order.device)
    return inv


def _segment_starts(seg: torch.Tensor, num: int) -> torch.Tensor:
    """[num] first sorted-row index of each segment."""
    return torch.searchsorted(seg.to(torch.int64),
                              torch.arange(num, dtype=torch.int64, device=seg.device), side="left")


def _segmented_cumsum(x: torch.Tensor, seg: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented cumsum in ``x``'s own type: the global cumsum
    minus the running total at each segment's entry point."""
    c = torch.cumsum(x, 0, dtype=x.dtype)
    prev = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    return c - prev[starts][seg]


@op_boundary("window_aggregate")
def window_aggregate(
    table: Table,
    partition_by: Sequence[str],
    order_by: Sequence[Tuple[str, bool]],
    aggs: Sequence[Tuple[str, str, str]],
) -> Table:
    """Evaluate window functions over ``table``.

    ``partition_by``: partition key column names (empty = one global
    partition). ``order_by``: [(column, ascending)] within-partition
    order, required (ValueError otherwise) for rank/dense_rank/lag/lead/
    cumsum; row_number with an empty order_by numbers rows in the stable
    sort's order; full-partition aggregates ignore it. ``aggs``:
    [(source_col, how, out_name)] with how in {row_number, rank,
    dense_rank, lag, lead, sum, mean, min, max, count, var, std, var_pop,
    stddev_pop, cumsum}; lag/lead read offset 1 with NULL at partition
    edges; source_col is ignored by the rank family.

    Returns the input table with the window columns appended, in the
    original row order.
    """
    for _, how, _ in aggs:
        if how not in _SUPPORTED:
            raise ValueError(f"unknown window function {how!r}")
        if how in _ORDER_REQUIRED and not order_by:
            raise ValueError(
                f"window function {how!r} requires a non-empty order_by "
                f"(its result is defined by within-partition order)"
            )
    n = table.num_rows
    out_cols: List[Column] = list(table.columns)
    names: List[str] = list(table.names)
    dev = table.columns[0].device
    if n == 0:
        for src, how, out in aggs:
            d = _out_dtype(table.column(src).dtype, how)
            out_cols.append(Column(d, data=torch.zeros((0,), dtype=d.torch_dtype, device=dev)))
            names.append(out)
        return Table(out_cols, names)

    part_tbl = (
        table.select(list(partition_by))
        if partition_by
        else Table([Column(dt.INT32, data=torch.zeros((n,), dtype=torch.int32, device=dev))],
                   ["__g"])
    )
    sort_cols: List[Column] = list(part_tbl.columns)
    sort_names = list(part_tbl.names)
    ascending = [True] * len(sort_cols)
    for name, asc in order_by:
        sort_cols.append(table.column(name))
        sort_names.append(f"__o_{name}")
        ascending.append(bool(asc))
    order = sorted_order(Table(sort_cols, sort_names), ascending=ascending).to(torch.int64)
    seg, num = _segment_ids(part_tbl, order)
    seg = seg.to(torch.int64)
    starts = _segment_starts(seg, num)
    pos = torch.arange(n, dtype=torch.int32, device=dev) - starts[seg].to(torch.int32)
    inv = _inverse_permutation(order)

    # tie runs for rank/dense_rank: a sorted row opens a new run when any
    # ORDER key differs from its predecessor or the partition changes
    first = torch.ones((1,), dtype=torch.bool, device=dev)
    if order_by:
        eq = torch.ones((n - 1,), dtype=torch.bool, device=dev)
        for name, _asc in order_by:
            eq = eq & _keys_equal_neighbor(table.column(name), order)
        same_order = torch.cat([~first, eq])
    else:
        same_order = torch.zeros((n,), dtype=torch.bool, device=dev)
    new_run = ~same_order | torch.cat([first, seg[1:] != seg[:-1]])

    for src, how, out in aggs:
        out_cols.append(_one_window(table, src, how, order, seg, num, starts, pos, new_run, inv))
        names.append(out)
    return Table(out_cols, names)


def _out_dtype(src_dtype, how: str):
    """The result type of an empty table's window column (the reference's
    table: a non-empty integer sum or cumsum gives INT64)."""
    if how in _RANKS:
        return dt.INT32
    if how == "count":
        return dt.INT64
    if how in ("mean", "var", "std", "var_pop", "stddev_pop"):
        return dt.FLOAT64
    return src_dtype


def _one_window(table, src, how, order, seg, num, starts, pos, new_run, inv) -> Column:
    n = seg.shape[0]
    dev = seg.device
    if how == "row_number":
        return Column(dt.INT32, data=(pos + 1)[inv])
    if how == "dense_rank":
        dr = _segmented_cumsum(new_run.to(torch.int32), seg, starts)
        return Column(dt.INT32, data=dr[inv])
    if how == "rank":
        # competition rank = tie-run start position within the segment + 1
        ar = torch.arange(n, dtype=torch.int32, device=dev)
        r = torch.cummax(torch.where(new_run, ar, -1), 0).values
        return Column(dt.INT32, data=(r - starts[seg].to(torch.int32) + 1)[inv])

    col = table.column(src)
    if how in _SHIFTS:
        if col.dtype.id in (TypeId.STRING, TypeId.LIST):
            raise NotImplementedError("lag/lead over variable-width columns not lowered")
        shift = 1 if how == "lag" else -1
        idx = torch.arange(n, dtype=torch.int64, device=dev) - shift
        cidx = idx.clamp(0, n - 1)
        ok = (idx >= 0) & (idx <= n - 1) & (seg[cidx] == seg)
        valid_sorted = col.valid_mask()[order]
        shifted = col.data[order][cidx]
        v = valid_sorted[cidx] & ok
        return Column(col.dtype, data=shifted[inv], validity=v[inv])

    if how == "cumsum":
        valid_sorted = col.valid_mask()[order]
        has_prior = _segmented_cumsum(valid_sorted.to(torch.int32), seg, starts) > 0
        if col.dtype.id == TypeId.FLOAT64:
            x = bitutils.float_view(col.data, col.dtype)[order]
            x = torch.where(valid_sorted, x, 0.0)
            bits = bitutils.float_store(_segmented_cumsum(x, seg, starts), dt.FLOAT64)
            return Column(dt.FLOAT64, data=bits[inv], validity=has_prior[inv])
        x = col.data[order]
        if x.is_floating_point():
            d = col.dtype
        else:
            x, d = x.to(torch.int64), dt.INT64
        x = torch.where(valid_sorted, x, torch.zeros((), dtype=x.dtype, device=dev))
        return Column(d, data=_segmented_cumsum(x, seg, starts)[inv], validity=has_prior[inv])

    # full-partition aggregates: the exact group-by reductions, per-group
    # results gathered back to rows
    g = _agg_column(col, order, seg, num, how)
    data = g.data[seg][inv]
    validity = None if g.validity is None else g.validity[seg][inv]
    return Column(g.dtype, data=data, validity=validity)
