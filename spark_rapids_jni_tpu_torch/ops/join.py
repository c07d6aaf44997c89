"""Equi-join tier: inner, left, full outer, left semi and left anti joins
(port of the JAX package's ``ops/join.py``, cudf hash-join semantics).

Two formulations give bit-identical gather maps:

- **Paged** (inner and left joins on one integer key of the same type on
  both sides): the build side goes into ``paged_join.build_paged_table``
  once, and B4 (``hopper_kernels.probe_paged``) gives each probe row its
  contiguous match range over the (bucket, key, row)-sorted build ranks.
- **Sort-probe** (every other shape, and a build side the table refuses:
  empty, all-null, over 65,536 rows or 2,048 pages): factorize both
  sides' keys into dense ids with one sort of the concatenated keys,
  sort the right ids, and probe each left id with two searchsorted
  calls.

Both expand match ranges into (left, right) pairs the same way, and both
list equal keys in build-row order, so the maps agree pair for pair.
Maps are int32 with -1 marking the null-extended side. Null keys never
match: inner joins drop such rows, left joins keep them with a null right
side.

Only the shape and size gates above choose the sort-probe; a failure to
build or launch B4 on the card propagates.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import Column, Table
from ..columnar.dtype import TypeId
from .aggregate import _segment_ids
from .copying import concatenate, gather, gather_column
from .hopper_kernels import probe_paged
from .paged_join import build_paged_table
from .sort import sorted_order

__all__ = [
    "join_gather_maps",
    "semi_anti_gather_map",
    "inner_join",
    "left_join",
    "full_join",
    "left_semi_join",
    "left_anti_join",
]


def _factorize(left_keys: Table, right_keys: Table) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense int64 group ids for each row of both sides (equal keys <->
    equal id)."""
    nl, nr = left_keys.num_rows, right_keys.num_rows
    both = concatenate([left_keys, right_keys])
    order = sorted_order(both).to(torch.int64)
    seg, _num = _segment_ids(both, order)
    ids = torch.zeros((nl + nr,), dtype=torch.int64, device=order.device)
    ids[order] = seg.to(torch.int64)
    return ids[:nl], ids[nl:]


def _any_null(keys: Table) -> Optional[torch.Tensor]:
    m = None
    for c in keys.columns:
        if c.validity is not None:
            bad = ~c.validity
            m = bad if m is None else (m | bad)
    return m


def _probe_ids(
    left_keys: Table, right_keys: Table
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(probe_id, rid, rnull) of the sort-probe: the dense key ids of both
    sides, with a null left key probing as -2 and a null right key pulled
    out of the probe set as -1, so a null never matches."""
    lid, rid = _factorize(left_keys, right_keys)
    lnull = _any_null(left_keys)
    rnull = _any_null(right_keys)
    if rnull is not None:
        rid = torch.where(rnull, -1, rid)
    probe_id = lid if lnull is None else torch.where(lnull, -2, lid)
    return probe_id, rid, rnull


def _expand_rows(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Enumerate counts[i] output slots for each row i: (row_of_slot,
    slot_within_row), int64, after the one host sync every join pays for
    the output size."""
    counts = counts.to(torch.int64)
    cum = torch.cumsum(counts, 0)
    total = int(cum[-1]) if counts.shape[0] else 0  # host sync: output size
    row = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device), counts,
                                  output_size=total)
    within = torch.arange(total, dtype=torch.int64, device=counts.device) - (cum - counts)[row]
    return row, within


# key types the paged table takes: plain integers (decimals, floats,
# strings and timestamps keep the sort-probe)
_PAGED_KEY_IDS = frozenset({
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
})

# the port stores UINT16/32/64 in signed lanes: the paged table reads
# their order through an unsigned view of the same bits
_UNSIGNED_VIEW = {TypeId.UINT16: torch.uint16, TypeId.UINT32: torch.uint32,
                  TypeId.UINT64: torch.uint64}


def _paged_keys(col: Column) -> torch.Tensor:
    view = _UNSIGNED_VIEW.get(col.dtype.id)
    return col.data if view is None else col.data.view(view)


def _paged_join_usable(left_keys: Table, right_keys: Table, how: str) -> bool:
    return (how in ("inner", "left")
            and left_keys.num_columns == 1 and right_keys.num_columns == 1
            and left_keys.columns[0].dtype.id in _PAGED_KEY_IDS
            and right_keys.columns[0].dtype.id == left_keys.columns[0].dtype.id)


def _paged_join_maps(
    left_keys: Table, right_keys: Table, how: str
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Gather maps through the paged table and B4, or None when a side is
    empty or the build side gates out of the table."""
    if left_keys.num_rows == 0 or right_keys.num_rows == 0:
        return None
    rcol, lcol = right_keys.columns[0], left_keys.columns[0]
    table = build_paged_table(_paged_keys(rcol), rcol.validity)
    if table is None:
        return None
    lo, eq = probe_paged(_paged_keys(lcol), lcol.validity, table)
    counts = eq if how == "inner" else eq.clamp(min=1)
    lrow, within = _expand_rows(counts)
    matched = eq[lrow] > 0
    rpos = (lo[lrow] + within).clamp(0, table.nm - 1)
    rrow = torch.where(matched, table.r_order[rpos], -1)
    return lrow.to(torch.int32), rrow.to(torch.int32)


def join_gather_maps(
    left_keys: Table, right_keys: Table, how: str = "inner"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left_idx, right_idx) int32 gather maps; -1 marks the null-extended
    rows of a left or full outer join (cudf's out-of-bounds sentinel)."""
    if how not in ("inner", "left", "full"):
        raise ValueError(f"unsupported join type {how!r}")
    if _paged_join_usable(left_keys, right_keys, how):
        maps = _paged_join_maps(left_keys, right_keys, how)
        if maps is not None:
            return maps
    nr = right_keys.num_rows
    probe_id, rid, rnull = _probe_ids(left_keys, right_keys)
    r_order = torch.argsort(rid, stable=True)
    rid_sorted = rid[r_order]
    lo = torch.searchsorted(rid_sorted, probe_id, side="left")
    hi = torch.searchsorted(rid_sorted, probe_id, side="right")
    counts = hi - lo
    if how in ("left", "full"):
        counts = counts.clamp(min=1)

    lrow, within = _expand_rows(counts)
    matched = (hi - lo)[lrow] > 0
    if nr == 0:  # empty probe set: nothing can match
        rrow = torch.full_like(lrow, -1)
    else:
        rpos = (lo[lrow] + within).clamp(0, nr - 1)
        rrow = torch.where(matched, r_order[rpos], -1)

    if how == "full":
        # right rows that matched no left row, with a -1 left map. The
        # sentinels differ on purpose: left null keys probe as -2, right
        # null keys as -3, so a null never pairs with a null.
        l_sorted = torch.sort(probe_id).values
        r_probe = rid if rnull is None else torch.where(rnull, -3, rid)
        r_unmatched = (torch.searchsorted(l_sorted, r_probe, side="left")
                       == torch.searchsorted(l_sorted, r_probe, side="right"))
        urow = torch.nonzero(r_unmatched).flatten()
        lrow = torch.cat([lrow, torch.full_like(urow, -1)])
        rrow = torch.cat([rrow, urow])
    return lrow.to(torch.int32), rrow.to(torch.int32)


def semi_anti_gather_map(left_keys: Table, right_keys: Table, how: str = "semi") -> torch.Tensor:
    """Left-semi / left-anti gather map over the left table: semi keeps
    left rows with at least one right match, anti keeps rows with none.
    Null left keys never match (semi drops them, anti keeps them: Spark's
    IN / NOT EXISTS plan semantics)."""
    if how not in ("semi", "anti"):
        raise ValueError(f"unsupported semi/anti type {how!r}")
    probe_id, rid, _ = _probe_ids(left_keys, right_keys)
    rid_sorted = torch.sort(rid).values
    lo = torch.searchsorted(rid_sorted, probe_id, side="left")
    hi = torch.searchsorted(rid_sorted, probe_id, side="right")
    keep = (hi > lo) if how == "semi" else (hi == lo)
    return torch.nonzero(keep).flatten().to(torch.int32)  # host sync: output size


def _joined_table(left: Table, right: Table, lmap, rmap, on: Sequence[str]) -> Table:
    cols: List[Column] = []
    names: List[str] = []
    for name, col in zip(left.names, left.columns):
        cols.append(gather_column(col, lmap))
        names.append(name)
    for name, col in zip(right.names, right.columns):
        if name in on:
            continue
        cols.append(gather_column(col, rmap, check_bounds=True))
        names.append(name)
    return Table(cols, names)


def inner_join(left: Table, right: Table, on: Sequence[str]) -> Table:
    lmap, rmap = join_gather_maps(left.select(on), right.select(on), "inner")
    return _joined_table(left, right, lmap, rmap, list(on))


def left_join(left: Table, right: Table, on: Sequence[str]) -> Table:
    lmap, rmap = join_gather_maps(left.select(on), right.select(on), "left")
    return _joined_table(left, right, lmap, rmap, list(on))


def _coalesce(a: Column, b: Column, use_a: torch.Tensor) -> Column:
    """Row-wise COALESCE of two gathered key columns (the full join's key
    merge): row i of ``a`` where ``use_a[i]``, else row i of ``b``. A
    STRING key takes its rows through the string gather over both
    columns, which gives the same bytes as the reference's padded merge."""
    n = len(a)
    merged_valid = torch.where(use_a, a.valid_mask(), b.valid_mask())
    if a.dtype.id == TypeId.STRING:
        both = concatenate([Table([a]), Table([b])]).columns[0]
        rows = torch.arange(n, dtype=torch.int64, device=use_a.device)
        out = gather_column(both, torch.where(use_a, rows, rows + n))
        return Column(a.dtype, validity=merged_valid, offsets=out.offsets, chars=out.chars)
    sel = use_a[:, None] if a.data.dim() == 2 else use_a  # DECIMAL128 limbs
    return Column(a.dtype, data=torch.where(sel, a.data, b.data), validity=merged_valid)


def full_join(left: Table, right: Table, on: Sequence[str]) -> Table:
    """Full outer join: every left row (null-extended right) plus every
    unmatched right row (null-extended left, key columns coalesced from
    the right side)."""
    lmap, rmap = join_gather_maps(left.select(on), right.select(on), "full")
    use_left = lmap >= 0
    cols: List[Column] = []
    names: List[str] = []
    for name, col in zip(left.names, left.columns):
        g = gather_column(col, lmap, check_bounds=True)
        if name in on:
            g = _coalesce(g, gather_column(right.column(name), rmap, check_bounds=True), use_left)
        cols.append(g)
        names.append(name)
    for name, col in zip(right.names, right.columns):
        if name in on:
            continue
        cols.append(gather_column(col, rmap, check_bounds=True))
        names.append(name)
    return Table(cols, names)


def left_semi_join(left: Table, right: Table, on: Sequence[str]) -> Table:
    """Left rows with at least one right match (Spark's IN-subquery plan)."""
    return gather(left, semi_anti_gather_map(left.select(on), right.select(on), "semi"))


def left_anti_join(left: Table, right: Table, on: Sequence[str]) -> Table:
    """Left rows with no right match (Spark's NOT EXISTS plan)."""
    return gather(left, semi_anti_gather_map(left.select(on), right.select(on), "anti"))
