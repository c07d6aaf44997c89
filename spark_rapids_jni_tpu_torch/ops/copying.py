"""Row movement: gather, boolean-mask filter, slice, concatenate (port of
the JAX package's ``ops/copying.py``).

A gather over a table is one indexing per buffer; a STRING or LIST column
re-derives its offsets from the gathered lengths and gathers its chars
(its child) through a per-byte source index. Ops whose output size
depends on the data sync that size to the host once, as the reference
does.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import TypeId

__all__ = ["gather", "gather_column", "apply_boolean_mask", "concatenate", "slice_table"]


def _all_null_column(d, n_out: int, device) -> Column:
    valid = torch.zeros((n_out,), dtype=torch.bool, device=device)
    zero_offs = torch.zeros((n_out + 1,), dtype=torch.int32, device=device)
    if d.id == TypeId.STRING:
        return Column(d, validity=valid, offsets=zero_offs,
                      chars=torch.zeros((0,), dtype=torch.uint8, device=device))
    if d.id == TypeId.LIST:
        child = Column(dt.INT8, data=torch.zeros((0,), dtype=torch.int8, device=device))
        return Column(d, validity=valid, offsets=zero_offs, child=child)
    if d.id == TypeId.DECIMAL128:
        return Column(d, data=torch.zeros((n_out, 4), dtype=torch.int32, device=device),
                      validity=valid)
    return Column(d, data=torch.zeros((n_out,), dtype=d.torch_dtype, device=device), validity=valid)


def _ragged_gather(offs: torch.Tensor, safe: torch.Tensor):
    """Offsets [N+1] and row indices -> (new offsets int32, per-byte source
    positions int64 into the old buffer)."""
    lens = (offs[1:] - offs[:-1])[safe].to(torch.int64)
    new_offs = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    total = int(new_offs[-1])  # host sync: the buffer's size
    src = torch.repeat_interleave(offs[:-1][safe].to(torch.int64) - new_offs[:-1], lens,
                                  output_size=total)
    src += torch.arange(total, dtype=torch.int64, device=offs.device)
    return new_offs.to(torch.int32), src


def gather_column(col: Column, idx: torch.Tensor, check_bounds: bool = False) -> Column:
    """New column with rows col[idx[i]]. With ``check_bounds`` an index
    outside [0, N) gives a null row (cudf's NULLIFY bounds policy);
    without it, gathering rows from an empty column raises IndexError."""
    n_out = idx.shape[0]
    n_in = len(col)
    dev = col.device
    if n_in == 0:
        # gathering from an empty source (e.g. the null-extended side of
        # an outer join against an empty table): every row is null
        if not check_bounds and n_out > 0:
            raise IndexError("gather from empty column without check_bounds")
        return _all_null_column(col.dtype, n_out, dev)
    idx = idx.to(torch.int64)
    safe = idx.clamp(0, n_in - 1)

    valid = None
    if col.validity is not None:
        valid = col.validity[safe]
    if check_bounds:
        oob = (idx < 0) | (idx >= n_in)
        valid = ~oob if valid is None else valid & ~oob

    if col.dtype.id == TypeId.STRING:
        new_offs, src = _ragged_gather(col.offsets, safe)
        return Column(col.dtype, validity=valid, offsets=new_offs, chars=col.chars[src])
    if col.dtype.id == TypeId.LIST:
        new_offs, src = _ragged_gather(col.offsets, safe)
        return Column(col.dtype, validity=valid, offsets=new_offs,
                      child=gather_column(col.child, src))
    return Column(col.dtype, data=col.data[safe], validity=valid)


def gather(table: Table, idx: torch.Tensor, check_bounds: bool = False) -> Table:
    return Table([gather_column(c, idx, check_bounds) for c in table.columns], table.names)


def apply_boolean_mask(table: Table, mask) -> Table:
    """Keep rows where ``mask`` is true (and, for a Column mask, not
    null): cudf's apply_boolean_mask."""
    if isinstance(mask, Column):
        m = mask.data.to(torch.bool)
        if mask.validity is not None:
            m = m & mask.validity
    else:
        m = torch.as_tensor(mask, dtype=torch.bool)
    return gather(table, torch.nonzero(m).flatten())  # host sync on the size


def slice_table(table: Table, start: int, end: int) -> Table:
    n = table.num_rows
    dev = table.columns[0].device
    lo = max(0, min(start, n))
    idx = torch.arange(lo, max(lo, min(end, n)), dtype=torch.int64, device=dev)
    return gather(table, idx)


def concatenate(tables: Sequence[Table]) -> Table:
    """Row-wise concatenation of tables of one schema (cudf::concatenate)."""
    tables = [t for t in tables if t.num_rows > 0] or list(tables[:1])
    first = tables[0]
    out: List[Column] = []
    for ci in range(first.num_columns):
        cols = [t.columns[ci] for t in tables]
        d = cols[0].dtype
        valid = None
        if any(c.validity is not None for c in cols):
            valid = torch.cat([c.valid_mask() for c in cols])
        if d.id == TypeId.STRING:
            lens = torch.cat([c.offsets[1:] - c.offsets[:-1] for c in cols])
            offs = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)]).to(torch.int32)
            chars = torch.cat([c.chars for c in cols])
            out.append(Column(d, validity=valid, offsets=offs, chars=chars))
        else:
            out.append(Column(d, data=torch.cat([c.data for c in cols]), validity=valid))
    return Table(out, first.names)
