"""Multi-key stable sort (port of the JAX package's ``ops/sort.py``,
cudf::sorted_order / sort_by_key).

Each fixed-width key maps through ``bitutils.total_order_key`` to an
int64 lane whose signed order is the value order, exact for floats by the
IEEE total-order transform. A column contributes a null-rank lane ahead
of its value lanes. Torch has no ``lexsort``: the composite order comes
from stable argsorts, least significant lane first, which gives the same
permutation as the reference's ``jnp.lexsort`` (ties keep row order).

A STRING key is the reference's 16-byte prefix key, kept exactly: two
big-endian 64-bit lanes of the first 16 bytes (shorter strings pad with
0). Strings equal in their first 16 bytes tie and keep row order, as in
the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar import Column, Table
from ..columnar.dtype import TypeId
from . import bitutils
from .copying import gather
from .uword import join_u64
from ..utils.dispatch import op_boundary

__all__ = ["sorted_order", "sort_by_key"]


def _string_prefix_keys(col: Column) -> List[torch.Tensor]:
    """Two int64 lanes of the first 16 bytes, big-endian (shorter strings
    pad with 0), each in the signed form of the reference's u64 lane (the
    leading byte biased by -128, i.e. the sign bit flipped)."""
    offs = col.offsets.to(torch.int64)
    lens = offs[1:] - offs[:-1]
    pos = torch.arange(16, dtype=torch.int64, device=offs.device)[None, :]
    nchars = int(col.chars.shape[0])
    if nchars == 0:
        chars = torch.zeros((len(col), 16), dtype=torch.int64, device=offs.device)
    else:
        idx = (offs[:-1, None] + pos).clamp(0, nchars - 1)
        chars = torch.where(pos < lens[:, None], col.chars[idx].to(torch.int64), 0)
    keys = []
    for half in range(2):
        k = chars[:, 8 * half] - 128
        for b in range(1, 8):
            k = k * 256 + chars[:, 8 * half + b]
        keys.append(k)
    return keys


def _value_lanes(col: Column) -> List[torch.Tensor]:
    if col.dtype.id == TypeId.STRING:
        return _string_prefix_keys(col)
    if col.dtype.id == TypeId.DECIMAL128:
        # two's complement over four limbs, compared high to low: the
        # signed high pair, then the low pair as unsigned
        limbs = col.data
        return [join_u64(limbs[:, 2], limbs[:, 3]),
                join_u64(limbs[:, 0], limbs[:, 1]) ^ bitutils.SIGN64]
    return [bitutils.total_order_key(col.data, col.dtype)]


def _column_keys(col: Column, ascending: bool, nulls_first: bool) -> List[torch.Tensor]:
    """Major-first int64 lanes of one column: its null rank, then its
    value lanes (inverted for a descending sort). A column without
    validity leaves out the null rank, a constant lane that cannot
    change a stable sort."""
    lanes = _value_lanes(col)
    if not ascending:
        lanes = [~k for k in lanes]  # ~ reverses the signed order of int64
    if col.validity is None:
        return lanes
    valid = col.validity.to(torch.int64)
    return [valid if nulls_first else 1 - valid] + lanes


def sorted_order(
    table: Table,
    ascending: Optional[Sequence[bool]] = None,
    nulls_first: Optional[Sequence[bool]] = None,
) -> torch.Tensor:
    """Stable gather indices (int32) ordering the table by its columns,
    the leftmost most significant (cudf::sorted_order semantics)."""
    ncols = table.num_columns
    asc = list(ascending) if ascending is not None else [True] * ncols
    nf = list(nulls_first) if nulls_first is not None else [True] * ncols
    lanes: List[torch.Tensor] = []
    for col, a, f in zip(table.columns, asc, nf):
        lanes.extend(_column_keys(col, a, f))
    order = torch.arange(table.num_rows, dtype=torch.int64, device=table.columns[0].device)
    for lane in reversed(lanes):
        order = order[torch.argsort(lane[order], stable=True)]
    return order.to(torch.int32)


@op_boundary("sort_by_key")
def sort_by_key(values: Table, keys: Table, ascending=None, nulls_first=None) -> Table:
    order = sorted_order(keys, ascending, nulls_first)
    return gather(values, order)
