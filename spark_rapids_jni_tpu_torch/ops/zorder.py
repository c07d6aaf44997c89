"""DeltaLake-compatible Z-order bit interleaving (port of the JAX
package's ``ops/zorder.py``).

Behavioral parity with the reference's zorder.cu interleave_bits
(:32-115): all columns share one fixed-width type; the output is a
LIST<UINT8> column whose rows are num_cols * type_size bytes; the most
significant output bit takes the most significant bit of column 0, then
column 1, ... cycling; null values read as zero (:97); the total output
stays under the 2 GiB size_type limit (:52-55).

The (output byte, output bit) -> (column, value bit) mapping depends only
on (num_columns, type_size), so it is a small host table; each of the 8
bit positions of an output byte is then one gather, shift and mask over
[N, row_bytes] (in place of the reference's thread per output byte,
zorder.cu:66-101).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.column import resolve_device
from ..columnar.dtype import TypeId
from .uword import split_u64, u32_to_i64
from ..utils.dispatch import op_boundary

__all__ = ["interleave_bits", "interleave_bits_table"]

_MAX_OUTPUT = (1 << 31) - 1


@lru_cache(maxsize=None)
def _bit_maps(num_columns: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(col_of, bit_of): for output byte i (within a row) and bit offset o,
    which column and which value bit (0 = LSB) feed it. The index
    arithmetic of zorder.cu:74-99."""
    row_bytes = num_columns * size
    col_of = np.zeros((row_bytes, 8), dtype=np.int64)
    bit_of = np.zeros((row_bytes, 8), dtype=np.int64)
    for ret_idx in range(row_bytes):
        group = (ret_idx // num_columns) * num_columns
        flipped = group + (num_columns - 1 - (ret_idx - group))
        for o in range(8):
            obit = flipped * 8 + o
            b = obit // num_columns  # bit index within the flipped column bytes
            col_of[ret_idx, o] = num_columns - 1 - (obit % num_columns)
            bit_of[ret_idx, o] = (size - 1 - b // 8) * 8 + b % 8  # big-endian flip
    return col_of, bit_of


def _column_as_bit_limbs(col: Column) -> torch.Tensor:
    """[N, L] u32 limbs (little endian, in int64 lanes) of the value bits;
    nulls zeroed. The storage words widen by their unsigned value, never
    by a sign extension."""
    d = col.dtype
    if d.id == TypeId.DECIMAL128:
        limbs = u32_to_i64(col.data)
    elif d.size_bytes <= 4:
        data = col.data.view(torch.int32) if col.data.is_floating_point() else col.data
        limbs = (data.to(torch.int64) & ((1 << (8 * d.size_bytes)) - 1))[:, None]
    else:
        lo, hi = split_u64(col.data)
        limbs = torch.stack([u32_to_i64(lo), u32_to_i64(hi)], dim=1)
    if col.validity is not None:
        limbs = torch.where(col.validity[:, None], limbs, 0)
    return limbs


@op_boundary("interleave_bits")
def interleave_bits(num_rows: int, *columns: Column, device=None) -> Column:
    """Parity: ZOrder.interleaveBits (ZOrder.java:41) ->
    spark_rapids_jni::interleave_bits (zorder.cu:32).

    The zero-column case returns ``num_rows`` empty lists on ``device``
    (None means the card), as the Java side does (ZOrder.java:42-47).
    """
    if not columns:
        dev = resolve_device(device)
        return Column.list_from_parts(
            torch.zeros((num_rows + 1,), dtype=torch.int32, device=dev),
            Column(dt.UINT8, data=torch.zeros((0,), dtype=torch.uint8, device=dev)))

    d0 = columns[0].dtype
    if not d0.is_fixed_width:
        raise ValueError("Only fixed width columns can be used")
    if any(c.dtype.id != d0.id for c in columns):
        raise ValueError("All columns of the input table must be the same type.")
    n = len(columns[0])
    size = d0.size_bytes
    num_columns = len(columns)
    if n * size * num_columns > _MAX_OUTPUT:
        raise ValueError("Input is too large to process")

    dev = columns[0].device
    col_of, bit_of = (torch.from_numpy(m).to(dev) for m in _bit_maps(num_columns, size))
    limbs = torch.stack([_column_as_bit_limbs(c) for c in columns], dim=1)  # [N, C, L]
    limb_of, shift = bit_of // 32, bit_of % 32

    out = torch.zeros((n, num_columns * size), dtype=torch.int64, device=dev)
    for o in range(8):
        src = limbs[:, col_of[:, o], limb_of[:, o]]  # [N, row_bytes]
        out |= ((src >> shift[:, o]) & 1) << o

    offsets = torch.arange(n + 1, dtype=torch.int32, device=dev) * (size * num_columns)
    return Column.list_from_parts(offsets,
                                  Column(dt.UINT8, data=out.to(torch.uint8).reshape(-1)))


def interleave_bits_table(table: Table, device=None) -> Column:
    return interleave_bits(table.num_rows, *table.columns, device=device)
