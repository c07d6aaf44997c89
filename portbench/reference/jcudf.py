"""Plain JCUDF row format for fixed-width schemas, in plain PyTorch.

A frozen copy of the rules of cudf's row conversion
(``row_conversion.cu`` ``compute_column_information`` and
``build_batches``, as ``RowConversion.java`` documents them): each
column's slot at its own alignment, in schema order; one validity bit a
column after the slots (bit ``i % 8`` of byte ``i // 8``, set when the
value is valid); each row padded to 8 bytes; rows split greedily into
batches of at most 2^31 - 1 bytes, each batch a LIST<INT8> with int32
offsets.

It imports nothing of the program under test: it is what the benchmark
holds the program's encode and decode to, and the encoder that makes the
decode cell's row batches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

ROW_ALIGNMENT = 8
MAX_BATCH_BYTES = (1 << 31) - 1

SIZES = {
    "INT8": 1, "INT16": 2, "INT32": 4, "INT64": 8,
    "UINT8": 1, "UINT16": 2, "UINT32": 4, "UINT64": 8,
    "BOOL8": 1, "FLOAT32": 4, "FLOAT64": 8, "TIMESTAMP_DAYS": 4,
}

# storage type of each column type (unsigned types in the signed storage of
# their width, FLOAT64 as its IEEE bits)
STORAGE = {
    "INT8": torch.int8, "INT16": torch.int16, "INT32": torch.int32, "INT64": torch.int64,
    "UINT8": torch.uint8, "UINT16": torch.int16, "UINT32": torch.int32, "UINT64": torch.int64,
    "BOOL8": torch.uint8, "FLOAT32": torch.float32, "FLOAT64": torch.int64,
    "TIMESTAMP_DAYS": torch.int32,
}


def _round_up(v: int, align: int) -> int:
    return (v + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class Layout:
    starts: Tuple[int, ...]  # byte offset of each column's slot
    sizes: Tuple[int, ...]
    validity_offset: int  # first validity byte
    row_size: int  # bytes a row, 8-aligned


def layout(types: Sequence[str]) -> Layout:
    """The row layout of a fixed-width schema."""
    starts, sizes, off = [], [], 0
    for t in types:
        size = SIZES[t]
        off = _round_up(off, size)
        starts.append(off)
        sizes.append(size)
        off += size
    validity_bytes = (len(types) + 7) // 8
    return Layout(tuple(starts), tuple(sizes), off, _round_up(off + validity_bytes, ROW_ALIGNMENT))


def batch_rows(lay: Layout, n: int) -> List[Tuple[int, int]]:
    """(first row, end row) of each batch: as many whole rows as fit in
    ``MAX_BATCH_BYTES``, greedily."""
    per = MAX_BATCH_BYTES // lay.row_size
    if n == 0:
        return [(0, 0)]
    return [(r0, min(r0 + per, n)) for r0 in range(0, n, per)]


def encode(lay: Layout, cols: Sequence[torch.Tensor], valids: Sequence[Optional[torch.Tensor]],
           r0: int, r1: int) -> torch.Tensor:
    """Rows ``r0:r1`` as uint8 [r1 - r0, row_size]: each column's bytes in
    its slot, the validity bits after them, padding zero."""
    n = r1 - r0
    dev = cols[0].device
    out = torch.zeros((n, lay.row_size), dtype=torch.uint8, device=dev)
    for c, s, size in zip(cols, lay.starts, lay.sizes):
        out[:, s : s + size] = c[r0:r1].contiguous().view(torch.uint8).view(n, size)
    for b in range((len(cols) + 7) // 8):
        acc = torch.zeros((n,), dtype=torch.uint8, device=dev)
        for k in range(8):
            i = 8 * b + k
            if i >= len(cols):
                break
            v = valids[i]
            bit = 1 << k
            if v is None:
                acc |= bit
            else:
                acc |= v[r0:r1].to(torch.uint8) << k
        out[:, lay.validity_offset + b] = acc
    return out


def decode(lay: Layout, types: Sequence[str], rows: torch.Tensor
           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """uint8 [n, row_size] rows -> (columns in their storage types, bool
    validity masks)."""
    n = rows.shape[0]
    cols, valids = [], []
    for i, (t, s, size) in enumerate(zip(types, lay.starts, lay.sizes)):
        cols.append(rows[:, s : s + size].contiguous().view(STORAGE[t]).view(n))
        byte = rows[:, lay.validity_offset + i // 8]
        valids.append(((byte >> (i % 8)) & 1).bool())
    return cols, valids


def transcode_bytes(lay: Layout, n: int, nullable: int) -> dict:
    """The least bytes one direction of the transcode of ``n`` rows moves,
    by part: the column data, the validity at one bit a row for each
    nullable column, the row blob, and each batch's int32 offsets. An
    encode reads the first two and writes the last two; a decode the
    reverse."""
    batches = batch_rows(lay, n)
    return {
        "columns": n * sum(lay.sizes),
        "validity": nullable * ((n + 7) // 8),
        "rows": n * lay.row_size,
        "offsets": sum(4 * (r1 - r0 + 1) for r0, r1 in batches),
    }
