"""JCUDF row <-> columnar transcode, fixed-width part (port of the JAX
package's ``ops/row_conversion.py``).

Row format (reference RowConversion.java:44-117, row_conversion.cu):

- each row is laid out like a C struct: every fixed-width column aligned
  to its own size (STRING slots are ``{offset:u32, len:u32}``, aligned 4),
- validity bytes follow the last column with no extra padding; bit
  ``col % 8`` of byte ``col / 8`` is set when the value is VALID,
- every row is padded to a multiple of 8 bytes (JCUDF_ROW_ALIGNMENT),
- output is one or more LIST<INT8> columns, each holding at most 2 GiB.

The fixed-width path follows the reference's kernel branch. Encode
composes the row as u32 word planes ([P, N], one plane per 4 bytes of the
row) and turns them into byte planes with B6 (``expand_u32_planes``), then
transposes to rows. Decode transposes the [N, W] rows into byte planes and
packs them into word planes with B7 (``pack_u8_planes``); every column is
then a row take of the plane stack plus a constant shift. On CUDA tensors
B6/B7 are the hand-written kernels, on CPU tensors their plain versions.
Tables of fewer than 8 rows take the plain versions on every device, as
the reference keeps them off its kernels.

Schemas with STRING columns raise NotImplementedError: the string
transcode is the next slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from . import uword
from .ragged_bytes import (
    expand_u32_planes,
    expand_u32_planes_plain,
    pack_u8_planes,
    pack_u8_planes_plain,
)

__all__ = [
    "RowLayout",
    "compute_row_layout",
    "convert_to_rows",
    "convert_from_rows",
    "convert_from_rows_grouped",
    "GroupedRows",
    "convert_to_rows_fixed_width_optimized",
    "convert_from_rows_fixed_width_optimized",
]

JCUDF_ROW_ALIGNMENT = 8
MAX_BATCH_BYTES = (1 << 31) - 1  # cudf size_type limit per LIST<INT8> batch
MAX_ROW_SIZE_OPTIMIZED = 1024  # RowConversion.java:115-116
MAX_COLS_OPTIMIZED = 100  # RowConversion.java:27-34
_KERNEL_MIN_ROWS = 8  # the reference's gate for its plane kernels

_STRINGS_NOT_PORTED = (
    "STRING columns in JCUDF rows are not ported yet "
    "(ROADMAP.md, Open items, section 1, item 4: row transcode, strings)"
)


def _round_up(v: int, align: int) -> int:
    return (v + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Static per-schema row layout."""

    col_starts: Tuple[int, ...]  # byte offset of each column's slot
    col_sizes: Tuple[int, ...]  # slot width (8 for compound columns)
    validity_offset: int  # first validity byte
    fixed_end: int  # validity_offset + validity bytes
    variable_cols: Tuple[int, ...]  # indices of STRING columns, in order
    row_size_fixed: int  # aligned row size when no variable data

    @property
    def num_columns(self) -> int:
        return len(self.col_starts)


def compute_row_layout(dtypes: Sequence[DType]) -> RowLayout:
    """Mirror of compute_column_information (row_conversion.cu:1340-1378)."""
    starts: List[int] = []
    sizes: List[int] = []
    variable: List[int] = []
    off = 0
    for i, d in enumerate(dtypes):
        if d.is_compound:
            if d.id != TypeId.STRING:
                raise ValueError(f"only STRING compound columns supported in rows, got {d!r}")
            size, align = 8, 4  # {offset:u32, len:u32}
            variable.append(i)
        elif d.is_fixed_width:
            size = d.size_bytes
            align = size
        else:
            raise ValueError(f"unsupported dtype in row conversion: {d!r}")
        off = _round_up(off, align)
        starts.append(off)
        sizes.append(size)
        off += size
    validity_offset = off
    fixed_end = off + (len(list(dtypes)) + 7) // 8
    return RowLayout(
        col_starts=tuple(starts),
        col_sizes=tuple(sizes),
        validity_offset=validity_offset,
        fixed_end=fixed_end,
        variable_cols=tuple(variable),
        row_size_fixed=_round_up(fixed_end, JCUDF_ROW_ALIGNMENT),
    )


def _fixed_layout(dtypes: Sequence[DType]) -> RowLayout:
    layout = compute_row_layout(dtypes)
    if layout.variable_cols:
        raise NotImplementedError(_STRINGS_NOT_PORTED)
    return layout


# ---------------------------------------------------------------------------
# entry plan: columns -> scalar entries grouped by storage type
# ---------------------------------------------------------------------------


def _entry_plan(layout: RowLayout, dtypes: Sequence[DType]):
    """Static grouping plan: each column becomes scalar 'entries' of one
    storage type (DECIMAL128 -> 4 u32 limbs, STRING slot -> 2 u32s,
    others -> 1 entry), grouped by type so the decode builds one array
    per distinct type, not per column. Keys are the reference's
    (``w{width}_{numpy storage dtype}``, or ``u4`` for 32-bit limbs).

    Returns (groups, entries): groups maps key -> entry count in
    first-seen order; entries[i] lists (key, index in group, row byte)
    for column i."""
    groups: dict = {}
    entries: List[List[Tuple[str, int, int]]] = []
    for i, d in enumerate(dtypes):
        start = layout.col_starts[i]
        col_entries = []
        if d.id in (TypeId.STRING, TypeId.DECIMAL128):
            for sub in range(2 if d.id == TypeId.STRING else 4):
                idx = groups.setdefault("u4", 0)
                groups["u4"] += 1
                col_entries.append(("u4", idx, start + 4 * sub))
        else:
            key = f"w{d.size_bytes}_{d.np_dtype.name}"
            idx = groups.setdefault(key, 0)
            groups[key] += 1
            col_entries.append((key, idx, start))
        entries.append(col_entries)
    return groups, entries


def _entry_width(key: str) -> int:
    return 4 if key == "u4" else int(key[1 : key.index("_")])


def _col_u32_parts(col: Column) -> List[Tuple[int, torch.Tensor]]:
    """One fixed-width column's value as (width_bytes, [N] int64) parts in
    row-byte order, each part holding up to 4 of the value's bytes as an
    unsigned value in [0, 2^32)."""
    d = col.dtype
    if d.id == TypeId.STRING:
        raise NotImplementedError(_STRINGS_NOT_PORTED)
    if d.id == TypeId.DECIMAL128:
        return [(4, uword.u32_to_i64(col.data[:, k])) for k in range(4)]
    w = d.size_bytes
    data = col.data
    if w == 8:
        lo, hi = uword.split_u64(data)
        return [(4, uword.u32_to_i64(lo)), (4, uword.u32_to_i64(hi))]
    if w == 4:
        if data.dtype == torch.float32:
            data = data.view(torch.int32)
        return [(4, uword.u32_to_i64(data))]
    if w == 2:
        return [(2, data.to(torch.int64) & 0xFFFF)]
    # w == 1 (int8/uint8/bool)
    return [(1, data.to(torch.int64) & 0xFF)]


def _fixed_planes32(layout: RowLayout, cols: Sequence[Column], pad_to: int) -> torch.Tensor:
    """[ceil(pad_to/4), N] int32 plane stack: plane p holds bytes
    [4p, 4p+4) of every row (column slots + padding + validity) as a
    little-endian u32 word. Each plane is OR-composed from the disjoint
    shifted parts that fall into it."""
    n = len(cols[0]) if cols else 0
    dev = cols[0].device if cols else torch.device("cpu")
    num_planes = (pad_to + 3) // 4
    plane_parts: List[List[torch.Tensor]] = [[] for _ in range(num_planes)]

    def _emit(byte_off: int, val: torch.Tensor):
        plane, sub = divmod(byte_off, 4)
        if plane < num_planes:
            plane_parts[plane].append(val << (8 * sub) if sub else val)

    for i, col in enumerate(cols):
        pos = layout.col_starts[i]
        for width, val in _col_u32_parts(col):
            _emit(pos, val)
            pos += width

    # validity bytes: bit c%8 of byte b is column 8b+c's valid bit
    for b in range((len(cols) + 7) // 8):
        byte = torch.zeros((n,), dtype=torch.int64, device=dev)
        for bit, col in enumerate(cols[8 * b : 8 * b + 8]):
            byte |= col.valid_mask().to(torch.int64) << bit
        _emit(layout.validity_offset + b, byte)

    out = torch.zeros((num_planes, n), dtype=torch.int32, device=dev)
    for p, parts in enumerate(plane_parts):
        if parts:
            word = parts[0]
            for v in parts[1:]:
                word = word | v
            out[p] = uword.to_signed_bits(word, 32)
    return out


# ---------------------------------------------------------------------------
# convert_to_rows
# ---------------------------------------------------------------------------


def _batch_boundaries(row_sizes: np.ndarray) -> List[Tuple[int, int, int]]:
    """Split rows into <=2GiB batches: list of (row_start, row_end, nbytes).

    Mirror of build_batches (row_conversion.cu:1465-1543): greedy scan of
    cumulative row sizes against the size_type ceiling."""
    n = len(row_sizes)
    if n == 0:
        return [(0, 0, 0)]
    cum = np.concatenate([[0], np.cumsum(row_sizes, dtype=np.int64)])
    batches = []
    start = 0
    while start < n:
        end = int(np.searchsorted(cum, cum[start] + MAX_BATCH_BYTES, side="right")) - 1
        if end == start:
            raise ValueError(f"row {start} larger than 2GiB batch limit")
        end = min(end, n)
        batches.append((start, end, int(cum[end] - cum[start])))
        start = end
    return batches


def _to_rows_fixed(layout: RowLayout, cols: Sequence[Column], n: int) -> torch.Tensor:
    """All-fixed-width table -> [N * row_size] uint8 blob: word planes ->
    byte planes (B6) -> transpose to rows."""
    planes = _fixed_planes32(layout, cols, layout.row_size_fixed)
    expand = expand_u32_planes if n >= _KERNEL_MIN_ROWS else expand_u32_planes_plain
    return expand(planes).t().contiguous().reshape(-1)


def _slice_column(col: Column, rs: int, re: int) -> Column:
    if rs == 0 and re == len(col):
        return col
    v = None if col.validity is None else col.validity[rs:re]
    return Column(col.dtype, data=col.data[rs:re], validity=v)


def _wrap_batch_as_list_column(
    blob: torch.Tensor, rel_offsets: torch.Tensor, uniform_stride: int = 0
) -> Column:
    child = Column(dt.INT8, data=blob.view(torch.int8))
    col = Column.list_from_parts(rel_offsets.to(torch.int32), child)
    if uniform_stride:
        # producer-known constant row stride: lets the decoder skip the
        # uniformity probe (a device sync). Host metadata, not data.
        col._uniform_stride = uniform_stride
    return col


def convert_to_rows(table: Table) -> List[Column]:
    """Table -> one or more LIST<INT8> columns of JCUDF rows, at most
    2 GiB each (RowConversion.convertToRows)."""
    layout = _fixed_layout(table.dtypes())
    n = table.num_rows
    cols = table.columns
    if n == 0:
        dev = cols[0].device if cols else torch.device("cpu")
        return [
            _wrap_batch_as_list_column(
                torch.zeros((0,), dtype=torch.uint8, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev),
            )
        ]
    row_size = layout.row_size_fixed
    batches = _batch_boundaries(np.full((n,), row_size, dtype=np.int64))
    out = []
    for rs, re, _ in batches:
        batch_cols = [_slice_column(c, rs, re) for c in cols]
        blob = _to_rows_fixed(layout, batch_cols, re - rs)
        rel = torch.arange(re - rs + 1, dtype=torch.int32, device=blob.device) * row_size
        out.append(_wrap_batch_as_list_column(blob, rel, uniform_stride=row_size))
    return out


# ---------------------------------------------------------------------------
# convert_from_rows
# ---------------------------------------------------------------------------


def _rows_blob(rows: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    if rows.dtype.id != TypeId.LIST:
        raise ValueError("convert_from_rows expects a LIST<INT8> column")
    blob = rows.child.data.view(torch.uint8)
    starts = rows.offsets[:-1].to(torch.int64)
    return blob, starts


def _offsets_uniform(rows: Column, blob_len: int, stride: int, n: int) -> bool:
    """Constant-row-stride check: the producer-attached stride when there
    is one, else one reduction on the device and one scalar read."""
    if blob_len != n * stride:
        return False
    known = getattr(rows, "_uniform_stride", None)
    if known is not None:
        return known == stride
    offs = rows.offsets
    return bool((offs[0] == 0) & torch.all(offs[1:] - offs[:-1] == stride))


def _gather_fixed(layout: RowLayout, blob: torch.Tensor, starts: torch.Tensor, n: int):
    """Each row's fixed section out of a blob with arbitrary row starts:
    [N, fixed_end] uint8, with the index matrix chunked to ~64 MB."""
    fe = layout.fixed_end
    chunk = max(1, (64 << 20) // 8 // max(fe, 1))
    span = torch.arange(fe, dtype=torch.int64, device=blob.device)[None, :]
    parts = [blob[starts[r0 : r0 + chunk, None] + span] for r0 in range(0, n, chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _fixed_rows(layout: RowLayout, rows: Column):
    """(blob, starts, [N, W] uint8 row view): a free reshape when the rows
    have the uniform stride, else a gather of each row's fixed section."""
    blob, starts = _rows_blob(rows)
    n = len(rows)
    if _offsets_uniform(rows, blob.shape[0], layout.row_size_fixed, n):
        return blob, starts, blob.reshape(n, layout.row_size_fixed)
    return blob, starts, _gather_fixed(layout, blob, starts, n)


def _decode_groups_from_planes(
    layout: RowLayout, dtypes: Sequence[DType], fixed: torch.Tensor
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """[N, W] uint8 rows -> ({group key: [k, N] typed lanes}, [C, N] bool
    validity).

    fixed.T is the byte-plane stack (row j = byte j of every row), so B7
    turns it into [W/4, N] word planes; every group is then a row take of
    the planes plus a constant shift (slot alignment puts each 4- and
    8-byte entry on a word boundary)."""
    n, w = fixed.shape
    pad = (-w) % 4
    if pad:
        fixed = torch.nn.functional.pad(fixed, (0, pad))
    pack = pack_u8_planes if n >= _KERNEL_MIN_ROWS else pack_u8_planes_plain
    planes = pack(fixed.t().contiguous())  # [W/4, N] int32 (u32 bits)
    dev = planes.device

    groups, entries = _entry_plan(layout, dtypes)
    group_arrays: Dict[str, torch.Tensor] = {}
    for key, count in groups.items():
        ew = _entry_width(key)
        byte_off = np.zeros((count,), np.int64)
        for col_entries in entries:
            for k2, idx, row_byte in col_entries:
                if k2 == key:
                    byte_off[idx] = row_byte
        b4 = torch.from_numpy(byte_off // 4).to(dev)
        if ew == 4:
            lanes = planes.index_select(0, b4)  # [k, N] int32
            if key == "w4_float32":
                lanes = lanes.view(torch.float32)
        elif ew == 8:
            lanes = uword.join_u64(planes.index_select(0, b4), planes.index_select(0, b4 + 1))
        else:  # ew in (1, 2): the sub-word shift is constant per entry
            base = planes.index_select(0, b4)
            sh = torch.from_numpy((byte_off % 4) * 8).to(dev)[:, None]
            v = uword.u32_to_i64(base) >> sh
            if ew == 2:
                lanes = uword.to_signed_bits(v, 16)  # int16 storage (INT16 / UINT16 bits)
            elif key == "w1_int8":
                lanes = uword.to_signed_bits(v, 8)
            else:
                lanes = (v & 0xFF).to(torch.uint8)
        group_arrays[key] = lanes

    c = len(dtypes)
    vbyte = layout.validity_offset + np.arange(c) // 8
    vbase = planes.index_select(0, torch.from_numpy(vbyte // 4).to(dev))  # [C, N]
    vsh = torch.from_numpy((vbyte % 4) * 8 + np.arange(c) % 8).to(dev)[:, None]
    valid_t = ((uword.u32_to_i64(vbase) >> vsh) & 1).to(torch.bool)
    return group_arrays, valid_t


def _extract_column(group_arrays, valid_t, entries, i: int, d: DType):
    """One column's (data, validity) out of the grouped representation."""
    ents = entries[i]
    if d.id == TypeId.STRING:
        raise NotImplementedError(_STRINGS_NOT_PORTED)
    if d.id == TypeId.DECIMAL128:
        data = torch.stack([group_arrays["u4"][e[1]] for e in ents], dim=1)
    else:
        key, idx, _ = ents[0]
        data = group_arrays[key][idx]
    return data, valid_t[i]


def _decode_fixed_groups(layout: RowLayout, dtypes: Sequence[DType], fixed: torch.Tensor):
    """[N, W] uint8 rows -> (per-column data, per-column [N] validity)."""
    group_arrays, valid_t = _decode_groups_from_planes(layout, dtypes, fixed)
    _, entries = _entry_plan(layout, dtypes)
    datas, valids = [], []
    for i, d in enumerate(dtypes):
        data, vmask = _extract_column(group_arrays, valid_t, entries, i, d)
        datas.append(data)
        valids.append(vmask)
    return datas, valids


def _empty_column(d: DType, device) -> Column:
    shape = (0, 4) if d.id == TypeId.DECIMAL128 else (0,)
    return Column(d, data=torch.zeros(shape, dtype=d.torch_dtype, device=device))


def convert_from_rows(rows: Column, dtypes: Sequence[DType]) -> Table:
    """LIST<INT8> column of JCUDF rows + schema -> Table
    (RowConversion.convertFromRows). Uniform-stride rows (every batch
    ``convert_to_rows`` makes) decode from a free reshape of the blob;
    other row offsets gather each row's fixed section first."""
    dtypes = list(dtypes)
    layout = _fixed_layout(dtypes)
    if len(rows) == 0:
        _rows_blob(rows)
        return Table([_empty_column(d, rows.device) for d in dtypes])
    _, _, fixed = _fixed_rows(layout, rows)
    datas, valids = _decode_fixed_groups(layout, dtypes, fixed)
    return Table([Column(d, data=x, validity=v) for d, x, v in zip(dtypes, datas, valids)])


@dataclasses.dataclass
class GroupedRows:
    """Decoded JCUDF rows in the width-grouped layout: one [k, N] array
    per distinct storage type (``groups``) and [C, N] validity
    (``valid_t``), with per-column materialization deferred to
    ``column(i)`` / ``to_table()``."""

    dtypes: Tuple[DType, ...]
    layout: RowLayout
    groups: dict  # width-group key -> [k, N] typed lanes
    valid_t: torch.Tensor  # [C, N] bool
    blob: torch.Tensor  # [total_bytes] uint8 row blob
    starts: torch.Tensor  # [N] int64 row start offsets

    def __len__(self) -> int:
        return int(self.valid_t.shape[1])

    def column(self, i: int) -> Column:
        d = self.dtypes[i]
        if len(self) == 0:
            return _empty_column(d, self.blob.device)
        _, entries = _entry_plan(self.layout, self.dtypes)
        data, vmask = _extract_column(self.groups, self.valid_t, entries, i, d)
        return Column(d, data=data, validity=vmask)

    def to_table(self) -> Table:
        return Table([self.column(i) for i in range(len(self.dtypes))])


def convert_from_rows_grouped(rows: Column, dtypes: Sequence[DType]) -> GroupedRows:
    """LIST<INT8> rows + schema -> GroupedRows (no per-column buffers)."""
    dtypes = tuple(dtypes)
    layout = _fixed_layout(dtypes)
    if len(rows) == 0:
        blob, starts = _rows_blob(rows)
        valid_t = torch.zeros((len(dtypes), 0), dtype=torch.bool, device=blob.device)
        return GroupedRows(dtypes, layout, {}, valid_t, blob, starts)
    blob, starts, fixed = _fixed_rows(layout, rows)
    groups, valid_t = _decode_groups_from_planes(layout, dtypes, fixed)
    return GroupedRows(dtypes, layout, groups, valid_t, blob, starts)


# ---------------------------------------------------------------------------
# fixed-width-optimized variants (legacy API surface, RowConversion.java:118-173)
# ---------------------------------------------------------------------------


def _check_optimized(dtypes: Sequence[DType]) -> RowLayout:
    dtypes = list(dtypes)
    if len(dtypes) >= MAX_COLS_OPTIMIZED:
        raise ValueError(
            f"fixed-width-optimized path supports < {MAX_COLS_OPTIMIZED} columns, got {len(dtypes)}"
        )
    for d in dtypes:
        if not d.is_fixed_width:
            raise ValueError(f"fixed-width-optimized path requires fixed-width types, got {d!r}")
    layout = compute_row_layout(dtypes)
    if layout.row_size_fixed > MAX_ROW_SIZE_OPTIMIZED:
        raise ValueError(f"row size {layout.row_size_fixed} exceeds 1KB limit")
    return layout


def convert_to_rows_fixed_width_optimized(table: Table) -> List[Column]:
    """Legacy <100-column fixed-width entry (RowConversion.java:118): the
    same JCUDF layout as convert_to_rows, after the limit checks."""
    _check_optimized(table.dtypes())
    return convert_to_rows(table)


def convert_from_rows_fixed_width_optimized(rows: Column, dtypes: Sequence[DType]) -> Table:
    """Legacy fixed-width decode entry (RowConversion.java:158)."""
    _check_optimized(dtypes)
    return convert_from_rows(rows, dtypes)
