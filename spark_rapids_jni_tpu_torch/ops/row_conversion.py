"""JCUDF row <-> columnar transcode (port of the JAX package's
``ops/row_conversion.py``).

Row format (reference RowConversion.java:44-117, row_conversion.cu):

- each row is laid out like a C struct: every fixed-width column aligned
  to its own size (STRING slots are ``{offset:u32, len:u32}``, aligned 4,
  the offset relative to the row start),
- validity bytes follow the last column with no extra padding; bit
  ``col % 8`` of byte ``col / 8`` is set when the value is VALID,
- string characters follow the validity bytes, column after column,
- every row is padded to a multiple of 8 bytes (JCUDF_ROW_ALIGNMENT),
- output is one or more LIST<INT8> columns, each holding at most 2 GiB.

The paths follow the reference's kernel branch. Fixed-width encode
composes the row as u32 word planes ([P, N], one plane per 4 bytes of the
row) and turns them into byte planes with B6 (``expand_u32_planes``), then
transposes to rows. Decode reads each row's fixed section straight from
the blob into [P, N] word planes (``rows_to_planes``, B7 with B8's
fixed-section gather absorbed: the reference transposes the [N, W] rows
into byte planes and packs them with B7); every column is then a row take
of the plane stack plus a constant shift.

With STRING columns, encode builds the fixed sections as u32 lanes, pulls
every string column into a padded [N, L] matrix in one launch
(``extract_strings_many``, B8 on this path: the reference's
overlapping-tile gather + ``rotl_take`` masked by the lengths), ORs the
matrices into the rows' variable sections with B9 (``var_accumulate``),
and compacts the padded rows into the ragged blob with ``assemble_rows``
(B10: one kernel reading the fixed sections' word planes and the
variable sections where they lie). Decode reads the fixed sections into
word planes by the row offsets (``rows_to_planes``) and compacts every
string column's characters out of the blob with one B5 launch
(``hopper_kernels.ragged_compact_many``). Tables too large for the padded
form take the reference's scatter path instead (a size gate).

On CUDA tensors the kernels are the hand-written ones, on CPU tensors
their plain versions. Tables of fewer than 8 rows take the plain plane
relayouts on every device, as the reference keeps them off its kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from . import hopper_kernels, uword
from .ragged_bytes import (
    assemble_rows,
    expand_u32_planes,
    expand_u32_planes_plain,
    extract_strings_many,
    rows_to_planes,
    rows_to_planes_plain,
    var_accumulate,
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
# the padded string encode holds N * (fixed_end + maxvar) bytes of padded
# rows; past this a table takes the scatter path, O(actual bytes)
_PADDED_ROWS_BYTE_BUDGET = 4 << 30


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


def _col_u32_parts(col: Column, slot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> List[Tuple[int, torch.Tensor]]:
    """One column's row slot as (width_bytes, [N] int64) parts in
    row-byte order, each part holding up to 4 of the value's bytes as an
    unsigned value in [0, 2^32). A STRING column's slot is ``slot``, its
    (offset from the row start, length) pair."""
    d = col.dtype
    if d.id == TypeId.STRING:
        off, ln = slot
        return [(4, off.to(torch.int64)), (4, ln.to(torch.int64))]
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


def _fixed_planes32(layout: RowLayout, cols: Sequence[Column], pad_to: int,
                    var_slot_vals: Optional[dict] = None) -> torch.Tensor:
    """[ceil(pad_to/4), N] int32 plane stack: plane p holds bytes
    [4p, 4p+4) of every row (column slots + padding + validity) as a
    little-endian u32 word. Each plane is OR-composed from the disjoint
    shifted parts that fall into it. ``var_slot_vals`` maps each STRING
    column's index to its slot (offset, length) pair."""
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
        for width, val in _col_u32_parts(col, (var_slot_vals or {}).get(i)):
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
    if col.dtype.id == TypeId.STRING:
        offs = col.offsets[rs : re + 1]
        base, end = (int(x) for x in offs[[0, -1]].tolist())
        return Column(col.dtype, validity=v, offsets=offs - base, chars=col.chars[base:end])
    return Column(col.dtype, data=col.data[rs:re], validity=v)


# ---------------------------------------------------------------------------
# convert_to_rows, strings
# ---------------------------------------------------------------------------


def _row_size_stats(layout: RowLayout, var_offsets: Sequence[torch.Tensor]):
    """([N] int64 8-aligned row sizes, [N+1] int64 row offsets, total,
    max size): the sizes stay on the device, the two scalars come back in
    one read."""
    n = var_offsets[0].shape[0] - 1
    lens_total = torch.zeros((n,), dtype=torch.int64, device=var_offsets[0].device)
    for offs in var_offsets:
        lens_total += (offs[1:] - offs[:-1]).to(torch.int64)
    sizes = _round_up_t(lens_total + layout.fixed_end, JCUDF_ROW_ALIGNMENT)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=sizes.device),
                         torch.cumsum(sizes, 0)])
    total, max_size = torch.stack([offsets[-1], sizes.max()]).tolist()
    return sizes, offsets, total, max_size


def _round_up_t(v: torch.Tensor, align: int) -> torch.Tensor:
    return torch.div(v + align - 1, align, rounding_mode="floor") * align


def _slots(layout: RowLayout, cols: Sequence[Column]):
    """Per string column: [N] int32 offset of its characters from the row
    start (fixed_end plus the lengths of the string columns before it) and
    [N] int32 lengths."""
    n = len(cols[0])
    lens = [cols[i].offsets[1:] - cols[i].offsets[:-1] for i in layout.variable_cols]
    starts = []
    acc = torch.full((n,), layout.fixed_end, dtype=torch.int32, device=cols[0].device)
    for ln in lens:
        starts.append(acc)
        acc = acc + ln
    return starts, lens


def _var_section(chars, starts, lens, shifts, tail_lane: Optional[torch.Tensor], tail_bytes: int,
                 maxlens: Sequence[int], maxvar: int) -> torch.Tensor:
    """All string columns -> the rows' variable region, int32 [N,
    maxvar/4]: every column's bytes padded and masked to its lengths in
    one ``extract_strings_many`` launch, then one B9 pass over all of
    them.

    The region starts at byte 4 * (fixed_end // 4): when fixed_end is not
    a multiple of 4, the trailing validity bytes (``tail_lane``, the
    partial last word of the fixed section) ride in as a pseudo column at
    shift 0, so no word is split between the two sections."""
    p_mats, all_shifts = [], []
    if tail_bytes:
        n = tail_lane.shape[0]
        tail = tail_lane.contiguous().view(torch.uint8).view(n, 4)
        keep = torch.arange(4, device=tail.device)[None, :] < tail_bytes
        p_mats.append(torch.where(keep, tail, 0))
        all_shifts.append(torch.zeros((n,), dtype=torch.int32, device=tail.device))
    widths = [min(_round_up(ml, 4), maxvar) for ml in maxlens]
    p_mats += extract_strings_many(chars, starts, lens, widths)
    all_shifts += shifts
    return var_accumulate(p_mats, all_shifts, maxvar)


def _encode_strings_padded(layout: RowLayout, cols: Sequence[Column], row_offsets: torch.Tensor,
                           total: int, maxlens: Sequence[int], maxvar: int) -> torch.Tensor:
    """Fixed + string table -> uint8 [total] blob through padded rows:
    fixed sections as u32 word planes, the variable region from
    ``extract_strings_many`` and B9,
    and ``assemble_rows`` (B10) to drop each row's padding; B10 reads the
    planes through their transposed view, so the padded rows are never
    concatenated."""
    n = len(cols[0])
    starts, lens = _slots(layout, cols)
    slot_vals = {ci: (starts[k], lens[k]) for k, ci in enumerate(layout.variable_cols)}
    fixed32 = _fixed_planes32(layout, cols, layout.fixed_end, slot_vals).t()  # [N, ceil(fe/4)]

    fe4, rem = divmod(layout.fixed_end, 4)
    region = _round_up(rem + maxvar, 64)
    chars, cstarts, clens, shifts, mls = [], [], [], [], []
    for k, ci in enumerate(layout.variable_cols):
        if maxlens[k] == 0:
            continue
        col = cols[ci]
        chars.append(col.chars)
        cstarts.append(col.offsets[:-1])
        clens.append(lens[k])
        shifts.append(starts[k] - 4 * fe4)
        # maxlens are the whole table's; a batch's own strings are bounded
        # by its maxvar, and the extraction width must not grow with an
        # outlier string of another batch
        mls.append(min(maxlens[k], maxvar))
    if not chars and not rem:
        var32 = torch.zeros((n, region // 4), dtype=torch.int32, device=fixed32.device)
    else:
        var32 = _var_section(chars, cstarts, clens, shifts, fixed32[:, fe4] if rem else None, rem,
                             mls, region)
    fixed_part = fixed32[:, :fe4] if rem else fixed32
    sizes = row_offsets[1:] - row_offsets[:-1]
    return assemble_rows((fixed_part, var32), sizes, row_offsets, total,
                         _round_up(layout.fixed_end, JCUDF_ROW_ALIGNMENT))


def _encode_strings_scatter(layout: RowLayout, cols: Sequence[Column], row_offsets: torch.Tensor,
                            total: int) -> torch.Tensor:
    """Fixed + string table -> uint8 [total] blob by byte scatters: the
    reference's route for tables whose padded rows would not fit the
    budget (O(actual bytes), element-granular)."""
    n = len(cols[0])
    starts, lens = _slots(layout, cols)
    slot_vals = {ci: (starts[k], lens[k]) for k, ci in enumerate(layout.variable_cols)}
    planes = _fixed_planes32(layout, cols, layout.fixed_end, slot_vals)
    fe = layout.fixed_end
    fixed = planes.t().contiguous().view(torch.uint8).view(n, -1)[:, :fe]
    dev = fixed.device
    row_starts = row_offsets[:-1].to(torch.int64)
    blob = torch.zeros((total,), dtype=torch.uint8, device=dev)
    # the [rows, fixed_end] index matrix in chunks of ~64 MB
    chunk = max(1, (64 << 20) // 8 // max(fe, 1))
    span = torch.arange(fe, dtype=torch.int64, device=dev)[None, :]
    for r0 in range(0, n, chunk):
        idx = row_starts[r0 : r0 + chunk, None] + span
        blob[idx.reshape(-1)] = fixed[r0 : r0 + chunk].reshape(-1)
    for k, ci in enumerate(layout.variable_cols):
        col = cols[ci]
        nchars = int(col.chars.shape[0])
        if nchars == 0:
            continue
        offs = col.offsets.to(torch.int64)
        j = torch.arange(nchars, dtype=torch.int64, device=dev)
        row_of = torch.searchsorted(offs, j, right=True) - 1
        dest = row_starts[row_of] + starts[k][row_of].to(torch.int64) + (j - offs[row_of])
        blob[dest] = col.chars
    return blob


def _encode_strings(layout: RowLayout, cols: Sequence[Column], row_offsets: torch.Tensor,
                    total: int, max_size: int, maxlens: Sequence[int]) -> torch.Tensor:
    """One batch of a table with STRING columns -> its uint8 [total] blob:
    the padded path unless its padded rows pass the byte budget."""
    maxvar = max(_round_up(max_size - layout.fixed_end, 64), 8)
    if len(cols[0]) * (layout.fixed_end + maxvar) <= _PADDED_ROWS_BYTE_BUDGET:
        return _encode_strings_padded(layout, cols, row_offsets, total, maxlens, maxvar)
    return _encode_strings_scatter(layout, cols, row_offsets, total)


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
    layout = compute_row_layout(table.dtypes())
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
    if not layout.variable_cols:
        row_size = layout.row_size_fixed
        batches = _batch_boundaries(np.full((n,), row_size, dtype=np.int64))
        out = []
        for rs, re, _ in batches:
            batch_cols = [_slice_column(c, rs, re) for c in cols]
            blob = _to_rows_fixed(layout, batch_cols, re - rs)
            rel = torch.arange(re - rs + 1, dtype=torch.int32, device=blob.device) * row_size
            out.append(_wrap_batch_as_list_column(blob, rel, uniform_stride=row_size))
        return out

    sizes, offsets, total, max_size = _row_size_stats(
        layout, [cols[i].offsets for i in layout.variable_cols])
    maxlens = [cols[i].max_char_len for i in layout.variable_cols]
    if total <= MAX_BATCH_BYTES:  # one batch: no further host reads
        blob = _encode_strings(layout, cols, offsets, total, max_size, maxlens)
        return [_wrap_batch_as_list_column(blob, offsets)]
    row_sizes = sizes.cpu().numpy()
    out = []
    for rs, re, nbytes in _batch_boundaries(row_sizes):
        batch_cols = [_slice_column(c, rs, re) for c in cols]
        bsizes = sizes[rs:re]
        row_offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=bsizes.device),
                                 torch.cumsum(bsizes, 0)])
        blob = _encode_strings(layout, batch_cols, row_offsets, nbytes,
                               int(row_sizes[rs:re].max()), maxlens)
        out.append(_wrap_batch_as_list_column(blob, row_offsets))
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


def _row_planes(layout: RowLayout, rows: Column):
    """(blob, starts, [P, N] int32 word planes of each row's first W
    bytes) in one ``rows_to_planes`` call: W = ``row_size_fixed`` at the
    uniform stride (the whole row), else ``fixed_end`` at the rows'
    offsets."""
    blob, starts = _rows_blob(rows)
    n = len(rows)
    to_planes = rows_to_planes if n >= _KERNEL_MIN_ROWS else rows_to_planes_plain
    rs = layout.row_size_fixed
    if _offsets_uniform(rows, blob.shape[0], rs, n):
        return blob, starts, to_planes(blob, rs, rs, n)
    return blob, starts, to_planes(blob, starts, layout.fixed_end)


def _decode_groups_from_planes(
    layout: RowLayout, dtypes: Sequence[DType], planes: torch.Tensor
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """[P, N] int32 word planes of the rows' fixed sections -> ({group
    key: [k, N] typed lanes}, [C, N] bool validity).

    Every group is a row take of the planes plus a constant shift (slot
    alignment puts each 4- and 8-byte entry on a word boundary)."""
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
    if d.id == TypeId.STRING:  # (offset from the row start, length), u32 bits
        data = (group_arrays["u4"][ents[0][1]], group_arrays["u4"][ents[1][1]])
    elif d.id == TypeId.DECIMAL128:
        data = torch.stack([group_arrays["u4"][e[1]] for e in ents], dim=1)
    else:
        key, idx, _ = ents[0]
        data = group_arrays[key][idx]
    return data, valid_t[i]


def _decode_fixed_groups(layout: RowLayout, dtypes: Sequence[DType], planes: torch.Tensor):
    """[P, N] word planes -> (per-column data, per-column [N] validity)."""
    group_arrays, valid_t = _decode_groups_from_planes(layout, dtypes, planes)
    _, entries = _entry_plan(layout, dtypes)
    datas, valids = [], []
    for i, d in enumerate(dtypes):
        data, vmask = _extract_column(group_arrays, valid_t, entries, i, d)
        datas.append(data)
        valids.append(vmask)
    return datas, valids


def _empty_column(d: DType, device) -> Column:
    if d.id == TypeId.STRING:
        return Column(d, offsets=torch.zeros((1,), dtype=torch.int32, device=device),
                      chars=torch.zeros((0,), dtype=torch.uint8, device=device))
    shape = (0, 4) if d.id == TypeId.DECIMAL128 else (0,)
    return Column(d, data=torch.zeros(shape, dtype=d.torch_dtype, device=device))


def _string_offsets(lens32: torch.Tensor) -> torch.Tensor:
    """[N] int32 lengths -> [N+1] int32 offsets."""
    zero = torch.zeros((1,), dtype=torch.int32, device=lens32.device)
    return torch.cat([zero, torch.cumsum(lens32, 0, dtype=torch.int32)])


def _finish_column(d: DType, data, vmask, blob, starts) -> Column:
    """Wrap one decoded column as a Column; a STRING column compacts its
    characters out of the row blob here (B5): row r's bytes start at
    starts[r] plus its slot offset."""
    if d.id == TypeId.STRING:
        in_off, ln32 = data
        offs = _string_offsets(ln32)
        chars = hopper_kernels.ragged_compact_many(blob, [(in_off, offs, int(offs[-1]))],
                                                   row_starts=starts)[0]
        return Column(d, validity=vmask, offsets=offs, chars=chars)
    return Column(d, data=data, validity=vmask)


def _assemble_from_rows(dtypes: Sequence[DType], datas, valids, blob, starts) -> Table:
    """Decoded (data, validity) per column -> Table. The string columns'
    offsets come from one cumsum each and their totals from one host
    read for all of them; the characters of all of them come out of one
    B5 launch, which adds each row's start to its slot offsets itself."""
    str_idx = [i for i, d in enumerate(dtypes) if d.id == TypeId.STRING]
    built = {}
    if str_idx:
        offs = [_string_offsets(datas[i][1]) for i in str_idx]
        totals = torch.stack([o[-1] for o in offs]).tolist()
        chars = hopper_kernels.ragged_compact_many(
            blob, [(datas[i][0], offs[k], totals[k]) for k, i in enumerate(str_idx)],
            row_starts=starts)
        for k, i in enumerate(str_idx):
            built[i] = Column(dtypes[i], validity=valids[i], offsets=offs[k], chars=chars[k])
    return Table([built[i] if i in built else Column(d, data=datas[i], validity=valids[i])
                  for i, d in enumerate(dtypes)])


def convert_from_rows(rows: Column, dtypes: Sequence[DType]) -> Table:
    """LIST<INT8> column of JCUDF rows + schema -> Table
    (RowConversion.convertFromRows). The fixed sections go to word planes
    in one ``rows_to_planes`` call, by the uniform stride (every
    fixed-width batch ``convert_to_rows`` makes) or by the row offsets."""
    dtypes = list(dtypes)
    layout = compute_row_layout(dtypes)
    if len(rows) == 0:
        _rows_blob(rows)
        return Table([_empty_column(d, rows.device) for d in dtypes])
    blob, starts, planes = _row_planes(layout, rows)
    datas, valids = _decode_fixed_groups(layout, dtypes, planes)
    return _assemble_from_rows(dtypes, datas, valids, blob, starts)


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
        return _finish_column(d, data, vmask, self.blob, self.starts)

    def to_table(self) -> Table:
        if len(self) == 0:
            return Table([_empty_column(d, self.blob.device) for d in self.dtypes])
        _, entries = _entry_plan(self.layout, self.dtypes)
        cols = [_extract_column(self.groups, self.valid_t, entries, i, d)
                for i, d in enumerate(self.dtypes)]
        return _assemble_from_rows(self.dtypes, [c[0] for c in cols], [c[1] for c in cols],
                                   self.blob, self.starts)


def convert_from_rows_grouped(rows: Column, dtypes: Sequence[DType]) -> GroupedRows:
    """LIST<INT8> rows + schema -> GroupedRows (no per-column buffers)."""
    dtypes = tuple(dtypes)
    layout = compute_row_layout(dtypes)
    if len(rows) == 0:
        blob, starts = _rows_blob(rows)
        valid_t = torch.zeros((len(dtypes), 0), dtype=torch.bool, device=blob.device)
        return GroupedRows(dtypes, layout, {}, valid_t, blob, starts)
    blob, starts, planes = _row_planes(layout, rows)
    groups, valid_t = _decode_groups_from_planes(layout, dtypes, planes)
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
