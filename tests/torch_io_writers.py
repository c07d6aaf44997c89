"""Minimal Parquet and ORC writers for the port's IO checks: harness code,
not part of either package. They write exactly the layouts the chip smoke
reads (and the CPU tests read back with pyarrow):

- Parquet as Spark's default write lays it out through parquet-mr: every
  column OPTIONAL, row groups of ``parquet.block.size`` (128 MB), v1
  data pages of about 1 MB, dictionary encoding (labelled
  PLAIN_DICTIONARY, as parquet-mr's v1 writer does) for every column
  whose distinct values fit a 1 MB dictionary and PLAIN for the rest,
  and SNAPPY (``spark.sql.parquet.compression.codec``'s default) or no
  codec. The snappy encoder writes literal-only streams: valid snappy,
  no smaller than the input. Levels and dictionary indices are the
  RLE/bit-packed hybrid, bit-packed runs of at most 504 values and one
  RLE run for a page whose levels are all equal.
- A nested Parquet file (3-level LIST and STRUCT, as Spark writes them).
- ORC with ZLIB (raw deflate at level 1) in 256 KB compression chunks,
  stripes of 64 MB (``orc.stripe.size``), no row index; integers in
  RLEv2 DIRECT runs, tinyint in byte-RLE literal runs, strings
  DICTIONARY_V2 where the distinct values are at most 80% of the rows
  (``orc.dictionary.key.threshold``), else DIRECT_V2.

Lineitem data: the seven columns of the port's ``gen_lineitem`` and two
STRING columns of the TPC-H specification, ``l_shipmode`` (its seven
modes) and ``l_comment`` (10-43 bytes; letters and spaces here, not the
specification's text grammar).

Parquet metadata goes out through the port's ``io/thrift_compact``; the
module imports no jax.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_jni_tpu_torch.io import thrift_compact as tc
from spark_rapids_jni_tpu_torch.io.thrift_compact import ThriftList, ThriftStruct

SHIPMODES = (b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB")
ROW_GROUP_BYTES = 128 << 20
PAGE_BYTES = 1 << 20
DICT_BYTES = 1 << 20
STRIPE_BYTES = 64 << 20
ORC_BLOCK = 256 << 10


@dataclass
class Col:
    """One flat column: ``kind`` is "double" (IEEE bits in uint64 or
    float64 values), "int32", "int8", "date" (int32 days) or "string"
    (``values`` the host pair (offsets int32 [N+1], chars uint8));
    ``validity`` None or a bool mask."""

    name: str
    kind: str
    values: object
    validity: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.values[0]) - 1 if self.kind == "string" else len(self.values)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def lineitem_strings(rows: int, seed: int):
    """(l_shipmode, l_comment) as (offsets, chars) host pairs."""
    rng = np.random.default_rng(seed)
    modes = rng.integers(0, len(SHIPMODES), rows)
    mode_lens = np.array([len(m) for m in SHIPMODES], np.int32)
    ship = _ragged_pick(SHIPMODES, modes, mode_lens)
    lens = rng.integers(10, 44, rows).astype(np.int32)
    offs = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz      ", np.uint8)
    chars = alphabet[rng.integers(0, len(alphabet), int(offs[-1]))]
    return ship, (offs, chars)


def _ragged_pick(words: Sequence[bytes], pick: np.ndarray, lens: np.ndarray):
    blob = np.frombuffer(b"".join(words), np.uint8)
    starts = np.zeros(len(words), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    plens = lens[pick]
    offs = np.zeros(len(pick) + 1, np.int32)
    np.cumsum(plens, out=offs[1:])
    row = np.repeat(np.arange(len(pick)), plens)
    chars = blob[starts[pick][row] + (np.arange(int(offs[-1])) - offs[:-1][row])]
    return offs, chars


def lineitem_columns(rows: int, seed: int) -> List[Col]:
    """The nine lineitem columns: gen_lineitem's seven (FLOAT64 bits,
    INT8 flags, TIMESTAMP_DAYS dates) and the two strings."""
    from spark_rapids_jni_tpu_torch.models import tpch

    li = tpch.gen_lineitem(rows, seed=seed, device="cpu")
    kinds = {"FLOAT64": "double", "INT8": "int8", "TIMESTAMP_DAYS": "date"}
    cols = [Col(nm, kinds[c.dtype.id.name], c.to_numpy()) for nm, c in zip(li.names, li.columns)]
    ship, comment = lineitem_strings(rows, seed + 1)
    return cols + [Col("l_shipmode", "string", ship), Col("l_comment", "string", comment)]


# ---------------------------------------------------------------------------
# shared encoders
# ---------------------------------------------------------------------------


def snappy_literal(data) -> bytes:
    """A valid raw snappy block of literals only (64 KB each)."""
    buf = np.frombuffer(bytes(data), np.uint8)
    n = buf.size
    head = _varint(n)
    full, rest = divmod(n, 65536)
    parts = [head]
    if full:
        tags = np.tile(np.array([61 << 2, 0xFF, 0xFF], np.uint8), (full, 1))
        parts.append(np.hstack([tags, buf[:full * 65536].reshape(full, 65536)]).tobytes())
    if rest:
        m = rest - 1
        if m < 60:
            tag = bytes([m << 2])
        elif m < 256:
            tag = bytes([60 << 2, m])
        else:
            tag = bytes([61 << 2, m & 0xFF, m >> 8])
        parts.append(tag + buf[full * 65536:].tobytes())
    return b"".join(parts)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        if v < 0x80:
            out.append(v)
            return bytes(out)
        out.append((v & 0x7F) | 0x80)
        v >>= 7


def _bits_le(values: np.ndarray, width: int) -> np.ndarray:
    """[n] unsigned values -> their low ``width`` bits, LSB first, packed
    little-endian bit order (parquet's bit-packing)."""
    v = values.astype(np.uint64)
    bits = ((v[:, None] >> np.arange(width, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little")


def rle_hybrid(values: np.ndarray, width: int) -> bytes:
    """Parquet's RLE/bit-packed hybrid: one RLE run when every value is
    equal, else bit-packed runs of at most 63 groups of 8 (504 values)."""
    n = values.size
    if n == 0:
        return b""
    if width == 0:
        return _varint(n << 1)
    if values.min() == values.max():
        return _varint(n << 1) + int(values[0]).to_bytes((width + 7) // 8, "little")
    groups = -(-n // 8)
    padded = np.zeros(groups * 8, np.uint64)
    padded[:n] = values
    packed = _bits_le(padded, width)  # groups * width bytes
    run_bytes = 63 * width
    full, rest = divmod(groups, 63)
    parts = []
    if full:
        body = packed[:full * run_bytes].reshape(full, run_bytes)
        parts.append(np.hstack([np.full((full, 1), (63 << 1) | 1, np.uint8), body]).tobytes())
    if rest:
        parts.append(_varint((rest << 1) | 1) + packed[full * run_bytes:].tobytes())
    return b"".join(parts)


# ---------------------------------------------------------------------------
# parquet
# ---------------------------------------------------------------------------

_PQ_TYPE = {"double": 5, "int32": 1, "int8": 1, "date": 1, "string": 6, "int64": 2}
_PQ_CONVERTED = {"int8": 15, "date": 6, "string": 0}  # INT_8, DATE, UTF8
_PQ_WIDTH = {"double": 8, "int32": 4, "int8": 4, "date": 4, "int64": 8}
_E_PLAIN, _E_PLAIN_DICT, _E_RLE = 0, 2, 3


def _i32(v):
    return (tc.CT_I32, int(v))


def _i64(v):
    return (tc.CT_I64, int(v))


def _plain_fixed(col: Col, values: np.ndarray) -> bytes:
    if col.kind == "double":
        return values.astype(np.float64, copy=False).tobytes() if values.dtype == np.float64 \
            else values.astype(np.uint64, copy=False).tobytes()
    return values.astype(np.int32 if col.kind != "int64" else np.int64).tobytes()


def _string_rows(pair, lo: int, hi: int):
    offs, chars = pair
    return offs[lo:hi + 1] - offs[lo], chars[offs[lo]:offs[hi]]


def _plain_strings(offs: np.ndarray, chars: np.ndarray) -> bytes:
    """[u32 len][bytes] per value."""
    lens = np.diff(offs).astype(np.int64)
    n = lens.size
    out = np.empty(int(offs[-1]) + 4 * n, np.uint8)
    starts = offs[:-1].astype(np.int64) + 4 * np.arange(n)
    hdr = lens.astype("<u4").view(np.uint8).reshape(n, 4)
    for k in range(4):
        out[starts + k] = hdr[:, k]
    row = np.repeat(np.arange(n), lens)
    out[np.arange(int(offs[-1])) + 4 * (row + 1)] = chars
    return out.tobytes()


def _fixed_strings(offs, chars):
    """[n] 'S<w>' array of the strings (no NUL inside them)."""
    lens = np.diff(offs)
    w = max(int(lens.max()) if lens.size else 1, 1)
    mat = np.zeros((lens.size, w), np.uint8)
    row = np.repeat(np.arange(lens.size), lens)
    mat[row, np.arange(chars.size) - offs[:-1][row]] = chars
    return mat.view(f"S{w}").reshape(-1)


def _dictionary(col: Col, lo: int, hi: int, present: np.ndarray, limit: int):
    """(dictionary page body, n entries, indices of the present values) or
    None when the distinct values need more than ``limit`` bytes."""
    if col.kind == "string":
        offs, chars = _string_rows(col.values, lo, hi)
        keys = _fixed_strings(offs, chars)[present]
        per = 4 + np.diff(offs)[present]
    else:
        keys = np.asarray(col.values[lo:hi])[present]
        per = None
    width = None if per is not None else _PQ_WIDTH[col.kind]
    probe = keys[: limit // 4 + 1] if width is None else keys[: limit // width + 1]
    if np.unique(probe).size * (width or 5) > limit:
        return None
    uniq, inv = np.unique(keys, return_inverse=True)
    if col.kind == "string":
        ulens = np.char.str_len(uniq.astype(object).astype(bytes)) if uniq.size else np.zeros(0, int)
        size = int(4 * uniq.size + ulens.sum())
        if size > limit:
            return None
        uoffs = np.zeros(uniq.size + 1, np.int32)
        np.cumsum(ulens, out=uoffs[1:])
        body = _plain_strings(uoffs, np.frombuffer(b"".join(uniq.tolist()), np.uint8))
    else:
        if uniq.size * width > limit:
            return None
        body = _plain_fixed(col, uniq)
    return body, uniq.size, inv.astype(np.uint32)


def _page_header(ptype: int, usize: int, csize: int, **sub) -> bytes:
    h = ThriftStruct({1: _i32(ptype), 2: _i32(usize), 3: _i32(csize)})
    for fid, s in sub.items():
        h.set(int(fid[1:]), tc.CT_STRUCT, s)
    return tc.write_struct(h)


def _compress(raw: bytes, codec: int) -> bytes:
    return snappy_literal(raw) if codec == 1 else raw


def _chunk(col: Col, lo: int, hi: int, codec: int, pos: int, page_bytes: int, dict_bytes: int):
    """Encode rows [lo, hi) of ``col`` as one column chunk starting at file
    offset ``pos``: (bytes, ColumnMetaData)."""
    n = hi - lo
    valid = np.ones(n, bool) if col.validity is None else col.validity[lo:hi].astype(bool)
    pidx = np.flatnonzero(valid)
    out: List[bytes] = []
    dict_off = None
    usize_total = 0
    d = _dictionary(col, lo, hi, valid, dict_bytes)
    if d is not None:
        body, nd, inv = d
        comp = _compress(body, codec)
        hdr = _page_header(2, len(body), len(comp),
                           f7=ThriftStruct({1: _i32(nd), 2: _i32(_E_PLAIN_DICT)}))
        dict_off = pos
        out += [hdr, comp]
        usize_total += len(hdr) + len(body)
        bw = int(nd - 1).bit_length() if nd > 1 else 0
        row_bits = np.full(n, bw / 8.0)
    elif col.kind == "string":
        row_bits = (4 + np.diff(col.values[0][lo:hi + 1])).astype(np.float64) * valid
    else:
        row_bits = np.full(n, float(_PQ_WIDTH[col.kind])) * valid
    # ~1 MB pages of whole rows
    cum = np.cumsum(row_bits + 0.25)
    cuts = np.searchsorted(cum, np.arange(page_bytes, cum[-1] if n else 0, page_bytes))
    bounds = np.unique(np.concatenate([[0], cuts, [n]])).astype(np.int64)
    data_off = pos + sum(len(x) for x in out)
    present_before = np.concatenate([[0], np.cumsum(valid)])
    for a, b in zip(bounds[:-1], bounds[1:]):
        v = valid[a:b]
        levels = rle_hybrid(v.astype(np.uint32), 1)
        p0, p1 = present_before[a], present_before[b]
        if d is not None:
            vals = bytes([bw]) + rle_hybrid(inv[p0:p1], bw)
            enc = _E_PLAIN_DICT
        elif col.kind == "string":
            offs, chars = _string_rows(col.values, lo + a, lo + b)
            keep = np.flatnonzero(v)
            lens = np.diff(offs)[keep]
            koffs = np.zeros(keep.size + 1, np.int32)
            np.cumsum(lens, out=koffs[1:])
            row = np.repeat(keep, lens)
            kch = chars[offs[:-1][row] + (np.arange(int(koffs[-1])) - koffs[:-1][np.repeat(
                np.arange(keep.size), lens)])] if keep.size else chars[:0]
            vals = _plain_strings(koffs, kch)
            enc = _E_PLAIN
        else:
            vals = _plain_fixed(col, np.asarray(col.values[lo + a:lo + b])[v])
            enc = _E_PLAIN
        raw = struct.pack("<I", len(levels)) + levels + vals
        comp = _compress(raw, codec)
        hdr = _page_header(0, len(raw), len(comp), f5=ThriftStruct({
            1: _i32(b - a), 2: _i32(enc), 3: _i32(_E_RLE), 4: _i32(_E_RLE)}))
        out += [hdr, comp]
        usize_total += len(hdr) + len(raw)
    blob = b"".join(out)
    encs = [_E_PLAIN_DICT if d is not None else _E_PLAIN, _E_RLE]
    md = ThriftStruct({
        1: _i32(_PQ_TYPE[col.kind]),
        2: (tc.CT_LIST, ThriftList(tc.CT_I32, encs)),
        3: (tc.CT_LIST, ThriftList(tc.CT_BINARY, [col.name.encode()])),
        4: _i32(codec), 5: _i64(n), 6: _i64(usize_total), 7: _i64(len(blob)),
        9: _i64(data_off),
    })
    if dict_off is not None:
        md.set(11, tc.CT_I64, dict_off)
    return blob, md


def _leaf_schema(name: str, kind: str, repetition: int = 1) -> ThriftStruct:
    e = ThriftStruct({1: _i32(_PQ_TYPE[kind]), 3: _i32(repetition),
                      4: (tc.CT_BINARY, name.encode())})
    if kind in _PQ_CONVERTED:
        e.set(6, tc.CT_I32, _PQ_CONVERTED[kind])
    return e


def _group_schema(name: str, children: int, repetition: Optional[int] = 1,
                  converted: Optional[int] = None) -> ThriftStruct:
    e = ThriftStruct({4: (tc.CT_BINARY, name.encode()), 5: _i32(children)})
    if repetition is not None:
        e.set(3, tc.CT_I32, repetition)
    if converted is not None:
        e.set(6, tc.CT_I32, converted)
    return e


def _footer(schema: List[ThriftStruct], rgs: List[ThriftStruct], rows: int) -> bytes:
    meta = ThriftStruct({
        1: _i32(1), 2: (tc.CT_LIST, ThriftList(tc.CT_STRUCT, schema)), 3: _i64(rows),
        4: (tc.CT_LIST, ThriftList(tc.CT_STRUCT, rgs)),
        6: (tc.CT_BINARY, b"spark-rapids-jni-tpu test writer"),
    })
    raw = tc.write_struct(meta)
    return raw + struct.pack("<I", len(raw)) + b"PAR1"


def _row_group(chunks: List[Tuple[int, ThriftStruct]], rows: int, ordinal: int) -> ThriftStruct:
    cols = [ThriftStruct({2: _i64(off), 3: (tc.CT_STRUCT, md)}) for off, md in chunks]
    first = chunks[0][1]
    start = first.get(11) if first.has(11) else first.get(9)
    return ThriftStruct({
        1: (tc.CT_LIST, ThriftList(tc.CT_STRUCT, cols)),
        2: _i64(sum(md.get(6) for _, md in chunks)), 3: _i64(rows),
        5: _i64(start), 6: _i64(sum(md.get(7) for _, md in chunks)),
        7: (tc.CT_I16, ordinal),
    })


def write_parquet(cols: List[Col], codec: Optional[str] = "snappy",
                  row_group_bytes: int = ROW_GROUP_BYTES, page_bytes: int = PAGE_BYTES,
                  dict_bytes: int = DICT_BYTES, spans: Optional[list] = None) -> bytes:
    """A flat parquet file of ``cols`` (all OPTIONAL); ``codec`` "snappy"
    or None. Row groups hold ``row_group_bytes`` of plain-encoded rows.
    ``spans``, when given, receives each row group's (first byte, bytes,
    rows) as written."""
    ccode = {"snappy": 1, None: 0}[codec]
    n = len(cols[0])
    per_row = sum(
        (4 * n + int(c.values[0][-1])) / max(n, 1) if c.kind == "string" else _PQ_WIDTH[c.kind]
        for c in cols)
    rows_per_group = max(1, int(row_group_bytes // per_row))
    parts = [b"PAR1"]
    pos = 4
    rgs = []
    for gi, lo in enumerate(range(0, n, rows_per_group)):
        hi = min(n, lo + rows_per_group)
        chunks = []
        for c in cols:
            blob, md = _chunk(c, lo, hi, ccode, pos, page_bytes, dict_bytes)
            chunks.append((pos, md))
            parts.append(blob)
            pos += len(blob)
        rgs.append(_row_group(chunks, hi - lo, gi))
        if spans is not None:
            spans.append((chunks[0][0], pos - chunks[0][0], hi - lo))
    schema = [_group_schema("spark_schema", len(cols), repetition=None)]
    schema += [_leaf_schema(c.name, c.kind) for c in cols]
    parts.append(_footer(schema, rgs, n))
    return b"".join(parts)


# -- the nested file: l LIST<INT64>, s STRUCT<a INT32, b STRING> -------------


@dataclass
class NestedData:
    """Host arrays of the nested file's columns."""

    list_valid: np.ndarray      # [N] bool
    list_offsets: np.ndarray    # [N+1] int32 (null and empty lists: no entries)
    elem_values: np.ndarray     # [E] int64
    elem_valid: np.ndarray      # [E] bool
    struct_valid: np.ndarray    # [N] bool
    a_values: np.ndarray        # [N] int32 (0 where null)
    a_valid: np.ndarray         # [N] bool (False under a null struct)
    b_offsets: np.ndarray       # [N+1] int32
    b_chars: np.ndarray         # uint8
    b_valid: np.ndarray         # [N] bool


def nested_data(rows: int, seed: int, null_rate: float = 0.05) -> NestedData:
    """LIST<INT64> of 0-8 elements and STRUCT<INT32, STRING>, ``null_rate``
    nulls at each level (a child under a null parent is null too)."""
    rng = np.random.default_rng(seed)
    lv = rng.random(rows) >= null_rate
    lens = np.where(lv, rng.integers(0, 9, rows), 0).astype(np.int32)
    loffs = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=loffs[1:])
    e = int(loffs[-1])
    ev = rng.random(e) >= null_rate
    evals = np.where(ev, rng.integers(-(2**62), 2**62, e), 0).astype(np.int64)
    sv = rng.random(rows) >= null_rate
    av = sv & (rng.random(rows) >= null_rate)
    a = np.where(av, rng.integers(-(2**31), 2**31, rows), 0).astype(np.int32)
    bv = sv & (rng.random(rows) >= null_rate)
    blens = np.where(bv, rng.integers(0, 25, rows), 0).astype(np.int32)
    boffs = np.zeros(rows + 1, np.int32)
    np.cumsum(blens, out=boffs[1:])
    bchars = rng.integers(97, 123, int(boffs[-1])).astype(np.uint8)
    return NestedData(lv, loffs, evals, ev, sv, a, av, boffs, bchars, bv)


def _levels_page(defs: np.ndarray, dbits: int, reps: Optional[np.ndarray], vals: bytes,
                 codec: int):
    lv = b""
    if reps is not None:
        r = rle_hybrid(reps.astype(np.uint32), 1)
        lv += struct.pack("<I", len(r)) + r
    dd = rle_hybrid(defs.astype(np.uint32), dbits)
    raw = lv + struct.pack("<I", len(dd)) + dd + vals
    return raw, _compress(raw, codec)


def write_parquet_nested(nd: NestedData, codec: Optional[str] = "snappy",
                         rows_per_page: int = 100_000) -> bytes:
    """One row group: ``l`` (optional group LIST { repeated group list {
    optional int64 element } }) and ``s`` (optional group { optional int32
    a; optional binary b (UTF8) }), PLAIN values, v1 pages of
    ``rows_per_page`` rows."""
    ccode = {"snappy": 1, None: 0}[codec]
    n = nd.list_valid.size
    lens = np.diff(nd.list_offsets)
    parts = [b"PAR1"]
    pos = 4
    chunks = []
    # l.list.element: max_def 3, max_rep 1; one entry per element, one for
    # a null or empty list
    ent = np.where(lens > 0, lens, 1)
    eoffs = np.zeros(n + 1, np.int64)
    np.cumsum(ent, out=eoffs[1:])
    reps = np.ones(int(eoffs[-1]), np.uint32)
    reps[eoffs[:-1]] = 0
    defs = np.empty(int(eoffs[-1]), np.uint32)
    rows_of = np.repeat(np.arange(n), ent)
    has = lens[rows_of] > 0
    elem = nd.list_offsets[:-1][rows_of] + (np.arange(rows_of.size) - eoffs[:-1][rows_of])
    defs[:] = np.where(nd.list_valid[rows_of], 1, 0)
    defs[has] = np.where(nd.elem_valid[elem[has]], 3, 2)
    pages = []
    for lo in range(0, n, rows_per_page):
        hi = min(n, lo + rows_per_page)
        a, b = int(eoffs[lo]), int(eoffs[hi])
        d = defs[a:b]
        e = elem[a:b][d == 3]
        raw, comp = _levels_page(d, 2, reps[a:b], nd.elem_values[e].tobytes(), ccode)
        pages.append((b - a, raw, comp))
    chunks.append(_pages_chunk(pages, "int64", ["l", "list", "element"], ccode, pos))
    parts.append(chunks[-1][0])
    pos += len(chunks[-1][0])
    # s.a and s.b: max_def 2
    for name, kind in (("a", "int32"), ("b", "string")):
        valid = nd.a_valid if name == "a" else nd.b_valid
        sdefs = np.where(nd.struct_valid, np.where(valid, 2, 1), 0).astype(np.uint32)
        pages = []
        for lo in range(0, n, rows_per_page):
            hi = min(n, lo + rows_per_page)
            keep = np.flatnonzero(valid[lo:hi]) + lo
            if kind == "int32":
                vals = nd.a_values[keep].tobytes()
            else:
                blens = np.diff(nd.b_offsets)[keep]
                koffs = np.zeros(keep.size + 1, np.int32)
                np.cumsum(blens, out=koffs[1:])
                row = np.repeat(np.arange(keep.size), blens)
                kch = nd.b_chars[nd.b_offsets[keep][row] + (np.arange(int(koffs[-1])) - koffs[:-1][row])]
                vals = _plain_strings(koffs, kch)
            raw, comp = _levels_page(sdefs[lo:hi], 2, None, vals, ccode)
            pages.append((hi - lo, raw, comp))
        chunks.append(_pages_chunk(pages, kind, ["s", name], ccode, pos))
        parts.append(chunks[-1][0])
        pos += len(chunks[-1][0])
    rg = _row_group([(off, md) for _, md, off in chunks], n, 0)
    schema = [
        _group_schema("spark_schema", 2, repetition=None),
        _group_schema("l", 1, converted=3),  # LIST
        _group_schema("list", 1, repetition=2),
        _leaf_schema("element", "int64"),
        _group_schema("s", 2),
        _leaf_schema("a", "int32"),
        _leaf_schema("b", "string"),
    ]
    parts.append(_footer(schema, [rg], n))
    return b"".join(parts)


def _pages_chunk(pages, kind: str, path: List[str], codec: int, pos: int):
    out, usize, nvals = [], 0, 0
    for nv, raw, comp in pages:
        hdr = _page_header(0, len(raw), len(comp), f5=ThriftStruct({
            1: _i32(nv), 2: _i32(_E_PLAIN), 3: _i32(_E_RLE), 4: _i32(_E_RLE)}))
        out += [hdr, comp]
        usize += len(hdr) + len(raw)
        nvals += nv
    blob = b"".join(out)
    md = ThriftStruct({
        1: _i32(_PQ_TYPE[kind]),
        2: (tc.CT_LIST, ThriftList(tc.CT_I32, [_E_PLAIN, _E_RLE])),
        3: (tc.CT_LIST, ThriftList(tc.CT_BINARY, [p.encode() for p in path])),
        4: _i32(codec), 5: _i64(nvals), 6: _i64(usize), 7: _i64(len(blob)), 9: _i64(pos),
    })
    return blob, md, pos


# ---------------------------------------------------------------------------
# ORC
# ---------------------------------------------------------------------------

_ORC_KIND = {"double": 6, "int8": 1, "int32": 3, "date": 15, "string": 7}
_V2_WIDTHS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
              23, 24, 26, 28, 30, 32, 40, 48, 56, 64]


def _pb_varint_field(fno: int, v: int) -> bytes:
    return _varint(fno << 3) + _varint(v)


def _pb_bytes_field(fno: int, b: bytes) -> bytes:
    return _varint((fno << 3) | 2) + _varint(len(b)) + b


def _pb_packed(fno: int, vals) -> bytes:
    return _pb_bytes_field(fno, b"".join(_varint(v) for v in vals))


def _bits_be(values: np.ndarray, width: int) -> np.ndarray:
    v = values.astype(np.uint64)
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    bits = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="big")


def rle_v2_direct(values: np.ndarray, signed: bool) -> bytes:
    """ORC integer RLEv2 in DIRECT runs of at most 512 values."""
    v = values.astype(np.int64)
    u = ((v << 1) ^ (v >> 63)).view(np.uint64) if signed else v.view(np.uint64)
    n = u.size
    if n == 0:
        return b""
    need = max(int(u.max()).bit_length(), 1)
    width = next(w for w in _V2_WIDTHS if w >= need)
    code = _V2_WIDTHS.index(width)
    full, rest = divmod(n, 512)
    parts = []
    if full:
        body = _bits_be(u[:full * 512], width).reshape(full, width * 64)
        hdr = np.array([0x40 | (code << 1) | 1, 0xFF], np.uint8)  # run length 512
        parts.append(np.hstack([np.tile(hdr, (full, 1)), body]).tobytes())
    if rest:
        m = rest - 1
        parts.append(bytes([0x40 | (code << 1) | (m >> 8), m & 0xFF])
                     + _bits_be(u[full * 512:], width).tobytes())
    return b"".join(parts)


def byte_rle_literals(values: np.ndarray) -> bytes:
    """ORC byte-RLE in literal runs of at most 128 bytes."""
    b = values.astype(np.uint8)
    n = b.size
    full, rest = divmod(n, 128)
    parts = []
    if full:
        parts.append(np.hstack([np.full((full, 1), 128, np.uint8),
                                b[:full * 128].reshape(full, 128)]).tobytes())
    if rest:
        parts.append(bytes([256 - rest]) + b[full * 128:].tobytes())
    return b"".join(parts)


def _bool_stream(mask: np.ndarray) -> bytes:
    return byte_rle_literals(np.packbits(mask.astype(np.uint8), bitorder="big"))


def orc_zlib(data: bytes, block: int = ORC_BLOCK) -> bytes:
    """ORC's compression framing with raw deflate (level 1): 3-byte headers
    ((length << 1) | isOriginal), chunks of at most ``block`` bytes."""
    out = []
    view = memoryview(data)
    for i in range(0, len(data), block):
        chunk = view[i:i + block]
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        if len(comp) >= len(chunk):
            out.append(((len(chunk) << 1) | 1).to_bytes(3, "little") + bytes(chunk))
        else:
            out.append((len(comp) << 1).to_bytes(3, "little") + comp)
    return b"".join(out)


def _orc_streams(col: Col, ci: int, lo: int, hi: int):
    """[(stream kind, column, bytes)] and the (encoding kind, dictionary
    size) of rows [lo, hi) of ``col``."""
    streams = []
    valid = None if col.validity is None else col.validity[lo:hi].astype(bool)
    if valid is not None and not valid.all():
        streams.append((0, ci, _bool_stream(valid)))
    keep = np.arange(hi - lo) if valid is None else np.flatnonzero(valid)
    if col.kind == "string":
        offs, chars = _string_rows(col.values, lo, hi)
        lens = np.diff(offs)[keep]
        keys = _fixed_strings(offs, chars)[keep]
        uniq, inv = np.unique(keys, return_inverse=True)
        if uniq.size <= 0.8 * max(keep.size, 1):
            ulens = np.array([len(x) for x in uniq.tolist()], np.int64)
            streams.append((1, ci, rle_v2_direct(inv.astype(np.int64), False)))
            streams.append((2, ci, rle_v2_direct(ulens, False)))
            streams.append((3, ci, b"".join(uniq.tolist())))
            return streams, (3, int(uniq.size))
        row = np.repeat(keep, lens)
        koffs = np.zeros(keep.size + 1, np.int64)
        np.cumsum(lens, out=koffs[1:])
        kch = chars[offs[:-1][row] + (np.arange(int(koffs[-1])) - koffs[:-1][np.repeat(
            np.arange(keep.size), lens)])]
        streams.append((1, ci, kch.tobytes()))
        streams.append((2, ci, rle_v2_direct(lens.astype(np.int64), False)))
        return streams, (2, 0)
    vals = np.asarray(col.values[lo:hi])[keep]
    if col.kind == "double":
        streams.append((1, ci, vals.tobytes()))
        return streams, (0, 0)
    if col.kind == "int8":
        streams.append((1, ci, byte_rle_literals(vals.view(np.uint8))))
        return streams, (0, 0)
    streams.append((1, ci, rle_v2_direct(vals.astype(np.int64), True)))
    return streams, (2, 0)


def write_orc(cols: List[Col], stripe_bytes: int = STRIPE_BYTES, block: int = ORC_BLOCK) -> bytes:
    """A flat ORC file of ``cols`` under a root struct, ZLIB-compressed."""
    n = len(cols[0])
    per_row = sum(
        (int(c.values[0][-1]) / max(n, 1) + 1) if c.kind == "string"
        else {"double": 8, "int8": 1, "int32": 4, "date": 4}[c.kind] for c in cols)
    rows_per_stripe = max(1, int(stripe_bytes // per_row))
    parts = [b"ORC"]
    pos = 3
    stripes = []
    for lo in range(0, n, rows_per_stripe):
        hi = min(n, lo + rows_per_stripe)
        streams, encs = [], [(0, 0)]
        for ci, c in enumerate(cols, start=1):
            s, e = _orc_streams(c, ci, lo, hi)
            streams += s
            encs.append(e)
        data_parts, foot = [], b""
        for kind, ci, raw in streams:
            comp = orc_zlib(raw, block)
            data_parts.append(comp)
            foot += _pb_bytes_field(1, _pb_varint_field(1, kind) + _pb_varint_field(2, ci)
                                    + _pb_varint_field(3, len(comp)))
        for kind, size in encs:
            foot += _pb_bytes_field(2, _pb_varint_field(1, kind) + (
                _pb_varint_field(2, size) if kind == 3 else b""))
        foot += _pb_bytes_field(3, b"UTC")
        data = b"".join(data_parts)
        foot_c = orc_zlib(foot, block)
        stripes.append((pos, len(data), len(foot_c), hi - lo))
        parts += [data, foot_c]
        pos += len(data) + len(foot_c)
    footer = _pb_varint_field(1, 3) + _pb_varint_field(2, pos - 3)
    for off, dlen, flen, rows in stripes:
        footer += _pb_bytes_field(3, _pb_varint_field(1, off) + _pb_varint_field(2, 0)
                                  + _pb_varint_field(3, dlen) + _pb_varint_field(4, flen)
                                  + _pb_varint_field(5, rows))
    root = _pb_varint_field(1, 12) + _pb_packed(2, range(1, len(cols) + 1)) + b"".join(
        _pb_bytes_field(3, c.name.encode()) for c in cols)
    footer += _pb_bytes_field(4, root)
    for c in cols:
        footer += _pb_bytes_field(4, _pb_varint_field(1, _ORC_KIND[c.kind]))
    footer += _pb_varint_field(6, n) + _pb_varint_field(8, 0)
    footer_c = orc_zlib(footer, block)
    ps = (_pb_varint_field(1, len(footer_c)) + _pb_varint_field(2, 1) + _pb_varint_field(3, block)
          + _pb_packed(4, [0, 12]) + _pb_varint_field(5, 0) + _pb_varint_field(6, 1)
          + _pb_bytes_field(8000, b"ORC"))
    parts += [footer_c, ps, bytes([len(ps)])]
    return b"".join(parts)
