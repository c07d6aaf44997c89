"""ORC data decode: stripes -> device Columns (port of the JAX package's
``io/orc_reader.py``; the stream decoders are host numpy as there, and
each decoded column is uploaded to ``device`` once).

The reference inherits GPU ORC decode from cudf (SURVEY §2.8 capability
table names "GPU parquet/ORC decode"); this module rebuilds the ORC
side the same way io/parquet_reader.py rebuilds parquet: from-scratch
format parsing (no ORC library — a minimal protobuf wire reader plays
the role thrift_compact plays for parquet), host-side decode of the
sequential/metadata tiers, device-resident Columns out.

Scope: flat AND nested struct-root schemas (STRUCT/LIST/MAP at any
depth; maps assemble as LIST<STRUCT<key,value>>, the cudf shape);
BOOLEAN/BYTE/SHORT/INT/LONG/FLOAT/DOUBLE/STRING/BINARY/DATE/TIMESTAMP/
DECIMAL leaves; DIRECT + DICTIONARY (v2) string encodings; integer
RLEv1 and RLEv2 (short-repeat, direct, delta, patched-base); byte-RLE
and boolean bit streams; NONE/ZLIB/SNAPPY/LZO/LZ4/ZSTD compression
framing. PRESENT streams drive validity with the same present-scatter
shape as the parquet reader; nested presence composes down the type
tree (children store values only where every ancestor is non-null).
UNIONs decode as STRUCT<tag INT8, f0, f1, ...> (sparse mapping of the
dense union; cudf has no union type).

Codecs: ZLIB through the standard library; SNAPPY, LZ4, LZO and ZSTD
through the native codecs (``io/codecs.py``), ZSTD through pyarrow only
where the native library was built without it, as the reference falls
back.

Oracle for tests: pyarrow.orc.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.column import resolve_device, upload
from . import codecs

__all__ = ["read_table", "OrcReadError"]


class OrcReadError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# minimal protobuf wire format reader (the thrift_compact analog)
# ---------------------------------------------------------------------------


class _PB:
    def __init__(self, data: bytes, pos: int = 0, end: Optional[int] = None):
        self.d = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            if self.pos >= self.end:
                raise OrcReadError("pb: truncated varint")
            b = self.d[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def fields(self):
        """Yields (field_no, wire_type, value). value: int for varint,
        bytes for length-delimited, raw int for fixed32/64."""
        while self.pos < self.end:
            key = self.varint()
            fno, wt = key >> 3, key & 7
            if wt == 0:
                yield fno, wt, self.varint()
            elif wt == 2:
                ln = self.varint()
                s = self.pos
                self.pos += ln
                yield fno, wt, self.d[s : self.pos]
            elif wt == 5:
                v = struct.unpack_from("<I", self.d, self.pos)[0]
                self.pos += 4
                yield fno, wt, v
            elif wt == 1:
                v = struct.unpack_from("<Q", self.d, self.pos)[0]
                self.pos += 8
                yield fno, wt, v
            else:
                raise OrcReadError(f"pb: unsupported wire type {wt}")


def _pb_dict(data: bytes) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for fno, _wt, v in _PB(data).fields():
        out.setdefault(fno, []).append(v)
    return out


def _packed_varints(vals: list) -> List[int]:
    """A repeated uint32/uint64 field arrives either as individual
    varints or as PACKED length-delimited blobs of varints."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, int):
            out.append(v)
        else:
            r = _PB(v)
            while r.pos < r.end:
                out.append(r.varint())
    return out


# ---------------------------------------------------------------------------
# compression framing
# ---------------------------------------------------------------------------

_K_NONE, _K_ZLIB, _K_SNAPPY, _K_LZO, _K_LZ4, _K_ZSTD = 0, 1, 2, 3, 4, 5


def _decompress_block(kind: int, blob: bytes, block_size: int) -> bytes:
    if kind == _K_ZLIB:
        return zlib.decompress(blob, -15)  # raw deflate
    if kind == _K_SNAPPY:
        return codecs.snappy_uncompress(blob)
    if kind == _K_LZ4:
        # LZ4 block; decompressed chunk is bounded by compressionBlockSize
        return codecs.lz4_decompress_block(blob, max(block_size, 1 << 18))
    if kind == _K_ZSTD:
        if codecs.has_zstd():
            # frame content size when declared, else the ORC chunk
            # bound; the header is untrusted bytes, so the allocation
            # is CLAMPED to the block size a valid chunk can reach
            bound = max(block_size, 1 << 18)
            size = codecs.zstd_frame_content_size(blob)
            if size > bound:
                raise OrcReadError(f"zstd chunk declares {size} bytes > block size {bound}")
            return codecs.zstd_decompress(blob, size if size >= 0 else bound)
        try:
            import pyarrow as pa
        except ImportError:
            raise OrcReadError(str(codecs._missing_zstd())) from None

        # zstd frames carry no decompressed size in ORC chunks: stream
        return pa.input_stream(pa.BufferReader(blob), compression="zstd").read()
    if kind == _K_LZO:
        # LZO1X chunk; decompressed size bounded by compressionBlockSize
        return codecs.lzo1x_decompress(blob, max(block_size, 1 << 18))
    raise OrcReadError(f"unsupported compression kind {kind}")


def _deframe(data: bytes, kind: int, block_size: int = 1 << 18) -> bytes:
    """ORC compressed streams are chunked: 3-byte LE header =
    (length << 1) | isOriginal."""
    if kind == _K_NONE:
        return data
    out = []
    pos = 0
    n = len(data)
    while pos + 3 <= n:
        hdr = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        pos += 3
        ln = hdr >> 1
        chunk = data[pos : pos + ln]
        pos += ln
        out.append(chunk if (hdr & 1) else _decompress_block(kind, chunk, block_size))
    return b"".join(out)


# ---------------------------------------------------------------------------
# low-level decoders
# ---------------------------------------------------------------------------


def _byte_rle(data: bytes, count: int) -> np.ndarray:
    out = np.empty(count, np.uint8)
    pos = 0
    filled = 0
    while filled < count and pos < len(data):
        ctrl = data[pos]
        pos += 1
        if ctrl < 128:  # run
            run = ctrl + 3
            take = min(run, count - filled)
            out[filled : filled + take] = data[pos]
            pos += 1
            filled += take
        else:  # literals
            lit = 256 - ctrl
            take = min(lit, count - filled)
            out[filled : filled + take] = np.frombuffer(data, np.uint8, take, pos)
            pos += lit
            filled += take
    if filled < count:
        raise OrcReadError("byte rle: truncated")
    return out


def _bool_bits(data: bytes, count: int) -> np.ndarray:
    """Boolean stream: byte-RLE over bytes of 8 MSB-first bits."""
    nbytes = (count + 7) // 8
    raw = _byte_rle(data, nbytes)
    return np.unpackbits(raw, bitorder="big")[:count].astype(bool)


def _zigzag(u: np.ndarray) -> np.ndarray:
    """Zigzag decode in the UNSIGNED 64-bit domain: `u >> 1` must be a
    logical shift of the raw encoding (an arithmetic shift on a negative
    int64 reinterpretation corrupts every value with |v| >= 2^62)."""
    uu = np.asarray(u, dtype=np.int64).view(np.uint64)
    dec = (uu >> np.uint64(1)) ^ (np.uint64(0) - (uu & np.uint64(1)))
    return dec.view(np.int64)


def _zigzag_py(v: int) -> int:
    """Zigzag decode of a raw unsigned Python int (any magnitude up to
    2^64-1 — np.int64() would raise OverflowError above 2^63-1)."""
    return (v >> 1) ^ -(v & 1)


def _varints(data: bytes, pos: int, count: int) -> Tuple[np.ndarray, int]:
    out = np.empty(count, np.int64)
    for i in range(count):
        v = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        v &= 0xFFFFFFFFFFFFFFFF  # 64-bit two's complement lane
        out[i] = v - (1 << 64) if v >= (1 << 63) else v
    return out, pos


def _rle_v1(data: bytes, count: int, signed: bool) -> np.ndarray:
    out = np.empty(count, np.int64)
    pos = 0
    filled = 0
    while filled < count:
        ctrl = data[pos]
        pos += 1
        if ctrl < 128:
            run = ctrl + 3
            delta = struct.unpack_from("b", data, pos)[0]
            pos += 1
            base_arr, pos = _varints(data, pos, 1)
            base = int(base_arr[0])
            if signed:
                base = _zigzag_py(base & 0xFFFFFFFFFFFFFFFF)
            take = min(run, count - filled)
            out[filled : filled + take] = base + delta * np.arange(take, dtype=np.int64)
            filled += take
        else:
            lit = 256 - ctrl
            vals, pos = _varints(data, pos, lit)
            if signed:
                vals = _zigzag(vals)
            take = min(lit, count - filled)
            out[filled : filled + take] = vals[:take]
            filled += take
    return out


_V2_WIDTHS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48, 56, 64,
]


def _unpack_be(data: bytes, pos: int, width: int, count: int) -> Tuple[np.ndarray, int]:
    """Big-endian bit-packed unsigned ints (ORC packs MSB-first).
    Accumulates in uint64 (bit 63 is data, not sign) and reinterprets
    as int64 two's complement lanes."""
    if width == 0:
        return np.zeros(count, np.int64), pos
    nbits = width * count
    nbytes = (nbits + 7) // 8
    raw = np.frombuffer(data, np.uint8, nbytes, pos)
    bits = np.unpackbits(raw, bitorder="big")[:nbits].reshape(count, width)
    weights = (np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64))
    vals = (bits.astype(np.uint64) * weights).sum(axis=1, dtype=np.uint64)
    return vals.view(np.int64), pos + nbytes


def _rle_v2(data: bytes, count: int, signed: bool) -> np.ndarray:
    out = np.empty(count, np.int64)
    pos = 0
    filled = 0
    while filled < count:
        first = data[pos]
        enc = first >> 6
        if enc == 0:  # short repeat
            width = ((first >> 3) & 0x7) + 1
            run = (first & 0x7) + 3
            pos += 1
            v = int.from_bytes(data[pos : pos + width], "big")
            pos += width
            val = _zigzag_py(v) if signed else v
            take = min(run, count - filled)
            out[filled : filled + take] = val
            filled += take
        elif enc == 1:  # direct
            width = _V2_WIDTHS[(first >> 1) & 0x1F]
            run = ((first & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            vals, pos = _unpack_be(data, pos, width, run)
            if signed:
                vals = _zigzag(vals)
            take = min(run, count - filled)
            out[filled : filled + take] = vals[:take]
            filled += take
        elif enc == 3:  # delta
            wcode = (first >> 1) & 0x1F
            width = 0 if wcode == 0 else _V2_WIDTHS[wcode]
            run = ((first & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            r = _PB(data, pos)
            base_u = r.varint() & 0xFFFFFFFFFFFFFFFF
            base = _zigzag_py(base_u) if signed else base_u
            delta_base_u = r.varint() & 0xFFFFFFFFFFFFFFFF
            delta_base = _zigzag_py(delta_base_u)
            pos = r.pos
            vals = np.empty(run, np.int64)
            vals[0] = base
            if run > 1:
                vals[1] = base + delta_base
                if run > 2:
                    if width:
                        deltas, pos = _unpack_be(data, pos, width, run - 2)
                    else:
                        deltas = np.full(run - 2, abs(delta_base), np.int64)
                    sign = 1 if delta_base >= 0 else -1
                    vals[2:] = vals[1] + sign * np.cumsum(deltas)
            take = min(run, count - filled)
            out[filled : filled + take] = vals[:take]
            filled += take
        else:  # enc == 2: patched base
            width = _V2_WIDTHS[(first >> 1) & 0x1F]
            run = ((first & 1) << 8 | data[pos + 1]) + 1
            third, fourth = data[pos + 2], data[pos + 3]
            bw = ((third >> 5) & 0x7) + 1
            pw = _V2_WIDTHS[third & 0x1F]
            pgw = ((fourth >> 5) & 0x7) + 1
            pll = fourth & 0x1F
            pos += 4
            base = int.from_bytes(data[pos : pos + bw], "big")
            sign_mask = 1 << (bw * 8 - 1)
            if base & sign_mask:
                base = -(base & (sign_mask - 1))
            pos += bw
            vals, pos = _unpack_be(data, pos, width, run)
            if pll:
                # patch entries use the closest ALIGNED fixed width
                patch_entry_w = next(
                    w for w in (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64) if w >= pgw + pw
                )
                patches, pos = _unpack_be(data, pos, patch_entry_w, pll)
                idx = 0
                for p in patches:
                    pu = int(p) % (1 << 64)  # unsigned view of the entry
                    gap = pu >> pw
                    patch_bits = pu & ((1 << pw) - 1)
                    idx += gap
                    v = (int(vals[idx]) % (1 << 64)) | (patch_bits << width)
                    vals[idx] = v - (1 << 64) if v >= (1 << 63) else v
            vals = vals + base
            take = min(run, count - filled)
            out[filled : filled + take] = vals[:take]
            filled += take
    return out


# ---------------------------------------------------------------------------
# metadata messages
# ---------------------------------------------------------------------------

# orc_proto.Type.Kind
_T_BOOLEAN, _T_BYTE, _T_SHORT, _T_INT, _T_LONG = 0, 1, 2, 3, 4
_T_FLOAT, _T_DOUBLE, _T_STRING, _T_BINARY, _T_TIMESTAMP = 5, 6, 7, 8, 9
_T_LIST, _T_MAP, _T_STRUCT, _T_UNION = 10, 11, 12, 13
_T_DECIMAL, _T_DATE, _T_VARCHAR, _T_CHAR = 14, 15, 16, 17

_S_PRESENT, _S_DATA, _S_LENGTH, _S_DICT_DATA, _S_SECONDARY = 0, 1, 2, 3, 5
_E_DIRECT, _E_DICTIONARY, _E_DIRECT_V2, _E_DICTIONARY_V2 = 0, 1, 2, 3


@dataclass
class _TypeNode:
    kind: int
    subtypes: List[int] = field(default_factory=list)
    field_names: List[str] = field(default_factory=list)
    precision: int = 0
    scale: int = 0


@dataclass
class _Stripe:
    offset: int
    index_len: int
    data_len: int
    footer_len: int
    num_rows: int


def _parse_tail(data: bytes):
    ps_len = data[-1]
    ps = _pb_dict(data[-1 - ps_len : -1])
    footer_len = ps.get(1, [0])[0]
    kind = ps.get(2, [_K_NONE])[0]
    block_size = ps.get(3, [1 << 18])[0]
    footer_raw = data[-1 - ps_len - footer_len : -1 - ps_len]
    footer = _pb_dict(_deframe(footer_raw, kind, block_size))

    types: List[_TypeNode] = []
    for traw in footer.get(4, []):
        td = _pb_dict(traw)
        types.append(
            _TypeNode(
                kind=td.get(1, [_T_STRUCT])[0],
                subtypes=_packed_varints(td.get(2, [])),
                field_names=[x.decode() for x in td.get(3, [])],
                precision=td.get(5, [0])[0],
                scale=td.get(6, [0])[0],
            )
        )
    stripes = []
    for sraw in footer.get(3, []):
        sd = _pb_dict(sraw)
        stripes.append(
            _Stripe(
                offset=sd.get(1, [0])[0],
                index_len=sd.get(2, [0])[0],
                data_len=sd.get(3, [0])[0],
                footer_len=sd.get(4, [0])[0],
                num_rows=sd.get(5, [0])[0],
            )
        )
    num_rows = footer.get(6, [0])[0]
    return types, stripes, kind, num_rows, block_size


# ---------------------------------------------------------------------------
# column assembly
# ---------------------------------------------------------------------------

_INT_KINDS = {_T_BYTE: dt.INT8, _T_SHORT: dt.INT16, _T_INT: dt.INT32, _T_LONG: dt.INT64,
              _T_DATE: dt.INT32}
_ORC_TS_EPOCH = 1420070400  # 2015-01-01 00:00:00 UTC, the ORC timestamp base


def _scatter_present(values: np.ndarray, present: Optional[np.ndarray], fill=0) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if present is None:
        return values, None
    n = len(present)
    out = np.full(n, fill, dtype=values.dtype)
    out[present] = values[: int(present.sum())]
    return out, present


class _StripeReader:
    def __init__(self, data: bytes, stripe: _Stripe, kind: int, block_size: int = 1 << 18):
        self.kind = kind
        self.block_size = block_size
        foot = _pb_dict(
            _deframe(
                data[stripe.offset + stripe.index_len + stripe.data_len :
                     stripe.offset + stripe.index_len + stripe.data_len + stripe.footer_len],
                kind,
                block_size,
            )
        )
        self.encodings = []
        for eraw in foot.get(2, []):
            ed = _pb_dict(eraw)
            self.encodings.append((ed.get(1, [_E_DIRECT])[0], ed.get(2, [0])[0]))
        # stream directory: (column, kind) -> raw bytes
        self.streams: Dict[Tuple[int, int], bytes] = {}
        pos = stripe.offset  # index streams come first; walk everything
        for sraw in foot.get(1, []):
            sd = _pb_dict(sraw)
            skind = sd.get(1, [0])[0]
            col = sd.get(2, [0])[0]
            ln = sd.get(3, [0])[0]
            self.streams[(col, skind)] = data[pos : pos + ln]
            pos += ln
        self.num_rows = stripe.num_rows

    def stream(self, col: int, skind: int) -> Optional[bytes]:
        raw = self.streams.get((col, skind))
        return None if raw is None else _deframe(raw, self.kind, self.block_size)

    def present(self, col: int, count: Optional[int] = None) -> Optional[np.ndarray]:
        raw = self.stream(col, _S_PRESENT)
        if raw is None:
            return None
        return _bool_bits(raw, self.num_rows if count is None else count)

    def ints(self, col: int, signed: bool, count: int) -> np.ndarray:
        return self.ints_stream(col, _S_DATA, signed, count)

    def ints_stream(self, col: int, skind: int, signed: bool, count: int) -> np.ndarray:
        raw = self.stream(col, skind)
        enc = self.encodings[col][0]
        if enc in (_E_DIRECT_V2, _E_DICTIONARY_V2):
            return _rle_v2(raw, count, signed)
        return _rle_v1(raw, count, signed)

    def lengths(self, col: int, count: int) -> np.ndarray:
        raw = self.stream(col, _S_LENGTH)
        enc = self.encodings[col][0]
        if enc in (_E_DIRECT_V2, _E_DICTIONARY_V2):
            return _rle_v2(raw, count, False)
        return _rle_v1(raw, count, False)


def _read_column(rd: _StripeReader, col: int, types: List[_TypeNode],
                 count: Optional[int] = None):
    """Returns (values np/tuple, present np|None) for one stripe.

    ``count`` is the column's value count at its nesting level (stripe
    rows at the root; the parent's non-null count under a STRUCT; the
    summed lengths under a LIST/MAP) — ORC presence and data streams
    are all relative to the parent's surviving entries.
    """
    tnode = types[col]
    if count is None:
        count = rd.num_rows
    present = rd.present(col, count)
    n_present = int(present.sum()) if present is not None else count

    k = tnode.kind
    if k == _T_STRUCT:
        children = [_read_column(rd, sub, types, n_present) for sub in tnode.subtypes]
        return ("struct", children), present
    if k in (_T_LIST, _T_MAP):
        lens = rd.lengths(col, n_present).astype(np.int64)
        child_count = int(lens.sum())
        if k == _T_LIST:
            child = _read_column(rd, tnode.subtypes[0], types, child_count)
            return ("list", lens, child), present
        key = _read_column(rd, tnode.subtypes[0], types, child_count)
        val = _read_column(rd, tnode.subtypes[1], types, child_count)
        return ("map", lens, key, val), present
    if k == _T_BYTE:  # tinyint DATA is byte-RLE, not integer RLE
        raw = rd.stream(col, _S_DATA)
        return _byte_rle(raw, n_present).view(np.int8), present
    if k in _INT_KINDS:
        vals = rd.ints(col, True, n_present)
        return vals, present
    if k == _T_BOOLEAN:
        raw = rd.stream(col, _S_DATA)
        return _bool_bits(raw, n_present), present
    if k in (_T_FLOAT, _T_DOUBLE):
        raw = rd.stream(col, _S_DATA)
        npdt = np.float32 if k == _T_FLOAT else np.float64
        return np.frombuffer(raw, npdt, n_present), present
    if k in (_T_STRING, _T_VARCHAR, _T_CHAR, _T_BINARY):
        enc = rd.encodings[col][0]
        if enc in (_E_DICTIONARY, _E_DICTIONARY_V2):
            dict_size = rd.encodings[col][1]
            dlens = rd.lengths(col, dict_size)
            dchars = rd.stream(col, _S_DICT_DATA) or b""
            idx = rd.ints(col, False, n_present)
            doffs = np.zeros(dict_size + 1, np.int64)
            np.cumsum(dlens, out=doffs[1:])
            lens = dlens[idx] if dict_size else np.zeros(n_present, np.int64)
            starts = doffs[idx] if dict_size else np.zeros(n_present, np.int64)
            return ("bytes", lens.astype(np.int32), np.frombuffer(dchars, np.uint8), starts), present
        lens = rd.lengths(col, n_present)
        chars = rd.stream(col, _S_DATA) or b""
        starts = np.zeros(n_present, np.int64)
        if n_present:
            np.cumsum(lens[:-1], out=starts[1:])
        return ("bytes", lens.astype(np.int32), np.frombuffer(chars, np.uint8), starts), present
    if k == _T_TIMESTAMP:
        # DATA: seconds relative to 2015-01-01 UTC (signed RLE);
        # SECONDARY: nanos with the trailing-zero packing (low 3 bits =
        # zero-count code c; c != 0 restores c+1 trailing zeros)
        secs = rd.ints(col, True, n_present).astype(np.int64)
        raw = rd.ints_stream(col, _S_SECONDARY, False, n_present).view(np.uint64)
        z = (raw & np.uint64(7)).astype(np.int64)
        nanos = (raw >> np.uint64(3)).astype(np.int64)
        scale_f = np.power(10, np.where(z != 0, z + 1, 0)).astype(np.int64)
        nanos = nanos * scale_f
        # no pre-epoch second adjustment: the ORC C++ writer (pyarrow's)
        # stores floor(seconds) directly, so seconds + nanos compose for
        # negative values too (validated against the oracle incl.
        # pre-2015 and pre-1970 fractional timestamps)
        total = (secs + np.int64(_ORC_TS_EPOCH)) * np.int64(1_000_000_000) + nanos
        return total, present
    if k == _T_DECIMAL:
        # DATA: unbounded zigzag base-128 varints (can exceed 64 bits);
        # SECONDARY: per-value scale (signed RLE). Host decode: decimal
        # columns are metadata-scale next to the fact lanes.
        raw = rd.stream(col, _S_DATA) or b""
        vals: List[int] = []
        pos = 0
        for _ in range(n_present):
            v = 0
            shift = 0
            while True:
                b = raw[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            vals.append((v >> 1) ^ -(v & 1))
        scales = rd.ints_stream(col, _S_SECONDARY, True, n_present)
        declared = tnode.scale
        out: List[int] = []
        for v, s_ in zip(vals, scales.tolist()):
            if s_ > declared:  # cannot happen in valid files; guard
                raise OrcReadError("decimal stored scale exceeds declared scale")
            out.append(v * (10 ** int(declared - s_)))
        return ("decimal", out), present
    if k == _T_UNION:
        # DATA: byte-RLE variant tags; each child carries only the
        # values whose tag selects it (ORC dense-union layout)
        raw = rd.stream(col, _S_DATA)
        tags = _byte_rle(raw, n_present)
        children = []
        for ci, sub in enumerate(tnode.subtypes):
            ccount = int((tags == ci).sum())
            children.append(_read_column(rd, sub, types, ccount))
        return ("union", tags, children), present
    raise OrcReadError(f"unsupported ORC type kind {k}")


def _assemble_nested(
    tnode: _TypeNode,
    types: List[_TypeNode],
    pieces: List,
    presents: List[np.ndarray],
    dev: torch.device,
) -> Column:
    """Merge per-stripe pieces of one (possibly nested) column into a
    device Column. ``presents`` are FULL-length masks at this nesting
    level per stripe (parent presence already composed in: a child
    stores values only where every ancestor is non-null, so masks
    compose by scattering the child's packed mask into the parent's
    surviving positions). MAPs assemble as LIST<STRUCT<key,value>> —
    the cudf representation the parquet reader uses too."""
    present_all = np.concatenate(presents) if presents else np.zeros(0, bool)
    has_nulls = not bool(present_all.all())
    k = tnode.kind

    if k == _T_STRUCT:
        child_cols = []
        for ci, sub in enumerate(tnode.subtypes):
            sub_pieces, sub_presents = [], []
            for sp, ppres in zip(pieces, presents):
                cpiece, cpres = sp[1][ci]
                n_par = int(ppres.sum())
                packed = cpres if cpres is not None else np.ones(n_par, bool)
                full = np.zeros(len(ppres), bool)
                full[np.flatnonzero(ppres)] = packed
                sub_pieces.append(cpiece)
                sub_presents.append(full)
            child_cols.append(_assemble_nested(types[sub], types, sub_pieces, sub_presents, dev))
        return Column.struct_from_parts(
            child_cols, tnode.field_names,
            validity=present_all if has_nulls else None, device=dev,
        )

    if k in (_T_LIST, _T_MAP):
        full_lens_parts = []
        child_sets: List[List] = [[], []] if k == _T_MAP else [[]]
        child_pres: List[List[np.ndarray]] = [[], []] if k == _T_MAP else [[]]
        for sp, ppres in zip(pieces, presents):
            lens = sp[1]
            fl = np.zeros(len(ppres), np.int64)
            fl[ppres] = lens
            full_lens_parts.append(fl)
            cc = int(lens.sum())
            kids = (sp[2],) if k == _T_LIST else (sp[2], sp[3])
            for ci, (cpiece, cpres) in enumerate(kids):
                child_sets[ci].append(cpiece)
                child_pres[ci].append(cpres if cpres is not None else np.ones(cc, bool))
        full_lens = (
            np.concatenate(full_lens_parts) if full_lens_parts else np.zeros(0, np.int64)
        )
        offsets = np.zeros(len(full_lens) + 1, np.int32)
        np.cumsum(full_lens, out=offsets[1:])
        if k == _T_LIST:
            child = _assemble_nested(
                types[tnode.subtypes[0]], types, child_sets[0], child_pres[0], dev
            )
        else:
            key = _assemble_nested(types[tnode.subtypes[0]], types, child_sets[0], child_pres[0],
                                   dev)
            val = _assemble_nested(types[tnode.subtypes[1]], types, child_sets[1], child_pres[1],
                                   dev)
            child = Column.struct_from_parts([key, val], ["key", "value"], device=dev)
        return Column.list_from_parts(
            offsets, child, validity=present_all if has_nulls else None, device=dev
        )

    if k == _T_UNION:
        # Dense union -> STRUCT<tag INT8, f0, f1, ...>: cudf (and the
        # Table tier here) has no union type, so each variant
        # materializes full-length with validity tag==ci — the sparse
        # mapping of an arrow dense union. The tag field preserves
        # lossless round-tripping.
        tag_parts = []
        child_sets: List[List] = [[] for _ in tnode.subtypes]
        child_pres: List[List[np.ndarray]] = [[] for _ in tnode.subtypes]
        for sp, ppres in zip(pieces, presents):
            tags = sp[1]  # packed to this level's surviving entries
            full_tags = np.zeros(len(ppres), np.int8)
            full_tags[np.flatnonzero(ppres)] = tags.astype(np.int8)
            tag_parts.append(full_tags)
            surv = np.flatnonzero(ppres)
            for ci, (cpiece, cpres) in enumerate(sp[2]):
                n_ci = int((tags == ci).sum())
                packed = cpres if cpres is not None else np.ones(n_ci, bool)
                full = np.zeros(len(ppres), bool)
                full[surv[tags == ci]] = packed
                child_sets[ci].append(cpiece)
                child_pres[ci].append(full)
        tags_all = (
            np.concatenate(tag_parts) if tag_parts else np.zeros(0, np.int8)
        )
        fields = [Column(dt.INT8, data=upload(tags_all, dev))]
        names = ["tag"]
        for ci, sub in enumerate(tnode.subtypes):
            fields.append(_assemble_nested(types[sub], types, child_sets[ci], child_pres[ci], dev))
            names.append(f"f{ci}")
        return Column.struct_from_parts(
            fields, names, validity=present_all if has_nulls else None, device=dev
        )

    return _to_column_normalized(pieces, present_all, tnode, dev)


def read_table(file_bytes: bytes, columns: Optional[List[str]] = None, device=None) -> Table:
    """Read an ORC file (flat or nested schema) into a Table on ``device``
    (None means the card)."""
    dev = resolve_device(device)
    if not file_bytes.startswith(b"ORC"):
        raise OrcReadError("not an ORC file")
    types, stripes, kind, _num_rows, block_size = _parse_tail(file_bytes)
    if not types or types[0].kind != _T_STRUCT:
        raise OrcReadError("ORC root must be a struct")
    root = types[0]

    names = root.field_names
    sel = list(range(len(names)))
    if columns is not None:
        keep = set(columns)
        missing = keep - set(names)
        if missing:
            raise OrcReadError(f"columns not in schema: {sorted(missing)}")
        sel = [i for i, nm in enumerate(names) if nm in keep]

    readers = [_StripeReader(file_bytes, s, kind, block_size) for s in stripes]
    out_cols, out_names = [], []
    for i in sel:
        col_id = root.subtypes[i]
        tnode = types[col_id]
        parts, presents = [], []
        for rd in readers:
            vals, present = _read_column(rd, col_id, types)
            parts.append(vals)
            presents.append(present if present is not None else np.ones(rd.num_rows, bool))
        col = _assemble_nested(tnode, types, parts, presents, dev)
        out_cols.append(col)
        out_names.append(names[i])
    return Table(out_cols, names=out_names)


def _to_column_normalized(parts, present_all: np.ndarray, tnode: _TypeNode,
                          dev: torch.device) -> Column:
    """Like _to_column but with a prebuilt global present mask."""
    has_nulls = not present_all.all()
    present = present_all if has_nulls else None
    k = tnode.kind
    if k in (_T_STRING, _T_VARCHAR, _T_CHAR, _T_BINARY):
        lens_parts, chars_parts = [], []
        for part in parts:
            _tag, lens, chars, starts = part
            lens_parts.append(lens)
            total = int(lens.sum())
            if total:
                reps = np.repeat(starts, lens)
                within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
                chars_parts.append(chars[(reps + within).astype(np.int64)])
            else:
                chars_parts.append(np.zeros(0, np.uint8))
        lens_all = np.concatenate(lens_parts) if lens_parts else np.zeros(0, np.int32)
        chars_all = np.concatenate(chars_parts) if chars_parts else np.zeros(0, np.uint8)
        n = len(present_all)
        if has_nulls:
            full_lens = np.zeros(n, np.int32)
            full_lens[present] = lens_all
        else:
            full_lens = lens_all
        offsets = np.zeros(n + 1, np.int32)
        np.cumsum(full_lens, out=offsets[1:])
        return Column.strings_from_parts(offsets, chars_all,
                                         None if not has_nulls else present, device=dev)

    if k == _T_DECIMAL:
        merged: List[int] = []
        for p in parts:
            merged.extend(p[1])
        out_vals: List[Optional[int]] = []
        j = 0
        for ok in present_all.tolist():
            if ok:
                out_vals.append(merged[j])
                j += 1
            else:
                out_vals.append(None)
        d = dt.decimal64(-tnode.scale) if tnode.precision <= 18 else dt.decimal128(-tnode.scale)
        return Column.from_pylist(out_vals, d, device=dev)
    if k == _T_TIMESTAMP:
        vals = np.concatenate([np.asarray(p) for p in parts]) if parts else np.zeros(0, np.int64)
        full, _ = _scatter_present(vals, present)
        return Column.from_numpy(full, dt.TIMESTAMP_NANOSECONDS,
                                 validity=present if has_nulls else None, device=dev)
    vals = np.concatenate([np.asarray(p) for p in parts]) if parts else np.zeros(0, np.int64)
    if k == _T_BOOLEAN:
        full, _ = _scatter_present(vals.astype(np.uint8), present)
        return Column.from_numpy(full, dt.BOOL8, validity=present if has_nulls else None,
                                 device=dev)
    if k in (_T_FLOAT, _T_DOUBLE):
        full, _ = _scatter_present(vals, present)
        cd = dt.FLOAT32 if k == _T_FLOAT else dt.FLOAT64
        return Column.from_numpy(full, cd, validity=present if has_nulls else None, device=dev)
    cd = _INT_KINDS[k]
    full, _ = _scatter_present(vals.astype(np.dtype(cd.np_dtype)), present)
    return Column.from_numpy(full, cd, validity=present if has_nulls else None, device=dev)
