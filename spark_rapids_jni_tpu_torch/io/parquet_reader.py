"""Parquet data decode: column chunks -> device Columns (port of the JAX
package's ``io/parquet_reader.py``).

Scope as in the reference: nested schemas (lists / structs / maps, any
depth), PLAIN and PLAIN_DICTIONARY / RLE_DICTIONARY encodings,
RLE/bit-packed levels, data pages v1 and v2, and the codecs the
reference reads: snappy, LZ4 (raw and Hadoop-framed), LZO (Hadoop-framed)
and zstd through the native codecs (``io/codecs.py``), gzip and brotli
through pyarrow as the reference does, and zstd through pyarrow only
where the native library was built without it.

The device work is the reference's: each page's value bytes are
uploaded once and the O(values) work runs on ``device``: the expansion
of dictionary indices from a host-parsed run directory (one
``searchsorted``, five byte gathers and a shift), the strip of the
length prefixes of PLAIN strings (a ragged gather), the dictionary
gather, and the scatter of present values into their slots. Level
streams and the nested assembly stay host numpy, as in the reference.
Where the reference relies on JAX clamping an out-of-range gather (an
all-null chunk, a run past its stream), the port clamps the index
explicitly: a CUDA gather does not clamp.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.column import resolve_device, upload
from ..ops.bitutils import ragged_positions
from . import codecs
from . import thrift_compact as tc

__all__ = ["read_table", "ParquetReadError"]


class ParquetReadError(RuntimeError):
    pass


# physical types (parquet.thrift Type)
_T_BOOLEAN = 0
_T_INT32 = 1
_T_INT64 = 2
_T_INT96 = 3
_T_FLOAT = 4
_T_DOUBLE = 5
_T_BYTE_ARRAY = 6
_T_FIXED_LEN_BYTE_ARRAY = 7

# encodings
_E_PLAIN = 0
_E_PLAIN_DICTIONARY = 2
_E_RLE = 3
_E_RLE_DICTIONARY = 8

# page types
_P_DATA = 0
_P_DICTIONARY = 2
_P_DATA_V2 = 3

# compression codecs (parquet.thrift CompressionCodec)
_CODECS = {0: None, 1: "snappy", 2: "gzip", 3: "lzo", 4: "brotli", 5: "lz4",
           6: "zstd", 7: "lz4_raw"}

# converted types
_C_UTF8 = 0
_C_MAP = 1
_C_MAP_KEY_VALUE = 2
_C_LIST = 3

# repetition
_R_REQUIRED = 0
_R_OPTIONAL = 1
_R_REPEATED = 2

# PageHeader field ids
_PH_TYPE = 1
_PH_UNCOMP = 2
_PH_COMP = 3
_PH_DATA = 5
_PH_DICT = 7
_PH_DATA_V2 = 8
# DataPageHeader
_DPH_NUM_VALUES = 1
_DPH_ENCODING = 2
# DataPageHeaderV2
_DPH2_NUM_VALUES = 1
_DPH2_NUM_NULLS = 2
_DPH2_NUM_ROWS = 3
_DPH2_ENCODING = 4
_DPH2_DEF_BYTES = 5
_DPH2_REP_BYTES = 6
_DPH2_COMPRESSED = 7
# SchemaElement / metadata ids reused from parquet_footer
from .parquet_footer import (  # noqa: E402
    _CC_META_DATA,
    _CMD_DATA_PAGE_OFFSET,
    _CMD_DICT_PAGE_OFFSET,
    _CMD_TOTAL_COMPRESSED_SIZE,
    _FMD_ROW_GROUPS,
    _FMD_SCHEMA,
    _RG_COLUMNS,
    _RG_NUM_ROWS,
    _SE_CONVERTED_TYPE,
    _SE_NAME,
    _SE_NUM_CHILDREN,
    _SE_REPETITION,
    _SE_TYPE,
)

_CMD_TYPE = 1
_CMD_ENCODINGS = 2
_CMD_PATH = 3
_CMD_CODEC = 4
_CMD_NUM_VALUES = 5
_CMD_TOTAL_UNCOMPRESSED = 6


def _lz4_hadoop(data, uncompressed_size: int) -> Optional[bytes]:
    """Legacy parquet codec 5 (LZ4) as written by Hadoop/parquet-mr:
    repeated [u32 BE uncompressed size][u32 BE compressed size][raw LZ4
    block]. Returns None when the framing does not validate (some
    writers used the LZ4 frame format instead; the caller falls back)."""
    return _hadoop_blocks(data, uncompressed_size, _lz4_raw_block)


def _lzo_hadoop(data, uncompressed_size: int) -> Optional[bytes]:
    """Parquet codec 3 (LZO): Hadoop block framing, repeated [u32 BE
    uncompressed size][u32 BE compressed size][raw LZO1X stream]. Returns
    None when the framing does not validate."""
    return _hadoop_blocks(data, uncompressed_size, codecs.lzo1x_decompress)


def _hadoop_blocks(data, uncompressed_size: int, decode) -> Optional[bytes]:
    pos, n = 0, len(data)
    parts: List[bytes] = []
    total = 0
    while pos < n:
        if pos + 8 > n:
            return None
        (usize,) = struct.unpack_from(">I", data, pos)
        (csize,) = struct.unpack_from(">I", data, pos + 4)
        pos += 8
        if csize == 0 or pos + csize > n or total + usize > uncompressed_size:
            return None
        block = data[pos : pos + csize]
        pos += csize
        try:
            out = decode(block, usize)
        except RuntimeError:  # the framing did not validate: the caller tries the next
            return None
        if len(out) != usize:
            return None
        parts.append(out)
        total += usize
    if total != uncompressed_size:
        return None
    return b"".join(parts)


def _lz4_raw_block(block, uncompressed_size: int):
    """One raw LZ4 block through the native decoder."""
    return codecs.lz4_decompress_block(block, uncompressed_size)


def _pyarrow_decompress(data, codec: str, uncompressed_size: int) -> bytes:
    import pyarrow as pa

    return pa.Codec(codec).decompress(data, decompressed_size=uncompressed_size).to_pybytes()


def _decompress(data, codec: Optional[str], uncompressed_size: int):
    if codec is None:
        return data
    if codec == "snappy":
        return codecs.snappy_uncompress(data, uncompressed_size)
    if codec == "lz4":
        # legacy codec 5: Hadoop block framing in the wild (parquet-mr);
        # LZ4 *frame* format from other writers: try Hadoop first
        out = _lz4_hadoop(data, uncompressed_size)
        if out is not None:
            return out
    if codec == "lzo":
        # codec 3: Hadoop block framing around raw LZO1X blocks; pyarrow
        # ships no LZO codec, so this is native-or-error
        out = _lzo_hadoop(data, uncompressed_size)
        if out is None:
            raise ParquetReadError("malformed Hadoop LZO page framing")
        return out
    if codec == "zstd":
        if not codecs.has_zstd():
            try:
                return _pyarrow_decompress(data, codec, uncompressed_size)
            except ImportError:
                raise ParquetReadError(str(codecs._missing_zstd())) from None
        out = codecs.zstd_decompress(data, uncompressed_size)
        if len(out) != uncompressed_size:  # corrupt page: fail loudly
            raise ParquetReadError(
                f"zstd page decoded to {len(out)} bytes, header says {uncompressed_size}"
            )
        return out
    if codec == "lz4_raw":
        out = _lz4_raw_block(data, uncompressed_size)
        if len(out) != uncompressed_size:  # corrupt page: fail loudly
            raise ParquetReadError(
                f"lz4 page decoded to {len(out)} bytes, header says {uncompressed_size}"
            )
        return out
    return _pyarrow_decompress(data, codec, uncompressed_size)


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid (parquet format spec)
# ---------------------------------------------------------------------------


def _read_rle_bitpacked(data: bytes, bit_width: int, num_values: int) -> np.ndarray:
    """Host decode of the RLE/bit-packed hybrid into int32 values
    (vectorized per run via unpackbits). Used for level streams."""
    out = np.empty(num_values, dtype=np.int32)
    pos = 0
    filled = 0
    if bit_width == 0:
        out[:] = 0
        return out
    byte_width = (bit_width + 7) // 8
    while filled < num_values:
        header = 0
        shift = 0
        while True:
            if pos >= len(data):
                raise ParquetReadError("rle: truncated varint")
            b = data[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if header & 1:
            groups = header >> 1
            count = groups * 8
            nbytes = groups * bit_width
            chunk = np.frombuffer(data[pos : pos + nbytes], dtype=np.uint8)
            pos += nbytes
            bits = np.unpackbits(chunk, bitorder="little")
            vals = bits.reshape(-1, bit_width)
            weights = (1 << np.arange(bit_width, dtype=np.int64))
            decoded = (vals.astype(np.int64) * weights).sum(axis=1).astype(np.int32)
            take = min(count, num_values - filled)
            out[filled : filled + take] = decoded[:take]
            filled += take
        else:
            count = header >> 1
            raw = data[pos : pos + byte_width]
            pos += byte_width
            val = int.from_bytes(raw, "little")
            take = min(count, num_values - filled)
            out[filled : filled + take] = val
            filled += take
    return out


def _parse_rle_runs(data: bytes, bit_width: int, num_values: int):
    """Host parse of ONLY the run directory (O(#runs), not O(#values)).
    Returns (first, is_packed, payload): for an RLE run `payload` is the
    literal value; for a bit-packed run it is the absolute BIT offset of
    the run's first value inside `data`."""
    first: List[int] = []
    packed: List[bool] = []
    payload: List[int] = []
    pos = 0
    filled = 0
    if bit_width == 0:
        return (np.asarray([0], np.int64), np.asarray([False]), np.asarray([0], np.int64))
    byte_width = (bit_width + 7) // 8
    while filled < num_values:
        header = 0
        shift = 0
        while True:
            if pos >= len(data):
                raise ParquetReadError("rle: truncated varint")
            b = data[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if header & 1:
            groups = header >> 1
            count = groups * 8
            first.append(filled)
            packed.append(True)
            payload.append(pos * 8)
            pos += groups * bit_width
        else:
            count = header >> 1
            first.append(filled)
            packed.append(False)
            payload.append(int.from_bytes(data[pos : pos + byte_width], "little"))
            pos += byte_width
        filled += count
    return (
        np.asarray(first, np.int64),
        np.asarray(packed, bool),
        np.asarray(payload, np.int64),
    )


def _rle_expand_device(data, bit_width: int, num_values: int, dev: torch.device) -> torch.Tensor:
    """Device expansion of an RLE/bit-packed stream: one searchsorted maps
    value index -> run, one 5-byte window gather + shift serves packed
    runs. Each window index is clamped to the buffer, as JAX clamps the
    reference's gather (an RLE run's literal is not a bit offset)."""
    first, packed, payload = _parse_rle_runs(data, bit_width, num_values)
    buf = np.concatenate([np.frombuffer(data, np.uint8), np.zeros(8, np.uint8)])  # window slack
    b = upload(buf, dev).to(torch.int64)
    first_d = upload(first, dev)
    packed_d = upload(packed, dev)
    payload_d = upload(payload, dev)

    i = torch.arange(num_values, dtype=torch.int64, device=dev)
    run_of = torch.searchsorted(first_d, i, right=True) - 1
    k = i - first_d[run_of]
    bitpos = payload_d[run_of] + k * bit_width
    byte0 = bitpos >> 3
    last = b.shape[0] - 1
    w = b[byte0.clamp(0, last)]
    for j in range(1, 5):
        w |= b[(byte0 + j).clamp(0, last)] << (8 * j)
    val_packed = (w >> (bitpos & 7)) & ((1 << bit_width) - 1)
    return torch.where(packed_d[run_of], val_packed, payload_d[run_of]).to(torch.int32)


# ---------------------------------------------------------------------------
# byte-array (string) helpers
# ---------------------------------------------------------------------------


def _byte_array_lens(page) -> np.ndarray:
    """Walk a PLAIN BYTE_ARRAY page, [u32 len][bytes]..., into lengths: in
    C (``codecs.byte_array_lens``), the walk being sequential."""
    try:
        return codecs.byte_array_lens(page)
    except RuntimeError as e:  # keep the module's error contract
        raise ParquetReadError(str(e)) from e


def _byte_array_chars_device(page, lens: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Strip the u32 length prefixes on device: a ragged gather from the
    uploaded page. Value r starts at offs[r] + 4 (r + 1), so character j
    of the output is page byte j + 4 (row_of[j] + 1)."""
    lens_d = upload(lens, dev)
    _, row_of, _pos, total = ragged_positions(lens_d)
    if total == 0:
        return torch.zeros((0,), dtype=torch.uint8, device=dev)
    buf = upload(np.frombuffer(page, np.uint8), dev)
    j = torch.arange(total, dtype=torch.int32, device=dev)
    return buf[j + 4 * (row_of + 1)]


# ---------------------------------------------------------------------------
# decoded value segments
# ---------------------------------------------------------------------------


@dataclass
class _Values:
    """Decoded present values of one chunk: on the device."""

    kind: str  # "fixed" | "bytes"
    data: Optional[torch.Tensor] = None      # fixed: [n_present] storage dtype
    lens: Optional[torch.Tensor] = None      # bytes: [n_present] int32
    chars: Optional[torch.Tensor] = None     # bytes: [total] uint8

    @staticmethod
    def concat(parts: List["_Values"], ptype: Optional[int], dev: torch.device) -> "_Values":
        if not parts:
            if ptype == _T_BYTE_ARRAY:
                return _Values("bytes", lens=torch.zeros((0,), dtype=torch.int32, device=dev),
                               chars=torch.zeros((0,), dtype=torch.uint8, device=dev))
            return _Values("fixed", data=torch.zeros((0,), dtype=_TORCH_STORE.get(
                ptype, torch.int32), device=dev))
        if len(parts) == 1:
            return parts[0]
        if parts[0].kind == "fixed":
            return _Values("fixed", data=torch.cat([p.data for p in parts]))
        return _Values(
            "bytes",
            lens=torch.cat([p.lens for p in parts]),
            chars=torch.cat([p.chars for p in parts]),
        )


# the storage each physical type decodes into (DOUBLE as IEEE bits in int64,
# the port's FLOAT64 storage)
_NP_STORE = {
    _T_INT32: np.int32,
    _T_INT64: np.int64,
    _T_FLOAT: np.float32,
    _T_DOUBLE: np.int64,
    _T_BOOLEAN: np.uint8,
}
_TORCH_STORE = {
    _T_INT32: torch.int32,
    _T_INT64: torch.int64,
    _T_FLOAT: torch.float32,
    _T_DOUBLE: torch.int64,
    _T_BOOLEAN: torch.uint8,
}


def _plain_fixed_device(page, ptype: int, n_present: int, dev: torch.device) -> _Values:
    if ptype == _T_BOOLEAN:
        bits = np.unpackbits(
            np.frombuffer(page, np.uint8, count=(n_present + 7) // 8), bitorder="little"
        )[:n_present].astype(np.uint8)
        return _Values("fixed", data=upload(bits, dev))
    return _Values("fixed", data=upload(np.frombuffer(page, dtype=_NP_STORE[ptype],
                                                      count=n_present), dev))


class _Dictionary:
    """Dictionary page, on the device."""

    def __init__(self, page, ptype: int, n: int, dev: torch.device):
        self.ptype = ptype
        self.n = n
        if ptype == _T_BYTE_ARRAY:
            lens = _byte_array_lens(page)[:n]
            if len(lens) < n:
                raise ParquetReadError("dictionary page truncated")
            self.lens = upload(lens, dev)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            self.offs = upload(offs, dev)
            self.chars = _byte_array_chars_device(page, lens, dev)
        elif ptype in _NP_STORE:
            self.data = upload(np.frombuffer(page, dtype=_NP_STORE[ptype], count=n), dev)
        else:
            raise ParquetReadError(f"unsupported dictionary type {ptype}")

    def take(self, idx: torch.Tensor) -> _Values:
        if self.n == 0:
            if idx.shape[0]:
                raise ParquetReadError("dictionary index into an empty dictionary")
        else:
            idx = idx.clamp(0, self.n - 1)  # JAX clamps the reference's gather
        if self.ptype != _T_BYTE_ARRAY:
            return _Values("fixed", data=self.data[idx])
        lens = self.lens[idx]
        _, row_of, pos, total = ragged_positions(lens)
        if total == 0:
            return _Values("bytes", lens=lens, chars=lens.new_zeros((0,), dtype=torch.uint8))
        chars = self.chars[self.offs[idx[row_of]] + pos]
        return _Values("bytes", lens=lens, chars=chars)


# ---------------------------------------------------------------------------
# chunk decode: pages -> (defs, reps, values)
# ---------------------------------------------------------------------------


class _ChunkDecoder:
    def __init__(self, file_bytes: bytes, chunk: tc.ThriftStruct, max_def: int, max_rep: int,
                 dev: torch.device):
        md = chunk.get(_CC_META_DATA)
        self.ptype = md.get(_CMD_TYPE)
        self.codec = _CODECS.get(md.get(_CMD_CODEC, 0))
        self.num_values = md.get(_CMD_NUM_VALUES, 0)
        self.max_def = max_def
        self.max_rep = max_rep
        self.dev = dev
        start = md.get(_CMD_DATA_PAGE_OFFSET, 0)
        dict_off = md.get(_CMD_DICT_PAGE_OFFSET)
        if dict_off is not None and dict_off < start:
            start = dict_off
        self.data = file_bytes
        self.view = memoryview(file_bytes)  # page payloads are sliced without a copy
        self.pos = start
        self.dictionary: Optional[_Dictionary] = None

    def _read_page_header(self) -> tc.ThriftStruct:
        r = tc._Reader(self.data, self.pos)
        hdr = tc._read_struct_body(r)
        self.pos = r.pos
        return hdr

    def decode(self) -> Tuple[np.ndarray, Optional[np.ndarray], _Values]:
        """Returns (def_levels, rep_levels_or_None, values) concatenated
        across the chunk's pages. Levels host (assembly metadata),
        values device."""
        vals_parts: List[_Values] = []
        defs_parts: List[np.ndarray] = []
        reps_parts: List[np.ndarray] = []
        remaining = self.num_values
        while remaining > 0:
            hdr = self._read_page_header()
            ptype_page = hdr.get(_PH_TYPE)
            comp_size = hdr.get(_PH_COMP)
            uncomp_size = hdr.get(_PH_UNCOMP)
            raw = self.view[self.pos : self.pos + comp_size]
            self.pos += comp_size

            if ptype_page == _P_DICTIONARY:
                page = _decompress(raw, self.codec, uncomp_size)
                n = hdr.get(_PH_DICT).get(_DPH_NUM_VALUES)
                self.dictionary = _Dictionary(page, self.ptype, n, self.dev)
                continue

            if ptype_page == _P_DATA:
                dph = hdr.get(_PH_DATA)
                n = dph.get(_DPH_NUM_VALUES)
                enc = dph.get(_DPH_ENCODING)
                page = _decompress(raw, self.codec, uncomp_size)
                off = 0
                reps = None
                if self.max_rep > 0:
                    (ln,) = struct.unpack_from("<I", page, off)
                    off += 4
                    bw = max(self.max_rep.bit_length(), 1)
                    reps = _read_rle_bitpacked(page[off : off + ln], bw, n)
                    off += ln
                if self.max_def > 0:
                    (ln,) = struct.unpack_from("<I", page, off)
                    off += 4
                    bw = max(self.max_def.bit_length(), 1)
                    defs = _read_rle_bitpacked(page[off : off + ln], bw, n)
                    off += ln
                else:
                    defs = np.full(n, self.max_def, dtype=np.int32)
            elif ptype_page == _P_DATA_V2:
                dph = hdr.get(_PH_DATA_V2)
                n = dph.get(_DPH2_NUM_VALUES)
                enc = dph.get(_DPH2_ENCODING)
                def_bytes = dph.get(_DPH2_DEF_BYTES, 0)
                rep_bytes = dph.get(_DPH2_REP_BYTES, 0)
                levels = raw[: def_bytes + rep_bytes]  # v2 levels are never compressed
                reps = None
                if self.max_rep > 0 and rep_bytes:
                    bw = max(self.max_rep.bit_length(), 1)
                    reps = _read_rle_bitpacked(levels[:rep_bytes], bw, n)
                elif self.max_rep > 0:
                    reps = np.zeros(n, dtype=np.int32)
                if self.max_def > 0 and def_bytes:
                    bw = max(self.max_def.bit_length(), 1)
                    defs = _read_rle_bitpacked(levels[rep_bytes : rep_bytes + def_bytes], bw, n)
                else:
                    defs = np.full(n, self.max_def, dtype=np.int32)
                body = raw[def_bytes + rep_bytes :]
                compressed_flag = dph.get(_DPH2_COMPRESSED, True)
                page = (
                    _decompress(body, self.codec, uncomp_size - def_bytes - rep_bytes)
                    if compressed_flag
                    else body
                )
                off = 0
            else:
                raise ParquetReadError(f"unsupported page type {ptype_page}")

            n_present = int(np.count_nonzero(defs == self.max_def)) if self.max_def else n
            if enc == _E_RLE and self.ptype == _T_BOOLEAN:
                # v2 boolean values: u32 length + RLE/bit-packed, width 1
                (ln,) = struct.unpack_from("<I", page, off)
                bits = _read_rle_bitpacked(page[off + 4 : off + 4 + ln], 1, n_present)
                vals = _Values("fixed", data=upload(bits.astype(np.uint8), self.dev))
            elif enc == _E_PLAIN:
                body = page[off:]
                if self.ptype == _T_BYTE_ARRAY:
                    lens = _byte_array_lens(body)[:n_present]
                    if len(lens) < n_present:
                        raise ParquetReadError("byte-array page truncated")
                    vals = _Values(
                        "bytes",
                        lens=upload(lens, self.dev),
                        chars=_byte_array_chars_device(body, lens, self.dev),
                    )
                else:
                    vals = _plain_fixed_device(body, self.ptype, n_present, self.dev)
            elif enc in (_E_PLAIN_DICTIONARY, _E_RLE_DICTIONARY):
                if self.dictionary is None:
                    raise ParquetReadError("dictionary page missing")
                bw = page[off]
                idx = _rle_expand_device(page[off + 1 :], bw, n_present, self.dev)
                vals = self.dictionary.take(idx)
            else:
                raise ParquetReadError(f"unsupported encoding {enc}")

            vals_parts.append(vals)
            defs_parts.append(defs)
            if reps is not None:
                reps_parts.append(reps)
            remaining -= n

        defs = np.concatenate(defs_parts) if defs_parts else np.zeros(0, np.int32)
        reps = np.concatenate(reps_parts) if reps_parts else None
        return defs, reps, _Values.concat(vals_parts, self.ptype, self.dev)


# ---------------------------------------------------------------------------
# schema tree -> logical tree
# ---------------------------------------------------------------------------


@dataclass
class _SchemaElem:
    name: str
    repetition: int
    ptype: Optional[int]
    converted: Optional[int]
    num_children: int
    children: List["_SchemaElem"] = field(default_factory=list)
    raw: Optional[tc.ThriftStruct] = None


def _parse_schema(meta: tc.ThriftStruct) -> _SchemaElem:
    flat = meta.get(_FMD_SCHEMA).values
    pos = 0

    def walk() -> _SchemaElem:
        nonlocal pos
        e = flat[pos]
        pos += 1
        node = _SchemaElem(
            name=e.get(_SE_NAME, b"").decode(),
            repetition=e.get(_SE_REPETITION, 0),
            ptype=e.get(_SE_TYPE),
            converted=e.get(_SE_CONVERTED_TYPE),
            num_children=e.get(_SE_NUM_CHILDREN, 0) or 0,
            raw=e,
        )
        for _ in range(node.num_children):
            node.children.append(walk())
        return node

    root = walk()
    if pos != len(flat):
        raise ParquetReadError("malformed schema tree")
    return root


@dataclass
class _LLeaf:
    name: str
    elem: _SchemaElem
    max_def: int
    max_rep: int
    leaf_index: int = -1


@dataclass
class _LStruct:
    name: str
    max_def: int
    nullable: bool
    children: List[object]


@dataclass
class _LList:
    name: str
    nullable: bool      # null iff def < elem_def - 1 (when nullable)
    elem_def: int       # def level at which an element slot exists
    rep: int            # rep level of the repeated node
    element: object


def _build_logical(elem: _SchemaElem, d: int, r: int, counter: List[int]):
    """Schema element -> logical node, threading (max_def, max_rep)."""
    if elem.repetition == _R_REPEATED:
        # implicit (2-level / legacy) list: `repeated X x` == non-null
        # list of required X
        d_e, r_e = d + 1, r + 1
        inner = _SchemaElem(elem.name, _R_REQUIRED, elem.ptype, elem.converted,
                            elem.num_children, elem.children, elem.raw)
        element = _build_logical(inner, d_e, r_e, counter)
        return _LList(elem.name, nullable=False, elem_def=d_e, rep=r_e, element=element)

    nullable = elem.repetition == _R_OPTIONAL
    d2 = d + 1 if nullable else d

    if elem.num_children == 0:
        leaf = _LLeaf(elem.name, elem, max_def=d2, max_rep=r)
        leaf.leaf_index = counter[0]
        counter[0] += 1
        return leaf

    conv = elem.converted
    ch = elem.children
    if conv == _C_LIST and len(ch) == 1 and ch[0].repetition == _R_REPEATED:
        rg = ch[0]
        d_e, r_e = d2 + 1, r + 1
        if rg.num_children == 0:
            # legacy 2-level list: repeated primitive directly
            inner = _SchemaElem(rg.name, _R_REQUIRED, rg.ptype, rg.converted, 0, [], rg.raw)
            element = _build_logical(inner, d_e, r_e, counter)
        elif rg.num_children == 1:
            # standard 3-level: repeated group wraps the element
            element = _build_logical(rg.children[0], d_e, r_e, counter)
        else:
            # legacy: repeated group with several fields == list<struct>
            element = _LStruct(
                rg.name, max_def=d_e, nullable=False,
                children=[_build_logical(c, d_e, r_e, counter) for c in rg.children],
            )
        return _LList(elem.name, nullable=nullable, elem_def=d_e, rep=r_e, element=element)

    if conv in (_C_MAP, _C_MAP_KEY_VALUE) and len(ch) == 1 and ch[0].repetition == _R_REPEATED:
        kv = ch[0]
        d_e, r_e = d2 + 1, r + 1
        element = _LStruct(
            kv.name, max_def=d_e, nullable=False,
            children=[_build_logical(c, d_e, r_e, counter) for c in kv.children],
        )
        return _LList(elem.name, nullable=nullable, elem_def=d_e, rep=r_e, element=element)

    return _LStruct(
        elem.name, max_def=d2, nullable=nullable,
        children=[_build_logical(c, d2, r, counter) for c in ch],
    )


def _leaves_of(lnode) -> List[_LLeaf]:
    if isinstance(lnode, _LLeaf):
        return [lnode]
    if isinstance(lnode, _LList):
        return _leaves_of(lnode.element)
    return [lf for c in lnode.children for lf in _leaves_of(c)]


# ---------------------------------------------------------------------------
# nested assembly (Dremel inverse), vectorized numpy for the level math
# ---------------------------------------------------------------------------


def _range_counts(mask: np.ndarray, slot_idx: np.ndarray) -> np.ndarray:
    """Per slot j (range [slot_idx[j], slot_idx[j+1]) over the stream),
    the number of True entries of `mask` inside the range."""
    P = np.zeros(len(mask) + 1, np.int64)
    np.cumsum(mask, out=P[1:])
    bounds = np.append(slot_idx, len(mask))
    return (P[bounds[1:]] - P[bounds[:-1]]).astype(np.int32)


_COL_TYPES = {
    _T_INT32: dt.INT32,
    _T_INT64: dt.INT64,
    _T_FLOAT: dt.FLOAT32,
    _T_DOUBLE: dt.FLOAT64,
    _T_BOOLEAN: dt.BOOL8,
}


def _leaf_column(leaf: _LLeaf, defs: np.ndarray, idx: np.ndarray, values: _Values,
                 dev: torch.device) -> Column:
    """Scatter the chunk's present values into the leaf's slot set."""
    n = len(idx)
    present = defs[idx] == leaf.max_def
    all_valid = bool(present.all())
    validity = None if all_valid else upload(present, dev)

    ptype = leaf.elem.ptype
    if ptype == _T_BYTE_ARRAY:
        if values.kind != "bytes":
            raise ParquetReadError("byte-array column decoded as fixed-width values")
        m = values.lens.shape[0]
        if all_valid and m == n:
            lens_slot = values.lens
        elif m == 0:
            lens_slot = torch.zeros((n,), dtype=torch.int32, device=dev)
        else:
            present_d = validity if validity is not None else upload(present, dev)
            pos = (torch.cumsum(present_d, 0, dtype=torch.int32) - 1).clamp(0, m - 1)
            lens_slot = torch.where(present_d, values.lens[pos], 0)
        offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                             torch.cumsum(lens_slot, 0, dtype=torch.int32)])
        # present slots appear in value order, so chars need no reorder
        return Column(dt.STRING, validity=validity, offsets=offsets, chars=values.chars)

    if ptype not in _COL_TYPES:
        raise ParquetReadError(f"unsupported type {ptype}")
    col_dt = _COL_TYPES[ptype]
    data = values.data
    if all_valid and data.shape[0] == n:
        return Column(col_dt, data=data, validity=None)
    if data.shape[0] == 0:
        # an all-null chunk: zeros in the column's storage (the reference
        # holds int32 zeros here whatever the type)
        return Column(col_dt, data=torch.zeros((n,), dtype=col_dt.torch_dtype, device=dev),
                      validity=validity)
    present_d = validity if validity is not None else upload(present, dev)
    pos = (torch.cumsum(present_d, 0, dtype=torch.int32) - 1).clamp(0, data.shape[0] - 1)
    full = torch.where(present_d, data[pos], torch.zeros((), dtype=data.dtype, device=dev))
    return Column(col_dt, data=full, validity=validity)


def _assemble(lnode, streams: Dict[int, Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, _Values]],
              dev: torch.device) -> Column:
    """streams: leaf_index -> (defs, reps, slot_idx, values)."""
    if isinstance(lnode, _LLeaf):
        defs, _reps, idx, values = streams[lnode.leaf_index]
        return _leaf_column(lnode, defs, idx, values, dev)

    if isinstance(lnode, _LStruct):
        # struct validity from any descendant stream (consistent at
        # shared ancestor levels)
        first_leaf = _leaves_of(lnode)[0]
        defs, _r, idx, _v = streams[first_leaf.leaf_index]
        validity = None
        if lnode.nullable:
            present = defs[idx] >= lnode.max_def
            if not present.all():
                validity = upload(present, dev)
        children = [_assemble(c, {
            lf.leaf_index: streams[lf.leaf_index] for lf in _leaves_of(c)
        }, dev) for c in lnode.children]
        names = [c.name for c in lnode.children]
        return Column.struct_from_parts(children, names, validity=validity)

    assert isinstance(lnode, _LList)
    first_leaf = _leaves_of(lnode)[0]
    defs0, reps0, idx0, _v0 = streams[first_leaf.leaf_index]
    if reps0 is None:
        raise ParquetReadError("list column without repetition levels")
    elem_mask0 = (reps0 <= lnode.rep) & (defs0 >= lnode.elem_def)
    counts = _range_counts(elem_mask0, idx0)
    offsets = np.zeros(len(idx0) + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    validity = None
    if lnode.nullable:
        present = defs0[idx0] >= lnode.elem_def - 1
        if not present.all():
            validity = upload(present, dev)

    # element slot positions per descendant stream
    child_streams = {}
    for lf in _leaves_of(lnode.element):
        defs, reps, _idx, vals = streams[lf.leaf_index]
        em = (reps <= lnode.rep) & (defs >= lnode.elem_def)
        child_streams[lf.leaf_index] = (defs, reps, np.flatnonzero(em), vals)
    child = _assemble(lnode.element, child_streams, dev)
    return Column.list_from_parts(upload(offsets, dev), child, validity=validity)


# ---------------------------------------------------------------------------
# read_table
# ---------------------------------------------------------------------------


def read_table(file_bytes: bytes, columns: Optional[List[str]] = None, device=None) -> Table:
    """Read a parquet file into a Table on ``device`` (None means the
    card). ``columns`` selects TOP-LEVEL fields by name; nested fields
    come whole (lists, structs, maps as LIST<STRUCT<key, value>>, the
    cudf representation)."""
    dev = resolve_device(device)
    if file_bytes[:4] != b"PAR1" or file_bytes[-4:] != b"PAR1":
        raise ParquetReadError("not a parquet file")
    (flen,) = struct.unpack("<I", file_bytes[-8:-4])
    meta = tc.read_struct(file_bytes[-8 - flen : -8])

    root = _parse_schema(meta)
    counter = [0]
    fields = [(c.name, _build_logical(c, 0, 0, counter)) for c in root.children]

    if columns is not None:
        keep = set(columns)
        sel_fields = [(nm, f) for nm, f in fields if nm in keep]
        missing = keep - {nm for nm, _ in sel_fields}
        if missing:
            raise ParquetReadError(f"columns not in schema: {sorted(missing)}")
    else:
        sel_fields = fields

    needed_leaves: Dict[int, _LLeaf] = {}
    for _nm, f in sel_fields:
        for lf in _leaves_of(f):
            needed_leaves[lf.leaf_index] = lf

    rgs_field = meta.get(_FMD_ROW_GROUPS)
    rgs = rgs_field.values if rgs_field is not None else []
    # decode each needed leaf chunk across row groups, then concatenate
    streams: Dict[int, Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, _Values]] = {}
    for li, leaf in needed_leaves.items():
        d_parts: List[np.ndarray] = []
        r_parts: List[np.ndarray] = []
        v_parts: List[_Values] = []
        has_reps = leaf.max_rep > 0
        for rg in rgs:
            chunks = rg.get(_RG_COLUMNS).values
            if li >= len(chunks):
                raise ParquetReadError("row group missing column chunk")
            dec = _ChunkDecoder(file_bytes, chunks[li], leaf.max_def, leaf.max_rep, dev)
            defs, reps, vals = dec.decode()
            d_parts.append(defs)
            if has_reps:
                r_parts.append(
                    reps if reps is not None else np.zeros(len(defs), np.int32)
                )
            v_parts.append(vals)
        defs = np.concatenate(d_parts) if d_parts else np.zeros(0, np.int32)
        reps = np.concatenate(r_parts) if r_parts else None
        if reps is None and has_reps:
            # zero-row-group files: nested leaves still assemble (empty)
            reps = np.zeros(len(defs), np.int32)
        vals = _Values.concat(v_parts, leaf.elem.ptype, dev)
        # top-level slots: record starts (rep == 0); flat: every entry
        if reps is not None:
            idx = np.flatnonzero(reps == 0)
        else:
            idx = np.arange(len(defs), dtype=np.int64)
        streams[li] = (defs, reps, idx, vals)

    out_cols: List[Column] = []
    names: List[str] = []
    for nm, f in sel_fields:
        sub = {lf.leaf_index: streams[lf.leaf_index] for lf in _leaves_of(f)}
        out_cols.append(_assemble(f, sub, dev))
        names.append(nm)
    return Table(out_cols, names=names)
