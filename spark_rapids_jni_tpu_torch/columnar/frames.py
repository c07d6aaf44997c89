"""Versioned columnar frame codec: the one layout the JAX package's
sidecar wire, memgov disk spills and TCP shuffle exchanges share (port of
its ``columnar/frames.py``). A frame the port encodes is byte for byte
the reference's frame of the same table, checked or not, and each
package decodes the other's: fixed-width data goes out in the
reference's storage dtypes (``Column.to_numpy``: FLOAT64 as uint64 bits,
DECIMAL128 as uint32 limbs). ``decode_table`` builds its columns on
``device`` (None means the card).

Frame layout (little-endian)::

    [8]  magic   b"SRJTFRM1"
    [2]  u16 version (=1)
    [2]  u16 flags   (bit 0: per-part CRC words + header CRC valid)
    [4]  u32 npart
    per part (descriptor, variable length):
        [4]  i32 type_id     (columnar TypeId, or -1 for a raw ndarray)
        [4]  i32 scale       (decimal scale; 0 otherwise)
        [1]  u8  role        (0 data, 1 validity, 2 offsets, 3 chars)
        [4]  u32 col         (owning logical column index)
        [8]  u64 null_count
        [1]  u8  dlen, then dlen bytes of numpy dtype.str (ascii)
        [1]  u8  ndim, then ndim x u64 shape
        [8]  u64 nbytes      (payload length)
        [4]  u32 crc         (utils/integrity checksum; 0 when unchecked)
    [4]  u32 header_crc      (over magic..descriptors; 0 when unchecked)
    part payloads, concatenated in descriptor order

While ``utils/integrity``'s gate is off, frames are emitted with flags
bit 0 clear (no hashing anywhere) and decode skips verification; any
mismatch raises ``DataCorruption`` through ``integrity.raise_corruption``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import integrity

__all__ = [
    "MAGIC",
    "VERSION",
    "FramePart",
    "is_frame",
    "is_checked",
    "encode_parts",
    "decode_parts",
    "encode_table",
    "decode_table",
    "encode_leaves",
    "decode_leaves",
]

MAGIC = b"SRJTFRM1"
VERSION = 1
_FLAG_CRC = 0x0001

ROLE_DATA = 0
ROLE_VALIDITY = 1
ROLE_OFFSETS = 2
ROLE_CHARS = 3

_PREAMBLE = struct.Struct("<8sHHI")  # magic, version, flags, npart
_RAW_TYPE_ID = -1


class FramePart:
    """One encoded buffer: a contiguous ndarray plus the schema bits a
    decoder needs to hang it back onto a logical column."""

    __slots__ = ("array", "type_id", "scale", "role", "col", "null_count")

    def __init__(
        self,
        array: np.ndarray,
        type_id: int = _RAW_TYPE_ID,
        scale: int = 0,
        role: int = ROLE_DATA,
        col: int = 0,
        null_count: int = 0,
    ):
        self.array = np.ascontiguousarray(array)
        self.type_id = int(type_id)
        self.scale = int(scale)
        self.role = int(role)
        self.col = int(col)
        self.null_count = int(null_count)


def is_frame(buf, offset: int = 0) -> bool:
    """Cheap sniff: do ``buf[offset:]`` start a columnar frame?"""
    return bytes(buf[offset : offset + len(MAGIC)]) == MAGIC


def is_checked(buf, offset: int = 0) -> bool:
    """Was the frame at ``buf[offset:]`` emitted WITH CRC words (flags
    bit 0)? A frame written while the integrity gate was off carries no
    hashes: decoding it verifies nothing."""
    if not is_frame(buf, offset):
        return False
    try:
        _magic, _version, flags, _npart = _PREAMBLE.unpack_from(
            memoryview(buf), offset
        )
    except struct.error:
        return False
    return bool(flags & _FLAG_CRC)


# ---------------------------------------------------------------------------
# part-level codec (the one encoder/decoder every surface shares)
# ---------------------------------------------------------------------------


def encode_parts(parts: Sequence[FramePart]) -> bytes:
    """Encode ``parts`` into one frame. Per-part CRCs (and the header
    CRC) are emitted only while integrity checks are armed — disarmed
    frames carry flags bit 0 clear and zero CRC words, no hashing."""
    checked = integrity.is_enabled()
    flags = _FLAG_CRC if checked else 0
    head = [_PREAMBLE.pack(MAGIC, VERSION, flags, len(parts))]
    payloads: List[bytes] = []
    for p in parts:
        blob = p.array.tobytes()
        dstr = p.array.dtype.str.encode("ascii")
        shape = p.array.shape
        crc = integrity.checksum(blob) if checked else 0
        head.append(
            struct.pack("<iiBIQ", p.type_id, p.scale, p.role, p.col, p.null_count)
            + struct.pack("<B", len(dstr)) + dstr
            + struct.pack("<B", len(shape))
            + struct.pack(f"<{len(shape)}Q", *shape)
            + struct.pack("<QI", len(blob), crc)
        )
        payloads.append(blob)
    header = b"".join(head)
    hcrc = integrity.checksum(header) if checked else 0
    return header + struct.pack("<I", hcrc) + b"".join(payloads)


def decode_parts(
    buf, where: str = "columnar.frame", offset: int = 0
) -> Tuple[List[FramePart], int]:
    """Decode one frame from ``buf[offset:]``; returns (parts, end
    offset). A non-frame prefix raises ValueError (callers sniff with
    ``is_frame`` first); a frame whose bytes rotted — bad header CRC,
    truncated payload, part CRC mismatch — raises retryable
    ``DataCorruption`` counted under ``where``."""
    view = memoryview(buf)
    if not is_frame(view, offset):
        raise ValueError(f"{where}: not a columnar frame (bad magic)")
    try:
        magic, version, flags, npart = _PREAMBLE.unpack_from(view, offset)
    except struct.error:
        raise integrity.raise_corruption(where, "truncated frame preamble")
    if version != VERSION:
        raise ValueError(f"{where}: unsupported frame version {version}")
    checked = bool(flags & _FLAG_CRC) and integrity.is_enabled()
    pos = offset + _PREAMBLE.size
    descs = []
    try:
        for _ in range(npart):
            type_id, scale, role, col, null_count = struct.unpack_from(
                "<iiBIQ", view, pos
            )
            pos += 21
            (dlen,) = struct.unpack_from("<B", view, pos)
            pos += 1
            dstr = bytes(view[pos : pos + dlen]).decode("ascii")
            pos += dlen
            (ndim,) = struct.unpack_from("<B", view, pos)
            pos += 1
            shape = struct.unpack_from(f"<{ndim}Q", view, pos)
            pos += 8 * ndim
            nbytes, crc = struct.unpack_from("<QI", view, pos)
            pos += 12
            descs.append((type_id, scale, role, col, null_count, dstr, shape, nbytes, crc))
        (hcrc,) = struct.unpack_from("<I", view, pos)
    except (struct.error, UnicodeDecodeError):
        raise integrity.raise_corruption(where, "truncated/garbled frame header")
    if checked:
        integrity.verify(bytes(view[offset:pos]), hcrc, f"{where}.header")
    pos += 4
    parts: List[FramePart] = []
    for type_id, scale, role, col, null_count, dstr, shape, nbytes, crc in descs:
        blob = bytes(view[pos : pos + nbytes])
        if len(blob) != nbytes:
            raise integrity.raise_corruption(
                where, f"truncated part payload ({len(blob)} != {nbytes})"
            )
        pos += nbytes
        if checked:
            integrity.verify(blob, crc, where)
        try:
            arr = np.frombuffer(blob, dtype=np.dtype(dstr)).reshape(shape)
        except (TypeError, ValueError) as e:
            raise integrity.raise_corruption(where, f"undecodable part ({e})")
        parts.append(FramePart(arr, type_id, scale, role, col, null_count))
    return parts, pos


# ---------------------------------------------------------------------------
# Table layer (wire payloads, exchange partitions)
# ---------------------------------------------------------------------------


def encode_table(table) -> bytes:
    """Encode a columnar Table as one frame: fixed-width columns
    (DECIMAL128 [N, 4] limbs included), STRING (offsets + chars), LIST
    with its child's bytes, each with an optional validity part. STRUCT
    columns do not cross (ValueError), as in the reference."""
    from .dtype import TypeId

    parts: List[FramePart] = []
    for i, col in enumerate(table.columns):
        d = col.dtype
        tid = int(d.id.value)
        null_count = 0
        v = None
        if col.validity is not None:
            v = col.validity.cpu().numpy().astype(np.uint8)
            null_count = int(v.size - int(np.count_nonzero(v)))
        if d.id in (TypeId.STRING, TypeId.LIST):
            parts.append(FramePart(
                col.offsets.cpu().numpy().astype(np.int32, copy=False), tid, d.scale,
                ROLE_OFFSETS, i, null_count,
            ))
            chars = (
                col.chars.cpu().numpy()
                if d.id == TypeId.STRING
                else col.child.to_numpy().view(np.uint8)
            )
            parts.append(FramePart(chars, tid, d.scale, ROLE_CHARS, i, null_count))
        elif d.id == TypeId.STRUCT:
            raise ValueError("frames: STRUCT columns do not cross the wire")
        else:
            parts.append(FramePart(col.to_numpy(), tid, d.scale, ROLE_DATA, i, null_count))
        if v is not None:
            parts.append(FramePart(v, tid, d.scale, ROLE_VALIDITY, i, null_count))
    return encode_parts(parts)


def decode_table(buf, where: str = "columnar.frame", offset: int = 0, device=None):
    """Decode a frame back into a Table (default column names) with its
    columns on ``device`` (None means the card)."""
    import torch

    from .column import Column, _host_to_tensor, resolve_device, upload
    from .dtype import DType, TypeId
    from .table import Table

    dev = resolve_device(device)
    parts, _end = decode_parts(buf, where=where, offset=offset)
    by_col: dict = {}
    order: List[int] = []
    for p in parts:
        if p.col not in by_col:
            by_col[p.col] = {}
            order.append(p.col)
        by_col[p.col][p.role] = p
    cols = []
    for ci in order:
        roles = by_col[ci]
        anchor = roles.get(ROLE_DATA) or roles.get(ROLE_OFFSETS)
        if anchor is None:
            raise integrity.raise_corruption(
                where, f"column {ci} has neither data nor offsets part"
            )
        tid = TypeId(anchor.type_id)
        d = DType(tid, anchor.scale if tid.name.startswith("DECIMAL") else 0)
        vp = roles.get(ROLE_VALIDITY)
        validity = upload(vp.array.astype(bool), dev) if vp is not None else None
        if tid in (TypeId.STRING, TypeId.LIST):
            offs = _host_to_tensor(roles[ROLE_OFFSETS].array, torch.int32, dev)
            chars = roles.get(ROLE_CHARS)
            cbytes = chars.array if chars is not None else np.zeros(0, np.uint8)
            if tid == TypeId.LIST:
                cols.append(Column(
                    d, validity=validity, offsets=offs,
                    child=Column(DType(TypeId.INT8), data=_host_to_tensor(cbytes, torch.int8, dev)),
                ))
            else:
                cols.append(Column(
                    d, validity=validity, offsets=offs,
                    chars=_host_to_tensor(cbytes, torch.uint8, dev),
                ))
        else:
            cols.append(Column(d, data=_host_to_tensor(anchor.array, d.torch_dtype, dev),
                               validity=validity))
    return Table(cols)


# ---------------------------------------------------------------------------
# raw-leaves layer (spills: any list of ndarrays)
# ---------------------------------------------------------------------------


def encode_leaves(leaves: Sequence[np.ndarray]) -> bytes:
    """Encode a flat list of ndarrays as one frame of raw parts: dtype and
    shape round-trip exactly, so a spill -> load cycle is bit-identical."""
    return encode_parts([
        FramePart(np.asarray(a), _RAW_TYPE_ID, 0, ROLE_DATA, i)
        for i, a in enumerate(leaves)
    ])


def decode_leaves(buf, where: str = "memgov.spill") -> List[np.ndarray]:
    parts, _end = decode_parts(buf, where=where)
    out: List[Optional[np.ndarray]] = [None] * len(parts)
    for p in parts:
        if not (0 <= p.col < len(parts)) or out[p.col] is not None:
            raise integrity.raise_corruption(where, "garbled leaf indexing")
        out[p.col] = p.array
    return out  # type: ignore[return-value]
