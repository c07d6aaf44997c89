"""Thrift TCompactProtocol codec over a generic value tree (the port's
copy of the JAX package's ``io/thrift_compact.py``, host code).

The reference links apache thrift and parses into generated
``parquet::format`` classes (NativeParquetJni.cpp:527-556). Here the
protocol is implemented from scratch into a *generic* field-id-keyed
tree, which round-trips unknown fields byte-faithfully — the property
the footer service needs (filter a few known fields, re-serialize
everything else untouched).

Size-bomb guards mirror the reference: strings capped at 100MB,
containers at 1M elements (:544-548).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

__all__ = ["ThriftStruct", "ThriftList", "ThriftMap", "read_struct", "write_struct"]

MAX_STRING = 100 * 1000 * 1000
MAX_CONTAINER = 1000 * 1000

# compact wire types
CT_STOP = 0x0
CT_TRUE = 0x1
CT_FALSE = 0x2
CT_BYTE = 0x3
CT_I16 = 0x4
CT_I32 = 0x5
CT_I64 = 0x6
CT_DOUBLE = 0x7
CT_BINARY = 0x8
CT_LIST = 0x9
CT_SET = 0xA
CT_MAP = 0xB
CT_STRUCT = 0xC


class ThriftStruct:
    """Ordered field-id -> (wire_type, value) mapping."""

    __slots__ = ("fields",)

    def __init__(self, fields: Dict[int, Tuple[int, Any]] = None):
        self.fields = dict(fields) if fields else {}

    def get(self, fid: int, default=None):
        f = self.fields.get(fid)
        return f[1] if f is not None else default

    def has(self, fid: int) -> bool:
        return fid in self.fields

    def set(self, fid: int, wire_type: int, value) -> None:
        self.fields[fid] = (wire_type, value)

    def delete(self, fid: int) -> None:
        self.fields.pop(fid, None)

    def __repr__(self):
        return f"ThriftStruct({self.fields!r})"


class ThriftList:
    __slots__ = ("elem_type", "values", "is_set")

    def __init__(self, elem_type: int, values: List[Any], is_set: bool = False):
        self.elem_type = elem_type
        self.values = values
        self.is_set = is_set

    def __repr__(self):
        return f"ThriftList(t={self.elem_type}, n={len(self.values)})"


class ThriftMap:
    __slots__ = ("key_type", "val_type", "items")

    def __init__(self, key_type: int, val_type: int, items: List[Tuple[Any, Any]]):
        self.key_type = key_type
        self.val_type = val_type
        self.items = items


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int = 0, end: int = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def byte(self) -> int:
        if self.pos >= self.end:
            raise ValueError("thrift: truncated input")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                return result
            shift += 7
            if shift > 70:
                raise ValueError("thrift: varint too long")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_bytes(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise ValueError("thrift: truncated binary")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


def _read_value(r: _Reader, wire_type: int):
    if wire_type == CT_TRUE:
        return True
    if wire_type == CT_FALSE:
        return False
    if wire_type == CT_BYTE:
        b = r.byte()
        return b - 256 if b >= 128 else b
    if wire_type in (CT_I16, CT_I32, CT_I64):
        return r.zigzag()
    if wire_type == CT_DOUBLE:
        return struct.unpack("<d", r.read_bytes(8))[0]
    if wire_type == CT_BINARY:
        n = r.varint()
        if n > MAX_STRING:
            raise ValueError("thrift: string size limit exceeded")
        return r.read_bytes(n)
    if wire_type in (CT_LIST, CT_SET):
        head = r.byte()
        size = head >> 4
        elem_type = head & 0x0F
        if size == 15:
            size = r.varint()
        if size > MAX_CONTAINER:
            raise ValueError("thrift: container size limit exceeded")
        vals = [_read_container_elem(r, elem_type) for _ in range(size)]
        return ThriftList(elem_type, vals, is_set=(wire_type == CT_SET))
    if wire_type == CT_MAP:
        size = r.varint()
        if size > MAX_CONTAINER:
            raise ValueError("thrift: container size limit exceeded")
        if size == 0:
            return ThriftMap(0, 0, [])
        kv = r.byte()
        kt, vt = kv >> 4, kv & 0x0F
        items = [(_read_container_elem(r, kt), _read_container_elem(r, vt)) for _ in range(size)]
        return ThriftMap(kt, vt, items)
    if wire_type == CT_STRUCT:
        return _read_struct_body(r)
    raise ValueError(f"thrift: unknown wire type {wire_type}")


def _read_container_elem(r: _Reader, elem_type: int):
    if elem_type in (CT_TRUE, CT_FALSE):  # container bools are 1/2 bytes
        return r.byte() == CT_TRUE
    return _read_value(r, elem_type)


def _read_struct_body(r: _Reader) -> ThriftStruct:
    s = ThriftStruct()
    last_fid = 0
    while True:
        head = r.byte()
        if head == CT_STOP:
            return s
        delta = head >> 4
        wire_type = head & 0x0F
        fid = last_fid + delta if delta else r.zigzag()
        last_fid = fid
        s.set(fid, wire_type, _read_value(r, wire_type))


def read_struct(buf: bytes, pos: int = 0, end: int = None) -> ThriftStruct:
    return _read_struct_body(_Reader(buf, pos, end))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class _Writer:
    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()

    def byte(self, b: int) -> None:
        self.out.append(b & 0xFF)

    def varint(self, v: int) -> None:
        while True:
            if v < 0x80:
                self.out.append(v)
                return
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7


def _zigzag_encode(v: int) -> int:
    return v << 1 if v >= 0 else ((-v) << 1) - 1


def _write_value(w: _Writer, wire_type: int, v) -> None:
    if wire_type in (CT_TRUE, CT_FALSE):
        return  # encoded in the field header
    if wire_type == CT_BYTE:
        w.byte(v & 0xFF)
        return
    if wire_type in (CT_I16, CT_I32, CT_I64):
        w.varint(_zigzag_encode(int(v)))
        return
    if wire_type == CT_DOUBLE:
        w.out += struct.pack("<d", v)
        return
    if wire_type == CT_BINARY:
        b = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
        w.varint(len(b))
        w.out += b
        return
    if wire_type in (CT_LIST, CT_SET):
        n = len(v.values)
        if n < 15:
            w.byte((n << 4) | v.elem_type)
        else:
            w.byte(0xF0 | v.elem_type)
            w.varint(n)
        for e in v.values:
            _write_container_elem(w, v.elem_type, e)
        return
    if wire_type == CT_MAP:
        n = len(v.items)
        w.varint(n)
        if n:
            w.byte((v.key_type << 4) | v.val_type)
            for k, val in v.items:
                _write_container_elem(w, v.key_type, k)
                _write_container_elem(w, v.val_type, val)
        return
    if wire_type == CT_STRUCT:
        _write_struct_body(w, v)
        return
    raise ValueError(f"thrift: cannot write wire type {wire_type}")


def _write_container_elem(w: _Writer, elem_type: int, v) -> None:
    if elem_type in (CT_TRUE, CT_FALSE):
        w.byte(CT_TRUE if v else CT_FALSE)
        return
    _write_value(w, elem_type, v)


def _write_struct_body(w: _Writer, s: ThriftStruct) -> None:
    last_fid = 0
    for fid in sorted(s.fields):
        wire_type, v = s.fields[fid]
        if wire_type in (CT_TRUE, CT_FALSE):
            wire_type = CT_TRUE if v else CT_FALSE
        delta = fid - last_fid
        if 0 < delta <= 15:
            w.byte((delta << 4) | wire_type)
        else:
            w.byte(wire_type)
            w.varint(_zigzag_encode(fid))
        _write_value(w, wire_type, v)
        last_fid = fid
    w.byte(CT_STOP)


def write_struct(s: ThriftStruct) -> bytes:
    w = _Writer()
    _write_struct_body(w, s)
    return bytes(w.out)
