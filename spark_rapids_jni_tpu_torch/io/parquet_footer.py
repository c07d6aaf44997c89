"""Parquet footer service: parse, prune, row-group filter, re-serialize
(the port's copy of the JAX package's ``io/parquet_footer.py``, host
code; ``serialize_thrift_file`` gives the reference's bytes).

Pure-CPU metadata path, behavioral parity with reference
NativeParquetJni.cpp and ParquetFooter.java:

- schema DSL (StructElement/ListElement/MapElement/ValueElement with
  builder + depth-first flattening, ParquetFooter.java:35-185),
- ``column_pruner`` rebuilt from the flattened (names, num_children,
  tags) triple exactly as the JNI does (:394-439), producing
  {schema_map, schema_num_children, chunk_map} gather maps (:84-94),
- per-Tag filter_schema variants — STRUCT (:185-219), VALUE (:224-240),
  LIST incl. legacy 2-level and ``_tuple`` formats (:245-305),
  MAP/MAP_KEY_VALUE (:310-361),
- row-group selection by split midpoint with the PARQUET-2078 bad-offset
  workaround (:445-525),
- unicode-aware case folding (:45-77 uses towlower; python str.lower),
- re-serialization framed as PAR1 + thrift + little-endian length + PAR1
  (:672-706) so downstream readers accept it as a data-less file.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from . import thrift_compact as tc
from .thrift_compact import ThriftList, ThriftStruct

__all__ = [
    "Tag",
    "ValueElement",
    "ListElement",
    "MapElement",
    "StructElement",
    "ParquetFooter",
    "read_and_filter",
]


# FileMetaData field ids (parquet.thrift)
_FMD_VERSION = 1
_FMD_SCHEMA = 2
_FMD_NUM_ROWS = 3
_FMD_ROW_GROUPS = 4
_FMD_COLUMN_ORDERS = 7
# SchemaElement
_SE_TYPE = 1
_SE_REPETITION = 3
_SE_NAME = 4
_SE_NUM_CHILDREN = 5
_SE_CONVERTED_TYPE = 6
# RowGroup
_RG_COLUMNS = 1
_RG_NUM_ROWS = 3
_RG_FILE_OFFSET = 5
_RG_TOTAL_COMPRESSED_SIZE = 6
# ColumnChunk
_CC_META_DATA = 3
# ColumnMetaData
_CMD_TOTAL_COMPRESSED_SIZE = 7
_CMD_DATA_PAGE_OFFSET = 9
_CMD_DICT_PAGE_OFFSET = 11

_REPEATED = 2
_CONVERTED_LIST = 3
_CONVERTED_MAP = 1
_CONVERTED_MAP_KEY_VALUE = 2


class Tag:
    VALUE = 0
    STRUCT = 1
    LIST = 2
    MAP = 3


# ---------------------------------------------------------------------------
# schema DSL (ParquetFooter.java:35-93)
# ---------------------------------------------------------------------------


class _SchemaElement:
    def flatten(self, names: List[str], num_children: List[int], tags: List[int]) -> None:
        raise NotImplementedError


class ValueElement(_SchemaElement):
    def flatten(self, names, num_children, tags):
        pass  # leaf: contributes nothing below itself

    children: Sequence[Tuple[str, "_SchemaElement"]] = ()
    tag = Tag.VALUE


class ListElement(_SchemaElement):
    tag = Tag.LIST

    def __init__(self, item: _SchemaElement):
        self.item = item

    @property
    def children(self):
        return (("element", self.item),)


class MapElement(_SchemaElement):
    tag = Tag.MAP

    def __init__(self, key: _SchemaElement, value: _SchemaElement):
        self.key = key
        self.value = value

    @property
    def children(self):
        return (("key", self.key), ("value", self.value))


class StructElement(_SchemaElement):
    """Builder mirror of ParquetFooter.StructElement (:58-93)."""

    tag = Tag.STRUCT

    def __init__(self, fields: Optional[Sequence[Tuple[str, _SchemaElement]]] = None):
        self._fields: List[Tuple[str, _SchemaElement]] = list(fields) if fields else []

    def add_child(self, name: str, child: _SchemaElement) -> "StructElement":
        self._fields.append((name, child))
        return self

    @property
    def children(self):
        return tuple(self._fields)


def flatten_schema(root: StructElement) -> Tuple[List[str], List[int], List[int], int]:
    """Depth-first flatten (ParquetFooter.java:136-185): the root is not
    included; returns (names, num_children, tags, parent_num_children)."""
    names: List[str] = []
    num_children: List[int] = []
    tags: List[int] = []

    def walk(elem: _SchemaElement):
        for name, child in elem.children:
            names.append(name)
            num_children.append(len(child.children))
            tags.append(child.tag)
            walk(child)

    walk(root)
    return names, num_children, tags, len(root.children)


# ---------------------------------------------------------------------------
# column_pruner (NativeParquetJni.cpp:119-439)
# ---------------------------------------------------------------------------


class _Pruner:
    def __init__(self, tag: int):
        self.tag = tag
        self.children = {}  # name -> _Pruner


def build_pruner(
    names: Sequence[str], num_children: Sequence[int], tags: Sequence[int],
    parent_num_children: int,
) -> _Pruner:
    """Rebuild the pruning tree from the flattened triple (add_depth_first
    :394-439)."""
    root = _Pruner(Tag.STRUCT)
    pos = 0

    def add(parent: _Pruner, count: int):
        nonlocal pos
        for _ in range(count):
            if pos >= len(names):
                raise ValueError("flattened schema truncated")
            node = _Pruner(tags[pos])
            parent.children[names[pos]] = node
            cnt = num_children[pos]
            pos += 1
            add(node, cnt)

    add(root, parent_num_children)
    return root


class _SchemaWalk:
    """Shared walker state: (schema index, chunk index) cursors + output maps."""

    def __init__(self, schema: List[ThriftStruct], ignore_case: bool):
        self.schema = schema
        self.ignore_case = ignore_case
        self.i = 0  # current_input_schema_index
        self.chunk = 0  # next_input_chunk_index
        self.schema_map: List[int] = []
        self.schema_num_children: List[int] = []
        self.chunk_map: List[int] = []

    def elem(self) -> ThriftStruct:
        return self.schema[self.i]

    def name(self, elem: ThriftStruct) -> str:
        n = elem.get(_SE_NAME, b"").decode("utf-8", "replace")
        return n.lower() if self.ignore_case else n

    @staticmethod
    def is_leaf(elem: ThriftStruct) -> bool:
        return elem.has(_SE_TYPE)

    @staticmethod
    def n_children(elem: ThriftStruct) -> int:
        return elem.get(_SE_NUM_CHILDREN, 0) or 0

    def skip(self) -> None:
        """Skip the current element and its subtree, advancing chunk counts
        for every leaf passed (:163-181)."""
        to_skip = 1
        while to_skip > 0 and self.i < len(self.schema):
            e = self.schema[self.i]
            if self.is_leaf(e):
                self.chunk += 1
            to_skip += self.n_children(e)
            to_skip -= 1
            self.i += 1


def _filter_schema(p: _Pruner, w: _SchemaWalk) -> None:
    if p.tag == Tag.STRUCT:
        _filter_struct(p, w)
    elif p.tag == Tag.VALUE:
        _filter_value(w)
    elif p.tag == Tag.LIST:
        _filter_list(p, w)
    elif p.tag == Tag.MAP:
        _filter_map(p, w)
    else:
        raise ValueError(f"unexpected tag {p.tag}")


def _filter_struct(p: _Pruner, w: _SchemaWalk) -> None:
    e = w.elem()
    if w.is_leaf(e):
        raise ValueError("struct request hit a leaf file element")
    n = w.n_children(e)
    w.schema_map.append(w.i)
    my_count_idx = len(w.schema_num_children)
    w.schema_num_children.append(0)
    w.i += 1
    for _ in range(n):
        if w.i >= len(w.schema):
            break
        child = w.elem()
        found = p.children.get(w.name(child))
        if found is not None:
            w.schema_num_children[my_count_idx] += 1
            _filter_schema(found, w)
        else:
            w.skip()


def _filter_value(w: _SchemaWalk) -> None:
    e = w.elem()
    if not w.is_leaf(e):
        raise ValueError("leaf request hit a group element")
    if w.n_children(e) != 0:
        raise ValueError("leaf request but file element has children")
    w.schema_map.append(w.i)
    w.schema_num_children.append(0)
    w.i += 1
    w.chunk_map.append(w.chunk)
    w.chunk += 1


def _filter_list(p: _Pruner, w: _SchemaWalk) -> None:
    found = p.children["element"]
    e = w.elem()
    list_name = e.get(_SE_NAME, b"").decode("utf-8", "replace")
    if w.is_leaf(e):
        if e.get(_SE_REPETITION) != _REPEATED:
            raise ValueError("list element child is not marked repeated")
        return _filter_value(w)
    if e.get(_SE_CONVERTED_TYPE) != _CONVERTED_LIST:
        raise ValueError("requested LIST does not match the file element type")
    if w.n_children(e) != 1:
        raise ValueError("outer list group has an unsupported layout")
    w.schema_map.append(w.i)
    w.schema_num_children.append(1)
    w.i += 1

    rep = w.elem()
    if rep.get(_SE_REPETITION) != _REPEATED:
        raise ValueError("list child layout unsupported: child is not repeated")
    rep_is_group = not w.is_leaf(rep)
    rep_n = w.n_children(rep)
    rep_name = rep.get(_SE_NAME, b"").decode("utf-8", "replace")
    if rep_is_group and rep_n == 1 and rep_name != "array" and rep_name != list_name + "_tuple":
        # standard 3-level list
        w.schema_map.append(w.i)
        w.schema_num_children.append(1)
        w.i += 1
        _filter_schema(found, w)
    else:
        # legacy 2-level list
        _filter_schema(found, w)


def _filter_map(p: _Pruner, w: _SchemaWalk) -> None:
    key_found = p.children["key"]
    value_found = p.children["value"]
    e = w.elem()
    if w.is_leaf(e):
        raise ValueError("requested MAP hit a single-value element")
    if e.get(_SE_CONVERTED_TYPE) not in (_CONVERTED_MAP, _CONVERTED_MAP_KEY_VALUE):
        raise ValueError("requested MAP does not match the file element type")
    if w.n_children(e) != 1:
        raise ValueError("outer map group has an unsupported layout")
    w.schema_map.append(w.i)
    w.schema_num_children.append(1)
    w.i += 1

    rep = w.elem()
    if rep.get(_SE_REPETITION) != _REPEATED:
        raise ValueError("map key_value child is not marked repeated")
    rep_n = w.n_children(rep)
    if rep_n not in (1, 2):
        raise ValueError("map key_value group must have 1 or 2 children")
    w.schema_map.append(w.i)
    w.schema_num_children.append(rep_n)
    w.i += 1

    _filter_schema(key_found, w)
    if rep_n == 2:
        _filter_schema(value_found, w)


# ---------------------------------------------------------------------------
# row-group selection (filter_groups :473-525)
# ---------------------------------------------------------------------------


def _chunk_offset(cc: ThriftStruct) -> int:
    md = cc.get(_CC_META_DATA)
    off = md.get(_CMD_DATA_PAGE_OFFSET, 0)
    dict_off = md.get(_CMD_DICT_PAGE_OFFSET)
    if dict_off is not None and off > dict_off:
        off = dict_off
    return off


def _invalid_file_offset(start: int, pre_start: int, pre_size: int) -> bool:
    if pre_start == 0 and start != 4:
        return True
    return start < pre_start + pre_size


def _filter_groups(meta: ThriftStruct, part_offset: int, part_length: int) -> None:
    rgs = meta.get(_FMD_ROW_GROUPS)
    if rgs is None:
        return
    groups: List[ThriftStruct] = rgs.values
    pre_start = 0
    pre_size = 0
    first_has_md = bool(groups) and groups[0].get(_RG_COLUMNS).values[0].has(_CC_META_DATA)

    kept = []
    for rg in groups:
        cols = rg.get(_RG_COLUMNS).values
        if first_has_md:
            start = _chunk_offset(cols[0])
        else:
            start = rg.get(_RG_FILE_OFFSET, 0)
            if _invalid_file_offset(start, pre_start, pre_size):
                start = 4 if pre_start == 0 else pre_start + pre_size
            pre_start = start
            pre_size = rg.get(_RG_TOTAL_COMPRESSED_SIZE, 0)
        if rg.has(_RG_TOTAL_COMPRESSED_SIZE):
            total = rg.get(_RG_TOTAL_COMPRESSED_SIZE)
        else:
            total = sum(c.get(_CC_META_DATA).get(_CMD_TOTAL_COMPRESSED_SIZE, 0) for c in cols)
        mid = start + total // 2
        if part_offset <= mid < part_offset + part_length:
            kept.append(rg)
    rgs.values = kept


# ---------------------------------------------------------------------------
# public surface (ParquetFooter.java API shape)
# ---------------------------------------------------------------------------


class ParquetFooter:
    """A parsed + filtered footer handle (close() is a no-op here; the
    C ABI exposes explicit ownership like the reference's jlong handle)."""

    def __init__(self, meta: ThriftStruct):
        self._meta = meta

    def get_num_rows(self) -> int:
        rgs = self._meta.get(_FMD_ROW_GROUPS)
        if rgs is None:
            return 0
        return sum(rg.get(_RG_NUM_ROWS, 0) for rg in rgs.values)

    def get_num_columns(self) -> int:
        schema = self._meta.get(_FMD_SCHEMA)
        if schema is None or not schema.values:
            return 0
        return schema.values[0].get(_SE_NUM_CHILDREN, 0) or 0

    def serialize_thrift_file(self) -> bytes:
        """PAR1 + thrift + LE length + PAR1 (:672-706)."""
        body = tc.write_struct(self._meta)
        return b"PAR1" + body + struct.pack("<I", len(body)) + b"PAR1"

    def close(self) -> None:
        self._meta = None


def _extract_footer_bytes(buf: bytes) -> bytes:
    """Accept either raw footer thrift bytes or a full/tail parquet file
    slice ending in <len><PAR1>."""
    if len(buf) >= 8 and buf[-4:] == b"PAR1":
        (flen,) = struct.unpack("<I", buf[-8:-4])
        if flen + 8 <= len(buf):
            return buf[-8 - flen : -8]
    return buf


def read_and_filter(
    buf: bytes,
    part_offset: int,
    part_length: int,
    schema: StructElement,
    ignore_case: bool = False,
) -> ParquetFooter:
    """Parity: ParquetFooter.readAndFilter (ParquetFooter.java:200) ->
    Java_..._readAndFilter (NativeParquetJni.cpp:574-633)."""
    meta = tc.read_struct(_extract_footer_bytes(buf))

    names, num_children, tags, parent_n = flatten_schema(schema)
    if ignore_case:
        # requested names fold at the API layer (ParquetFooter.java:207);
        # footer-side names fold in _SchemaWalk.name
        names = [n.lower() for n in names]
    pruner = build_pruner(names, num_children, tags, parent_n)

    schema_list = meta.get(_FMD_SCHEMA)
    walk = _SchemaWalk(schema_list.values, ignore_case)
    _filter_schema(pruner, walk)

    # gather new schema, patching num_children (:601-611)
    new_schema = []
    for idx, n_kids in zip(walk.schema_map, walk.schema_num_children):
        e = ThriftStruct(dict(schema_list.values[idx].fields))
        # Groups keep num_children even when pruned to 0 (the reference
        # serializes num_children=0 rather than an untyped pseudo-leaf);
        # true leaves never had the field and stay without it.
        if e.has(_SE_NUM_CHILDREN) or n_kids > 0:
            e.set(_SE_NUM_CHILDREN, tc.CT_I32, n_kids)
        new_schema.append(e)
    schema_list.values = new_schema

    # column_orders gathered by chunk_map (:612-619)
    orders = meta.get(_FMD_COLUMN_ORDERS)
    if orders is not None:
        orders.values = [orders.values[i] for i in walk.chunk_map]

    # row-group split selection (:621-624)
    if part_length >= 0:
        _filter_groups(meta, part_offset, part_length)

    # prune each row group's chunks (:558-567)
    rgs = meta.get(_FMD_ROW_GROUPS)
    if rgs is not None:
        for rg in rgs.values:
            cols = rg.get(_RG_COLUMNS)
            cols.values = [cols.values[i] for i in walk.chunk_map]

    return ParquetFooter(meta)
