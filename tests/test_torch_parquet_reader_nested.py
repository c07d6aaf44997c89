"""Port: the parquet reader (``io/parquet_reader.read_table``) against the
JAX package's on pyarrow-written files with nested columns: lists,
lists of strings, structs, structs of lists, lists of structs, lists of
lists and maps in v1 and v2 pages, deep nesting across row groups, a
nested column selected beside a flat one, and the harness writer's
nested file. Exact, as ``test_torch_parquet_reader.py`` holds the flat
files: both readers' Tables column by column, every array's dtype,
shape and bytes."""

import pyarrow as pa
import pytest

import torch_io_writers as writers
from test_torch_parquet_reader import both, write


NESTED = {
    "list_of_int": pa.table({"l": pa.array([[1, 2, 3], [], None, [4], [None, 5]],
                                           pa.list_(pa.int64()))}),
    "list_of_strings": pa.table({"l": pa.array([["a", "bb"], None, [], ["", None, "ccc"]],
                                               pa.list_(pa.string()))}),
    "struct_flat": pa.table({"s": pa.array(
        [{"a": 1, "b": "x"}, None, {"a": None, "b": "z"}, {"a": 4, "b": None}],
        pa.struct([("a", pa.int32()), ("b", pa.string())]))}),
    "struct_of_list": pa.table({"s": pa.array(
        [{"v": [1, 2]}, {"v": None}, None, {"v": []}, {"v": [None, 3]}],
        pa.struct([("v", pa.list_(pa.int64()))]))}),
    "list_of_struct": pa.table({"l": pa.array(
        [[{"a": 1}, {"a": None}], [], None, [{"a": 7}]],
        pa.list_(pa.struct([("a", pa.int64())])))}),
    "list_of_list": pa.table({"ll": pa.array(
        [[[1], [2, 3]], [], None, [None, [4, None]], [[]]], pa.list_(pa.list_(pa.int32())))}),
    "map": pa.table({"m": pa.array([[("k1", 1), ("k2", 2)], [], None, [("k3", None)]],
                                    pa.map_(pa.string(), pa.int64()))}),
    "struct_all_null": pa.table({"s": pa.array([None, None], pa.struct([("a", pa.int32())]))}),
}


@pytest.mark.parametrize("case", sorted(NESTED))
@pytest.mark.parametrize("v2", [False, True])
def test_nested_columns_match_the_reference(case, v2):
    kw = dict(data_page_version="2.0") if v2 else {}
    both(write(NESTED[case], **kw))


def test_deep_nesting_across_row_groups(rng):
    rows = []
    for _ in range(300):
        r = int(rng.integers(0, 6))
        rows.append(None if r == 0 else [
            {"tags": None if rng.integers(0, 5) == 0 else
             [f"t{int(x)}" for x in rng.integers(0, 9, int(rng.integers(0, 3)))],
             "n": None if rng.integers(0, 5) == 0 else int(rng.integers(0, 100))}
            for _ in range(int(rng.integers(0, 3)))])
    typ = pa.list_(pa.struct([("tags", pa.list_(pa.string())), ("n", pa.int64())]))
    t = pa.table({"events": pa.array(rows, typ), "id": pa.array(range(300), pa.int64())})
    both(write(t, row_group_size=64))


def test_nested_next_to_flat_selection():
    t = pa.table({"flat": pa.array([1, 2, 3], pa.int32()),
                  "l": pa.array([[1], [], [2, 3]], pa.list_(pa.int32()))})
    jt, pt = both(write(t), columns=["l"])
    assert pt.names == ["l"]


def test_harness_nested_file_matches_the_reference():
    nd = writers.nested_data(2000, 43)
    both(writers.write_parquet_nested(nd, None, rows_per_page=300))
