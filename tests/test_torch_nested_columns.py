"""Port: nested column handles (STRUCT, LIST of any child, MAP as
LIST<STRUCT<key, value>>) and the ``bitutils`` helpers the readers use
(``ragged_positions``, ``to_le_bytes`` / ``from_le_bytes``), against the
JAX package on the same seeded host arrays. Exact: every array's dtype,
shape and bytes, ``len``, ``null_count`` and ``to_pylist``."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import bitutils as jbits

from spark_rapids_jni_tpu_torch.columnar import Column, Table, dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import bitutils as pbits
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

from torch_io_parity import assert_same_host, host_spec, jax_host, port_host


def pdtype(name, scale=0):
    return pdt.DType(pdt.TypeId[name], scale)


def jdtype(name, scale=0):
    return jdt.DType(jdt.TypeId[name], scale)


def _mask(rng, n, rate):
    return None if rate == 0 else rng.random(n) >= rate


def gen(kind, n, rng, null_rate=0.2):
    """A seeded host dict (``jax_host`` form) of ``n`` rows of ``kind``:
    "int64", "int32", "float64", "bool8", "string", ("list", inner),
    ("struct", [(name, inner), ...]) or ("map", key, value)."""
    v = _mask(rng, n, null_rate)
    if kind == "string":
        lens = rng.integers(0, 7, n).astype(np.int32)
        offs = np.zeros(n + 1, np.int32)
        np.cumsum(lens, out=offs[1:])
        return {"type": "STRING", "scale": 0, "validity": v, "offsets": offs,
                "chars": rng.integers(97, 123, int(offs[-1])).astype(np.uint8)}
    if isinstance(kind, str):
        npd = {"int64": np.int64, "int32": np.int32, "float64": np.uint64, "bool8": np.uint8}[kind]
        name = {"int64": "INT64", "int32": "INT32", "float64": "FLOAT64", "bool8": "BOOL8"}[kind]
        data = (rng.standard_normal(n).view(np.uint64) if kind == "float64"
                else rng.integers(0, 2, n).astype(np.uint8) if kind == "bool8"
                else rng.integers(-1000, 1000, n).astype(npd))
        return {"type": name, "scale": 0, "validity": v, "data": data}
    if kind[0] == "list":
        lens = rng.integers(0, 4, n).astype(np.int32)
        offs = np.zeros(n + 1, np.int32)
        np.cumsum(lens, out=offs[1:])
        return {"type": "LIST", "scale": 0, "validity": v, "offsets": offs,
                "child": gen(kind[1], int(offs[-1]), rng, null_rate)}
    if kind[0] == "map":
        lens = rng.integers(0, 3, n).astype(np.int32)
        offs = np.zeros(n + 1, np.int32)
        np.cumsum(lens, out=offs[1:])
        m = int(offs[-1])
        kv = {"type": "STRUCT", "scale": 0, "validity": None,
              "children": [gen(kind[1], m, rng, 0), gen(kind[2], m, rng, null_rate)],
              "names": ["key", "value"]}
        return {"type": "LIST", "scale": 0, "validity": v, "offsets": offs, "child": kv}
    return {"type": "STRUCT", "scale": 0, "validity": v,
            "children": [gen(k, n, rng, null_rate) for _, k in kind[1]],
            "names": [nm for nm, _ in kind[1]]}


def jax_col(h):
    v = None if h["validity"] is None else jnp.asarray(h["validity"])
    if h["type"] == "STRING":
        return JColumn.strings_from_parts(h["offsets"], h["chars"], validity=v)
    if h["type"] == "LIST":
        return JColumn.list_from_parts(h["offsets"], jax_col(h["child"]), validity=v)
    if h["type"] == "STRUCT":
        return JColumn.struct_from_parts([jax_col(c) for c in h["children"]], h["names"],
                                         validity=v)
    return JColumn(jdtype(h["type"], h["scale"]), data=jnp.asarray(h["data"]), validity=v)


def port_col(h):
    arr, d, v = host_spec(h, pdtype)
    return carry_table([arr], [d], [v], device="cpu").columns[0]


CASES = {
    "list_int64": ("list", "int64"),
    "list_string": ("list", "string"),
    "list_list_int32": ("list", ("list", "int32")),
    "struct_int32_string": ("struct", [("a", "int32"), ("b", "string")]),
    "struct_list_float64": ("struct", [("v", ("list", "int64")), ("f", "float64")]),
    "list_struct": ("list", ("struct", [("a", "int64"), ("t", "bool8")])),
    "map_string_int64": ("map", "string", "int64"),
    "struct_struct": ("struct", [("in", ("struct", [("x", "int32")])), ("s", "string")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [0, 37])
def test_nested_handles_match_the_reference(case, n):
    rng = np.random.default_rng(hash(case) % 2**32)
    h = gen(CASES[case], n, rng)
    jc, pc = jax_col(h), port_col(h)
    assert_same_host(jax_host(jc), port_host(pc), case)
    assert len(pc) == len(jc) == n
    assert pc.null_count == jc.null_count
    assert pc.to_pylist() == jc.to_pylist()
    # and back: table_to_numpy gives carry_table's input again
    arrays, validity = table_to_numpy(Table([pc]))
    again = carry_table(arrays, [pc.dtype], validity, device="cpu").columns[0]
    assert_same_host(port_host(again), port_host(pc), case)


def test_struct_len_from_its_children_without_validity():
    a = Column.from_numpy(np.arange(5, dtype=np.int32), device="cpu")
    s = Column.struct_from_parts([a], ["a"], device="cpu")
    assert len(s) == 5 and s.validity is None and s.null_count == 0
    assert s.device.type == "cpu"
    assert s.to_pylist() == [{"a": i} for i in range(5)]
    js = JColumn.struct_from_parts([JColumn.from_numpy(np.arange(5, dtype=np.int32))], ["a"])
    assert s.to_pylist() == js.to_pylist()


def test_struct_len_from_validity_and_unnamed_children():
    kids = [Column.from_numpy(np.arange(3, dtype=np.int64), device="cpu")]
    s = Column(pdt.STRUCT, validity=torch.tensor([True, False, True]), children=kids)
    assert len(s) == 3 and s.null_count == 1
    assert s.to_pylist() == [{"f0": 0}, None, {"f0": 2}]
    js = JColumn(jdt.STRUCT, validity=jnp.asarray([True, False, True]),
                 children=(JColumn.from_numpy(np.arange(3, dtype=np.int64)),))
    assert s.to_pylist() == js.to_pylist()


def test_empty_struct_has_no_rows():
    s = Column(pdt.STRUCT, children=())
    assert len(s) == 0
    assert len(JColumn(jdt.STRUCT, children=())) == 0


def test_nested_constructors_take_host_parts():
    child = Column.from_numpy(np.array([1, 2, 3], np.int64), device="cpu")
    lst = Column.list_from_parts(np.array([0, 2, 2, 3]), child, np.array([1, 0, 1], bool),
                                 device="cpu")
    assert lst.offsets.dtype == torch.int32 and lst.validity.dtype == torch.bool
    assert lst.to_pylist() == [[1, 2], None, [3]]
    jl = JColumn.list_from_parts(np.array([0, 2, 2, 3], np.int32),
                                 JColumn.from_numpy(np.array([1, 2, 3], np.int64)),
                                 validity=jnp.asarray([True, False, True]))
    assert lst.to_pylist() == jl.to_pylist()


@pytest.mark.parametrize("name", ["LIST", "STRUCT"])
def test_from_pylist_takes_no_nested_values_like_the_reference(name):
    with pytest.raises(ValueError):
        Column.from_pylist([[1], [2]], pdtype(name), device="cpu")
    with pytest.raises(ValueError):
        JColumn.from_pylist([[1], [2]], jdtype(name))


@pytest.mark.parametrize("name", ["LIST", "STRUCT"])
def test_to_numpy_refuses_nested(name):
    h = gen(("list", "int32") if name == "LIST" else ("struct", [("a", "int32")]), 4,
            np.random.default_rng(1))
    with pytest.raises(ValueError, match="no flat data"):
        port_col(h).to_numpy()


def test_bool8_to_pylist_gives_bools_like_the_reference():
    data = np.array([1, 0, 1], np.uint8)
    p = Column.from_numpy(data, pdt.BOOL8, np.array([1, 1, 0], bool), device="cpu")
    j = JColumn.from_numpy(data, jdt.BOOL8, np.array([1, 1, 0], bool))
    assert p.to_pylist() == j.to_pylist() == [True, False, None]
    assert [type(x) for x in p.to_pylist()[:2]] == [bool, bool]


def test_row_layout_still_rejects_struct():
    with pytest.raises(ValueError, match="only STRING compound"):
        prc.compute_row_layout([pdt.INT32, pdt.STRUCT])
    with pytest.raises(ValueError, match="only STRING compound"):
        prc.compute_row_layout([pdt.LIST])


# ---------------------------------------------------------------------------
# bitutils
# ---------------------------------------------------------------------------

LENS = {
    "empty": [],
    "zeros": [0, 0, 0],
    "one": [5],
    "mixed": [3, 0, 1, 0, 7, 2],
    "trailing_zero": [2, 2, 0],
}


@pytest.mark.parametrize("case", sorted(LENS))
def test_ragged_positions_match_the_reference(case):
    lens = np.array(LENS[case], np.int32)
    jo, jr, jp, jt = jbits.ragged_positions(jnp.asarray(lens))
    po, pr, pp, pt = pbits.ragged_positions(torch.from_numpy(lens))
    assert pt == jt
    for j, p in ((jo, po), (jr, pr), (jp, pp)):
        assert p.dtype == torch.int32
        assert np.array_equal(np.asarray(j), p.numpy())


def test_ragged_positions_random_lengths():
    lens = np.random.default_rng(7).integers(0, 50, 1000).astype(np.int32)
    jo, jr, jp, jt = jbits.ragged_positions(jnp.asarray(lens))
    po, pr, pp, pt = pbits.ragged_positions(torch.from_numpy(lens))
    assert pt == jt == int(lens.sum())
    assert all(np.array_equal(np.asarray(j), p.numpy()) for j, p in ((jo, po), (jr, pr), (jp, pp)))


LE_TYPES = ["INT8", "INT16", "INT32", "INT64", "UINT32", "UINT64", "FLOAT32", "FLOAT64",
            "BOOL8", "DECIMAL128"]


@pytest.mark.parametrize("name", LE_TYPES)
def test_le_bytes_match_the_reference(name):
    rng = np.random.default_rng(11)
    jd, pd = jdtype(name, -2 if name == "DECIMAL128" else 0), pdtype(
        name, -2 if name == "DECIMAL128" else 0)
    shape = (9, 4) if name == "DECIMAL128" else (9,)
    raw = rng.integers(0, 256, int(np.prod(shape)) * (16 // 4 if name == "DECIMAL128" else
                                                      np.dtype(jd.np_dtype).itemsize),
                       dtype=np.uint8)
    host = raw.view(jd.np_dtype).reshape(shape)
    jb = np.asarray(jbits.to_le_bytes(jnp.asarray(host), jd))
    pcol = carry_table([host], [pd], device="cpu").columns[0]
    pb = pbits.to_le_bytes(pcol.data, pd)
    assert pb.dtype == torch.uint8 and tuple(pb.shape) == jb.shape
    assert np.array_equal(pb.numpy(), jb)
    back = pbits.from_le_bytes(pb, pd)
    assert back.dtype == pcol.data.dtype and back.shape == pcol.data.shape
    assert np.array_equal(back.numpy().view(np.uint8), pcol.data.numpy().view(np.uint8))
    assert np.array_equal(np.asarray(jbits.from_le_bytes(jnp.asarray(jb), jd)).view(np.uint8),
                          back.numpy().view(np.uint8))
