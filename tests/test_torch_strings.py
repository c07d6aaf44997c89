"""Port: STRING columns (spark_rapids_jni_tpu_torch.columnar.Column,
interop.carry_table) against the JAX package's ``Column``, and the string
slice as a whole: a JAX-package table with STRING columns carried across
with ``carry_table``, then encode -> decode -> GROUP BY SUM in the port,
equal to the JAX package end to end. Offsets, chars, validity, row blobs
and counts are exact; float32 sums within rtol 2e-6 / atol 1e-3, the
reference's own bound for its group-by kernel."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops.aggregate import groupby_sum_bounded as jax_groupby

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops.aggregate import groupby_sum_bounded

PYLISTS = {
    "ascii": ["hello", "", None, "spark on tpu!", "a"],
    "utf8": ["naïve", "日本語", None, "😀😀", "Ж"],
    "all_null": [None, None, None],
    "empty": [],
    "bytes": [b"\x00\xff", b"", b"abc", None],
}


@pytest.mark.parametrize("case", sorted(PYLISTS))
def test_from_pylist_matches_jax(case):
    vals = PYLISTS[case]
    j = JColumn.from_pylist(vals, jdt.STRING)
    p = Column.from_pylist(vals, pdt.STRING, device="cpu")
    assert len(p) == len(vals) and p.device.type == "cpu"
    np.testing.assert_array_equal(p.offsets.numpy(), np.asarray(j.offsets))
    assert p.offsets.dtype == torch.int32 and p.chars.dtype == torch.uint8
    np.testing.assert_array_equal(p.chars.numpy(), np.asarray(j.chars))
    np.testing.assert_array_equal(p.valid_mask().numpy(), np.asarray(j.valid_mask()))
    assert p.to_pylist() == j.to_pylist()
    assert p.max_char_len == j.max_char_len
    assert p.null_count == sum(v is None for v in vals)


def test_max_char_len_from_device_offsets():
    offs = torch.tensor([0, 3, 3, 10, 12], dtype=torch.int32)
    col = Column(pdt.STRING, offsets=offs, chars=torch.zeros(12, dtype=torch.uint8))
    assert col.max_char_len == 7 and col.__dict__["_max_char_len"] == 7
    empty = Column(pdt.STRING, offsets=torch.zeros(1, dtype=torch.int32),
                   chars=torch.zeros(0, dtype=torch.uint8))
    assert len(empty) == 0 and empty.max_char_len == 0


def test_strings_from_parts_keeps_tensors_where_they_are():
    offs = torch.tensor([0, 2, 5], dtype=torch.int64)
    chars = torch.tensor(list(b"hello"), dtype=torch.int16)
    col = Column.strings_from_parts(offs, chars)
    assert col.offsets.dtype == torch.int32 and col.chars.dtype == torch.uint8
    assert col.to_pylist() == ["he", "llo"]


def test_fixed_width_pylist_round_trip():
    vals = [1.5, None, -2.25]
    col = Column.from_pylist(vals, pdt.FLOAT64, device="cpu")
    assert col.to_pylist() == vals
    assert Column.from_pylist([3, None, 7], pdt.INT16, device="cpu").to_pylist() == [3, None, 7]
    big = [1, None, -(2**127), 2**127 - 1]
    assert Column.from_pylist(big, pdt.decimal128(-2), device="cpu").to_pylist() == big
    with pytest.raises(ValueError, match="STRING or a fixed-width"):
        Column.from_pylist([1], pdt.LIST, device="cpu")


def test_string_column_has_no_flat_data():
    col = Column.from_pylist(["x"], pdt.STRING, device="cpu")
    with pytest.raises(ValueError, match="no flat data"):
        col.to_numpy()


def test_carry_table_round_trips_strings(rng):
    jcols = [JColumn.from_pylist(PYLISTS["utf8"], jdt.STRING),
             JColumn(jdt.INT32, data=jnp.asarray(np.arange(5, dtype=np.int32))),
             JColumn.from_pylist(PYLISTS["ascii"], jdt.STRING)]
    arrays = [(np.asarray(c.offsets), np.asarray(c.chars)) if c.dtype.id == jdt.TypeId.STRING
              else np.asarray(c.data) for c in jcols]
    valids = [None if c.validity is None else np.asarray(c.validity) for c in jcols]
    pt = carry_table(arrays, [pdt.STRING, pdt.INT32, pdt.STRING], valids, device="cpu")
    back, back_valid = table_to_numpy(pt)
    for a, b in zip(arrays, back):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
        else:
            np.testing.assert_array_equal(b, a)
    for va, vb in zip(valids, back_valid):
        assert (va is None) == (vb is None)
        if va is not None:
            np.testing.assert_array_equal(vb, va)
    assert pt.columns[0].to_pylist() == jcols[0].to_pylist()


# ---------------------------------------------------------------------------
# the string slice, end to end
# ---------------------------------------------------------------------------

NUM_KEYS = 512
# the mixed-strings schema of chip_smoke.py cut to 25 columns: column 1 the
# FLOAT32 value, column 2 the INT64 key, every tenth column STRING
SCHEMA = ["STRING" if i % 10 == 0 else ["INT32", "FLOAT64", "INT64", "INT16"][i % 4]
          for i in range(25)]
SCHEMA[1], SCHEMA[2] = "FLOAT32", "INT64"


def _seeded_jax_table(n, seed):
    rng = np.random.default_rng(seed)
    cols = []
    for i, name in enumerate(SCHEMA):
        v = rng.random(n) < 0.85 if i % 5 == 0 else None
        if name == "STRING":
            vals = [None if v is not None and not v[r] else
                    "".join(rng.choice(list("abcdefgh é€"), rng.integers(1, 33))) for r in range(n)]
            cols.append(JColumn.from_pylist(vals, jdt.STRING))
            continue
        d = getattr(jdt, name)
        if i == 1:
            a = rng.standard_normal(n).astype(np.float32)
        elif i == 2:
            a = rng.integers(0, NUM_KEYS, n).astype(np.int64)
        elif name == "FLOAT64":
            a = rng.standard_normal(n).view(np.uint64)
        else:
            info = np.iinfo(d.np_dtype)
            a = rng.integers(info.min, info.max, n, dtype=d.np_dtype, endpoint=True)
        cols.append(JColumn(d, data=jnp.asarray(a), validity=None if v is None else jnp.asarray(v)))
    return JTable(cols)


def _carry(jt):
    arrays = [(np.asarray(c.offsets), np.asarray(c.chars)) if c.dtype.id == jdt.TypeId.STRING
              else np.asarray(c.data) for c in jt.columns]
    valids = [None if c.validity is None else np.asarray(c.validity) for c in jt.columns]
    return carry_table(arrays, [getattr(pdt, s) for s in SCHEMA], valids, device="cpu")


@pytest.mark.parametrize("n,seed", [(400, 7), (1500, 20261016)])
def test_string_slice_matches_jax(n, seed):
    jt = _seeded_jax_table(n, seed)
    pt = _carry(jt)
    jd = [getattr(jdt, s) for s in SCHEMA]
    pd = [getattr(pdt, s) for s in SCHEMA]

    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    assert len(jrows) == len(prows) == 1
    np.testing.assert_array_equal(prows[0].child.data.numpy().view(np.uint8),
                                  np.asarray(jrows[0].child.data).view(np.uint8))
    np.testing.assert_array_equal(prows[0].offsets.numpy(), np.asarray(jrows[0].offsets))

    jdec = jrc.convert_from_rows(jrows[0], jd)
    pdec = prc.convert_from_rows(prows[0], pd)
    for i, (a, b) in enumerate(zip(jdec.columns, pdec.columns)):
        np.testing.assert_array_equal(b.valid_mask().numpy(), np.asarray(a.valid_mask()))
        if a.dtype.id == jdt.TypeId.STRING:
            np.testing.assert_array_equal(b.offsets.numpy(), np.asarray(a.offsets), err_msg=str(i))
            np.testing.assert_array_equal(b.chars.numpy(), np.asarray(a.chars), err_msg=str(i))
            assert b.to_pylist() == jt.columns[i].to_pylist()
        else:
            np.testing.assert_array_equal(b.to_numpy().view(np.uint8),
                                          np.asarray(a.data).view(np.uint8), err_msg=str(i))

    js, jc = jax_groupby(jdec.columns[2].data, jdec.columns[1].data, NUM_KEYS)
    ps, pc = groupby_sum_bounded(pdec.columns[2].data, pdec.columns[1].data, NUM_KEYS)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=2e-6, atol=1e-3)
    assert int(pc.sum()) == n

    # and the decoded table encodes back to the same rows
    np.testing.assert_array_equal(prc.convert_to_rows(pdec)[0].child.data.numpy(),
                                  prows[0].child.data.numpy())


def test_table_of_strings_builds_from_columns():
    t = Table([Column.from_pylist(["a", None], pdt.STRING, device="cpu"),
               Column.from_pylist([1, 2], pdt.INT32, device="cpu")])
    assert t.num_rows == 2 and t.dtypes() == [pdt.STRING, pdt.INT32]
    with pytest.raises(ValueError, match="equal length"):
        Table([Column.from_pylist(["a"], pdt.STRING, device="cpu"),
               Column.from_pylist([1, 2], pdt.INT32, device="cpu")])
