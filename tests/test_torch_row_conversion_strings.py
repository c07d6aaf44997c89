"""Port: JCUDF row transcode with STRING columns
(spark_rapids_jni_tpu_torch.ops.row_conversion) against the JAX package on
the same seeded tables: row blobs and offsets byte-identical, decoded
columns (fixed data, string offsets and chars, validity) bit-identical.
The port runs on CPU tensors, so B5 and B6-B10 run as their plain
versions. The input classes (empty, all-null, UTF-8, long strings, ...),
the scatter path and the rows each package decodes from the other's are
in ``test_torch_row_conversion_string_classes.py``, the batch split and
the grouped decode in ``test_torch_row_conversion_string_batches.py``;
both take their inputs and checks from here."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

# the reference's row_conversion_mixed_strings axis (benchmarks/microbench.py:
# 264-292) cut to 35 columns: INT32, FLOAT64, INT64, INT16 cycling, every
# tenth column STRING
MIXED = ["STRING" if i % 10 == 0 else ["INT32", "FLOAT64", "INT64", "INT16"][i % 4]
         for i in range(35)]
_UTF8 = list("aé€😀ßЖ日本 x")


def _dtypes(names):
    j = [jdt.decimal128(-2) if nm == "DECIMAL128" else getattr(jdt, nm) for nm in names]
    p = [pdt.decimal128(-2) if nm == "DECIMAL128" else getattr(pdt, nm) for nm in names]
    return j, p


def _strings(rng, n, lo, hi, valid, utf8=False):
    """(offsets int32, chars uint8) with lengths in [lo, hi] bytes (code
    points for ``utf8``); null rows hold no bytes."""
    if utf8:
        enc = [("".join(rng.choice(_UTF8, rng.integers(lo, hi + 1)))).encode() for _ in range(n)]
    else:
        enc = [rng.integers(0, 256, rng.integers(lo, hi + 1), dtype=np.uint8).tobytes()
               for _ in range(n)]
    if valid is not None:
        enc = [e if ok else b"" for e, ok in zip(enc, valid)]
    lens = np.array([len(e) for e in enc], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return offs, np.frombuffer(b"".join(enc), np.uint8).copy()


def _make(rng, names, n, nulls_every=3, lo=1, hi=32, utf8=False, all_null=()):
    """Seeded storage arrays + validity -> (JAX Table, port Table, dtypes)."""
    jd, pd = _dtypes(names)
    arrays, valids = [], []
    for i, d in enumerate(jd):
        v = rng.random(n) < 0.8 if i % nulls_every == 0 else None
        if i in all_null:
            v = np.zeros(n, bool)
        if d.id == jdt.TypeId.STRING:
            a = _strings(rng, n, lo, hi, v, utf8)
        elif d.id == jdt.TypeId.BOOL8:
            a = rng.integers(0, 2, n).astype(bool)
        elif d.id == jdt.TypeId.FLOAT32:
            a = rng.standard_normal(n).astype(np.float32)
        elif d.id == jdt.TypeId.FLOAT64:
            a = rng.standard_normal(n).view(np.uint64)
        elif d.id == jdt.TypeId.DECIMAL128:
            a = rng.integers(0, 2**32, (n, 4), dtype=np.uint32)
        else:
            info = np.iinfo(d.np_dtype)
            a = rng.integers(info.min, info.max, n, dtype=d.np_dtype, endpoint=True)
        arrays.append(a)
        valids.append(v)
    cols = []
    for d, a, v in zip(jd, arrays, valids):
        jv = None if v is None else jnp.asarray(v)
        if d.id == jdt.TypeId.STRING:
            cols.append(JColumn.strings_from_parts(a[0], a[1], validity=jv))
        else:
            cols.append(JColumn(d, data=jnp.asarray(a), validity=jv))
    return JTable(cols), carry_table(arrays, pd, valids, device="cpu"), jd, pd


_CASES = {}


def _case(names, n, **opts):
    """``_make`` on a generator seeded as conftest's ``rng`` is, with the
    JAX package's rows of the table: (JAX Table, port Table, dtypes,
    JAX rows), made once a module for each input, so that the encode and
    decode checks of one input share the reference's encode."""
    key = (tuple(names), n, tuple(sorted(opts.items())))
    if key not in _CASES:
        jt, pt, jd, pd = _make(np.random.default_rng(12345), names, n, **opts)
        _CASES[key] = (jt, pt, jd, pd, jrc.convert_to_rows(jt))
    return _CASES[key]


def _blob(col):
    return np.asarray(col.child.data).view(np.uint8)


def _assert_rows_equal(jrows, prows):
    assert len(jrows) == len(prows)
    for j, p in zip(jrows, prows):
        np.testing.assert_array_equal(p.child.data.numpy().view(np.uint8), _blob(j))
        np.testing.assert_array_equal(p.offsets.numpy(), np.asarray(j.offsets))
        assert p.offsets.dtype == torch.int32


def _assert_tables_equal(jtab, ptab):
    assert jtab.num_columns == ptab.num_columns and jtab.num_rows == ptab.num_rows
    for i, (a, b) in enumerate(zip(jtab.columns, ptab.columns)):
        np.testing.assert_array_equal(b.valid_mask().numpy(), np.asarray(a.valid_mask()),
                                      err_msg=f"validity {i}")
        if a.dtype.id == jdt.TypeId.STRING:
            np.testing.assert_array_equal(b.offsets.numpy(), np.asarray(a.offsets), err_msg=f"offsets {i}")
            assert b.offsets.dtype == torch.int32
            np.testing.assert_array_equal(b.chars.numpy(), np.asarray(a.chars), err_msg=f"chars {i}")
            continue
        x, y = np.asarray(a.data), b.to_numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8), err_msg=f"column {i}")


def _round(jt, pt, jd, pd):
    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    _assert_rows_equal(jrows, prows)
    for j, p in zip(jrows, prows):
        _assert_tables_equal(jrc.convert_from_rows(j, jd), prc.convert_from_rows(p, pd))
    return jrows, prows


# n = 1 and 7 keep the fixed-section gather off the kernel, 8 puts it on
@pytest.mark.parametrize("n", [1, 7, 8, 300])
def test_mixed_schema_encode_identical(n):
    _, pt, _, _, jrows = _case(MIXED, n)
    _assert_rows_equal(jrows, prc.convert_to_rows(pt))


@pytest.mark.parametrize("n", [1, 7, 8, 300])
def test_mixed_schema_decode_identical(n):
    _, pt, jd, pd, jrows = _case(MIXED, n)
    prows = prc.convert_to_rows(pt)
    _assert_tables_equal(jrc.convert_from_rows(jrows[0], jd), prc.convert_from_rows(prows[0], pd))


@pytest.mark.parametrize("names", [["STRING", "INT32"], ["STRING", "INT8"],
                                   ["INT16", "STRING", "INT8", "INT8"]])
def test_fixed_end_not_word_aligned(rng, names):
    jd, pd = _dtypes(names)
    assert prc.compute_row_layout(pd).fixed_end % 4 != 0
    _round(*_make(rng, names, 41))


def test_round_trip_restores_inputs(rng):
    _, pt, _, pd = _make(rng, MIXED, 200)
    back = prc.convert_from_rows(prc.convert_to_rows(pt)[0], pd)
    for a, b in zip(pt.columns, back.columns):
        np.testing.assert_array_equal(b.valid_mask().numpy(), a.valid_mask().numpy())
        if a.dtype.id == pdt.TypeId.STRING:
            assert b.to_pylist() == a.to_pylist()
            assert torch.equal(b.offsets, a.offsets) and torch.equal(b.chars, a.chars)
        else:
            np.testing.assert_array_equal(b.to_numpy().view(np.uint8), a.to_numpy().view(np.uint8))


def test_empty_table_with_strings(rng):
    jt, pt, jd, pd = _make(rng, ["INT32", "STRING"], 0)
    jrows, prows = jrc.convert_to_rows(jt), prc.convert_to_rows(pt)
    _assert_rows_equal(jrows, prows)
    back = prc.convert_from_rows(prows[0], pd)
    assert back.num_rows == 0 and back.columns[1].chars.shape == (0,)
    _assert_tables_equal(jrc.convert_from_rows(jrows[0], jd), back)
    assert prc.convert_from_rows_grouped(prows[0], pd).column(1).to_pylist() == []


def test_zero_length_rows_share_start_offsets():
    # the JAX package's own edge case: strings that are all empty except one
    a = ["", "", "x", "", ""]
    b = [None, "yy", "", "", "zzz"]
    jt = JTable([JColumn.from_pylist(a, jdt.STRING), JColumn.from_pylist(b, jdt.STRING)])
    pt = carry_table([(np.asarray(c.offsets), np.asarray(c.chars)) for c in jt.columns],
                     [pdt.STRING, pdt.STRING],
                     [None if c.validity is None else np.asarray(c.validity) for c in jt.columns],
                     device="cpu")
    jrows, prows = _round(jt, pt, [jdt.STRING] * 2, [pdt.STRING] * 2)
    back = prc.convert_from_rows(prows[0], [pdt.STRING] * 2)
    assert back.columns[0].to_pylist() == a and back.columns[1].to_pylist() == b


def test_fixed_width_optimized_rejects_strings():
    with pytest.raises(ValueError, match="fixed-width types"):
        prc._check_optimized([pdt.INT8, pdt.STRING])
