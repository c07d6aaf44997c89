"""Port: JCUDF row transcode with STRING columns over input classes
(empty and some-empty strings, an all-null column, every column a
string, tail lanes, UTF-8, long strings, DECIMAL128 and BOOL8 beside
strings, one string column, a wide table with nulls) against the JAX
package on the same seeded tables: row blobs and offsets byte-identical,
decoded columns bit-identical; the port's scatter path against the JAX
package's padded path; and the rows of each package decoded by the
other. The port runs on CPU tensors, so B5 and B6-B10 run as their plain
versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import Column, dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from test_torch_row_conversion_strings import (MIXED, _assert_rows_equal, _assert_tables_equal,
                                               _blob, _case, _dtypes, _make, _round)


# input classes: (column names, rows, _make options)
CLASSES = {
    "empty_strings": (["INT32", "STRING", "INT64", "STRING"], 40, dict(lo=0, hi=0)),
    "some_empty": (["STRING", "FLOAT64", "STRING"], 90, dict(lo=0, hi=3)),
    "all_null_column": (["INT16", "STRING", "STRING", "INT32"], 50, dict(all_null=(1,))),
    "every_column_string": (["STRING"] * 6, 70, dict(lo=0, hi=20)),
    "tail_lane": (["INT32", "STRING", "INT8"], 45, {}),  # fixed_end 14
    "tail_lane_3": (["STRING", "INT8", "INT8"], 45, {}),  # fixed_end 11
    "utf8": (["STRING", "INT64", "STRING"], 60, dict(utf8=True, lo=0, hi=9)),
    "long_strings": (["INT64", "STRING", "STRING"], 30, dict(lo=100, hi=700)),
    "decimal_and_bool": (["DECIMAL128", "STRING", "BOOL8", "UINT16", "STRING"], 33, {}),
    "one_string_column": (["STRING"], 64, dict(nulls_every=1)),
    "wide_with_nulls": (MIXED, 120, dict(nulls_every=2, lo=0, hi=32)),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_input_class_encode_identical(case):
    names, n, opts = CLASSES[case]
    _, pt, _, _, jrows = _case(names, n, **opts)
    _assert_rows_equal(jrows, prc.convert_to_rows(pt))


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_input_class_decode_identical(case):
    names, n, opts = CLASSES[case]
    _, pt, jd, pd, jrows = _case(names, n, **opts)
    prows = prc.convert_to_rows(pt)
    _assert_tables_equal(jrc.convert_from_rows(jrows[0], jd), prc.convert_from_rows(prows[0], pd))


@pytest.mark.parametrize("case", ["wide_with_nulls", "tail_lane", "utf8", "all_null_column"])
def test_scatter_path_identical(rng, monkeypatch, case):
    # the size gate sends every table to the scatter path; the JAX package
    # takes its padded path, and the blobs must still agree
    monkeypatch.setattr(prc, "_PADDED_ROWS_BYTE_BUDGET", 0)
    names, n, opts = CLASSES[case]
    jt, pt, jd, pd = _make(rng, names, n, **opts)
    called = []
    real = prc._encode_strings_scatter
    monkeypatch.setattr(prc, "_encode_strings_scatter", lambda *a: called.append(1) or real(*a))
    _round(jt, pt, jd, pd)
    assert called


def _port_rows(jrows):
    offs = torch.from_numpy(np.asarray(jrows.offsets).copy())
    child = Column(pdt.INT8, data=torch.from_numpy(_blob(jrows).view(np.int8).copy()))
    return Column.list_from_parts(offs, child)


@pytest.mark.parametrize("case", ["wide_with_nulls", "utf8", "empty_strings"])
def test_jax_rows_decoded_by_port(case):
    names, n, opts = CLASSES[case]
    _, _, jd, pd, jrows = _case(names, n, **opts)
    _assert_tables_equal(jrc.convert_from_rows(jrows[0], jd),
                         prc.convert_from_rows(_port_rows(jrows[0]), pd))


@pytest.mark.parametrize("case", ["wide_with_nulls", "long_strings", "every_column_string"])
def test_port_rows_decoded_by_jax(rng, case):
    names, n, opts = CLASSES[case]
    jt, pt, jd, _ = _make(rng, names, n, **opts)
    prows = prc.convert_to_rows(pt)[0]
    jrows = JColumn.list_from_parts(
        jnp.asarray(prows.offsets.numpy()),
        JColumn(jdt.INT8, data=jnp.asarray(prows.child.data.numpy())))
    _assert_tables_equal(jrc.convert_from_rows(jrows, jd), _as_port_table(jt))


def _as_port_table(jt):
    """A JAX table as it must come back: the input itself."""
    return carry_table(
        [(np.asarray(c.offsets), np.asarray(c.chars)) if c.dtype.id == jdt.TypeId.STRING
         else np.asarray(c.data) for c in jt.columns],
        _dtypes([c.dtype.id.name if c.dtype.id != jdt.TypeId.DECIMAL128 else "DECIMAL128"
                 for c in jt.columns])[1],
        [None if c.validity is None else np.asarray(c.validity) for c in jt.columns],
        device="cpu")
