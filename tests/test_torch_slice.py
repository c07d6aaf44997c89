"""Port: the whole fixed-width slice against the JAX package on one seeded
table of 2000 rows x 24 columns. JCUDF rows made by the JAX package are
decoded by the port, aggregated with an INT64 key in [0, 512) and a
FLOAT32 value, and re-encoded. Decoded columns and re-encoded rows are
bit-identical; counts are exact and sums within rtol 2e-6 / atol 1e-3,
the reference's own bound for its group-by kernel."""

import numpy as np
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.ops.aggregate import groupby_sum_bounded as jax_groupby

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.ops.aggregate import groupby_sum_bounded

N, NUM_KEYS = 2000, 512
NINE = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "BOOL8"]
# key, value, then 22 columns: the nine integer types cycled, FLOAT64, DECIMAL128
SCHEMA = ["INT64", "FLOAT32"] + [NINE[i % 9] for i in range(20)] + ["FLOAT64", "DECIMAL128"]


def _seeded_table():
    rng = np.random.default_rng(20261016)
    jd = [jdt.decimal128(-2) if s == "DECIMAL128" else getattr(jdt, s) for s in SCHEMA]
    pd = [pdt.decimal128(-2) if s == "DECIMAL128" else getattr(pdt, s) for s in SCHEMA]
    arrays, valids = [], []
    for i, d in enumerate(jd):
        if i == 0:
            a = rng.integers(0, NUM_KEYS, N).astype(np.int64)
        elif i == 1:
            a = rng.standard_normal(N).astype(np.float32)
        elif d.id == jdt.TypeId.BOOL8:
            a = rng.integers(0, 2, N).astype(np.uint8)
        elif d.id == jdt.TypeId.FLOAT64:
            a = rng.standard_normal(N).view(np.uint64)
        elif d.id == jdt.TypeId.DECIMAL128:
            a = rng.integers(0, 2**32, (N, 4), dtype=np.uint32)
        else:
            info = np.iinfo(d.np_dtype)
            a = rng.integers(info.min, info.max, N, dtype=d.np_dtype, endpoint=True)
        arrays.append(a)
        valids.append(rng.random(N) < 0.9 if i >= 2 and i % 3 == 0 else None)
    jt = JTable([JColumn(d, data=jnp.asarray(a), validity=None if v is None else jnp.asarray(v))
                 for d, a, v in zip(jd, arrays, valids)])
    return jt, jd, pd


def test_slice_decode_aggregate_encode_matches_jax():
    jt, jd, pd = _seeded_table()
    jrows = jrc.convert_to_rows(jt)
    assert len(jrows) == 1
    blob = np.asarray(jrows[0].child.data)
    prows = Column.list_from_parts(
        torch.from_numpy(np.asarray(jrows[0].offsets).copy()),
        Column(pdt.INT8, data=torch.from_numpy(blob.copy())),
    )

    jdec = jrc.convert_from_rows(jrows[0], jd)
    pdec = prc.convert_from_rows(prows, pd)
    for i, (a, b) in enumerate(zip(jdec.columns, pdec.columns)):
        x, y = np.asarray(a.data), b.to_numpy()
        assert x.dtype == y.dtype, i
        np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8), err_msg=f"column {i}")
        np.testing.assert_array_equal(b.validity.numpy(), np.asarray(a.validity))

    js, jc = jax_groupby(jdec.columns[0].data, jdec.columns[1].data, NUM_KEYS)
    ps, pc = groupby_sum_bounded(pdec.columns[0].data, pdec.columns[1].data, NUM_KEYS)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=2e-6, atol=1e-3)
    assert int(pc.sum()) == N

    renc = prc.convert_to_rows(pdec)
    assert len(renc) == 1
    np.testing.assert_array_equal(renc[0].child.data.numpy(), blob)
    np.testing.assert_array_equal(renc[0].offsets.numpy(), np.asarray(jrows[0].offsets))


def test_carry_table_round_trips_bits():
    jt, _, pd = _seeded_table()
    arrays = [np.asarray(c.data) for c in jt.columns]
    valids = [None if c.validity is None else np.asarray(c.validity) for c in jt.columns]
    pt = carry_table(arrays, pd, valids, device="cpu")
    back, back_valid = table_to_numpy(pt)
    for a, b, va, vb in zip(arrays, back, valids, back_valid):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))
        assert (va is None) == (vb is None)
        if va is not None:
            np.testing.assert_array_equal(vb, va)
    # the carried table encodes to the JAX package's rows
    jrows = jrc.convert_to_rows(jt)
    np.testing.assert_array_equal(prc.convert_to_rows(pt)[0].child.data.numpy(),
                                  np.asarray(jrows[0].child.data))
