"""Port: Murmur3 hashing and the shuffle write
(spark_rapids_jni_tpu_torch.ops.hashing, B1's plain version, uword's
murmur arithmetic, parallel.shuffle.hash_partition) against the JAX
package on the same seeded inputs. Every comparison is exact: hashes,
partition ids, partitioned tables and offsets are integers and bytes."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import hashing as jhash
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_partition_map
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle

from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import hashing as phash
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import murmur, uword
from spark_rapids_jni_tpu_torch.parallel import shuffle as pshuffle

_UTF8 = list("aé€😀ßЖ日本 x")


def _strings(rng, n, lo, hi, valid, utf8=False):
    if utf8:
        enc = [("".join(rng.choice(_UTF8, rng.integers(lo, hi + 1)))).encode() for _ in range(n)]
    else:
        enc = [rng.integers(0, 256, rng.integers(lo, hi + 1), dtype=np.uint8).tobytes()
               for _ in range(n)]
    if valid is not None:
        enc = [e if ok else b"" for e, ok in zip(enc, valid)]
    offs = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(np.int32)
    return offs, np.frombuffer(b"".join(enc), np.uint8).copy()


def _values(rng, name, n, valid=None, lo=0, hi=12, utf8=False):
    if name == "STRING":
        return _strings(rng, n, lo, hi, valid, utf8)
    if name == "BOOL8":
        return rng.integers(0, 2, n).astype(np.uint8)
    if name == "FLOAT32":
        a = (rng.standard_normal(n) * 1e9).astype(np.float32)
        a[: min(n, 6)] = [np.nan, np.inf, -np.inf, -0.0, 3e9, -2.7][: min(n, 6)]
        return a
    if name == "FLOAT64":
        a = rng.standard_normal(n)
        a[: min(n, 3)] = [np.nan, -0.0, np.inf][: min(n, 3)]
        return a.view(np.uint64)
    if name == "DECIMAL128":
        return rng.integers(0, 2**32, (n, 4), dtype=np.uint32)
    d = getattr(jdt, name)
    info = np.iinfo(d.np_dtype)
    return rng.integers(info.min, info.max, n, dtype=d.np_dtype, endpoint=True)


def _make(rng, names, n, null_cols=(), **kw):
    """Seeded columns -> (JAX columns, port Table on the CPU)."""
    jd = [jdt.decimal128(-2) if nm == "DECIMAL128" else getattr(jdt, nm) for nm in names]
    pd = [pdt.decimal128(-2) if nm == "DECIMAL128" else getattr(pdt, nm) for nm in names]
    arrays, valids, jcols = [], [], []
    for i, (nm, d) in enumerate(zip(names, jd)):
        v = rng.random(n) < 0.7 if i in null_cols else None
        a = _values(rng, nm, n, v, **kw)
        jv = None if v is None else jnp.asarray(v)
        if nm == "STRING":
            jcols.append(JColumn.strings_from_parts(a[0], a[1], validity=jv))
        else:
            jcols.append(JColumn(d, data=jnp.asarray(a), validity=jv))
        arrays.append(a)
        valids.append(v)
    return jcols, carry_table(arrays, pd, valids, device="cpu")


FIXED = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64",
         "FLOAT32", "FLOAT64", "BOOL8", "DECIMAL128", "TIMESTAMP_DAYS",
         "TIMESTAMP_MICROSECONDS"]


def _u32(x):
    return np.asarray(x).view(np.uint32) if isinstance(x, np.ndarray) else x.numpy().view(np.uint32)


# -- uword: the murmur arithmetic ---------------------------------------------


@pytest.mark.parametrize("b_const", [None, 0xCC9E2D51, 5, 0xFFFFFFFF, 0])
def test_mul_u32_matches_numpy(rng, b_const):
    a = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    a[:4] = [0, 1, 2**32 - 1, 2**31]
    b = rng.integers(0, 2**32, 5000, dtype=np.uint64) if b_const is None else b_const
    tb = torch.from_numpy(b.astype(np.int64)) if b_const is None else b_const
    got = uword.mul_u32(torch.from_numpy(a.astype(np.int64)), tb).numpy()
    with np.errstate(over="ignore"):
        want = (a.astype(np.uint32) * np.asarray(b).astype(np.uint32)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 13, 15, 31])
def test_rotl_u32_matches_numpy(rng, r):
    a = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    got = uword.rotl_u32(torch.from_numpy(a.astype(np.int64)), r).numpy()
    want = ((a << np.uint32(r)) | (a >> np.uint32(32 - r))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_fmix_matches_the_reference(rng):
    from spark_rapids_jni_tpu.ops.pallas_kernels import _fmix

    a = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    got = murmur.fmix(torch.from_numpy(a.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.asarray(_fmix(jnp.asarray(a))).astype(np.int64))


# -- murmur3_table ------------------------------------------------------------


@pytest.mark.parametrize("name", FIXED + ["STRING"])
@pytest.mark.parametrize("nulls", [False, True])
def test_murmur3_table_one_column(rng, name, nulls):
    jcols, pt = _make(rng, [name], 257, null_cols=(0,) if nulls else ())
    want = np.asarray(jhash.murmur3_table(jcols))
    got = phash.murmur3_table(pt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("lo,hi,utf8", [(0, 1, False), (1, 3, False), (0, 40, False),
                                        (1, 9, True), (16, 70, True)])
def test_murmur3_strings(rng, lo, hi, utf8):
    # empty strings, 1-3 byte tails, long strings, multi-byte UTF-8
    jcols, pt = _make(rng, ["STRING"], 301, null_cols=(0,), lo=lo, hi=hi, utf8=utf8)
    np.testing.assert_array_equal(_u32(phash.murmur3_table(pt)),
                                  np.asarray(jhash.murmur3_table(jcols)))


@pytest.mark.parametrize("names", [["INT32", "STRING", "INT64"],
                                   ["FLOAT64", "DECIMAL128", "UINT16", "BOOL8"],
                                   ["STRING", "STRING"], FIXED])
@pytest.mark.parametrize("seed", [42, 0, 2**32 - 7])
def test_murmur3_table_chains_columns(rng, names, seed):
    jcols, pt = _make(rng, names, 199, null_cols=tuple(range(0, len(names), 2)))
    np.testing.assert_array_equal(_u32(phash.murmur3_table(pt, seed)),
                                  np.asarray(jhash.murmur3_table(jcols, seed)))


def test_murmur3_empty_table():
    jcols, pt = _make(np.random.default_rng(1), ["INT32", "STRING"], 0)
    assert phash.murmur3_table(pt).shape == (0,)
    assert np.asarray(jhash.murmur3_table(jcols)).shape == (0,)


@pytest.mark.parametrize("np_dt", [np.int8, np.int16, np.int32, np.int64, np.uint8, np.float32])
@pytest.mark.parametrize("seed_kind", ["int", "array"])
def test_murmur3_raw(rng, np_dt, seed_kind):
    n = 333
    if np_dt == np.float32:
        data = (rng.standard_normal(n) * 1e6).astype(np.float32)
    else:
        info = np.iinfo(np_dt)
        data = rng.integers(info.min, info.max, n, dtype=np_dt, endpoint=True)
    seed = 42 if seed_kind == "int" else rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jhash.murmur3_raw(jnp.asarray(data), seed if seed_kind == "int"
                                        else jnp.asarray(seed)))
    pseed = seed if seed_kind == "int" else torch.from_numpy(seed.view(np.int32))
    got = phash.murmur3_raw(torch.from_numpy(data), pseed)
    np.testing.assert_array_equal(_u32(got), want)


def test_murmur3_raw_matches_the_column_hash(rng):
    jcols, pt = _make(rng, ["INT64"], 100)
    np.testing.assert_array_equal(_u32(phash.murmur3_raw(pt.columns[0].data)),
                                  _u32(phash.murmur3_table(pt)))


# -- hash_partition_map and B1's plain version --------------------------------


@pytest.mark.parametrize("names", [["INT32"], ["INT64"], ["STRING"], ["INT16"],
                                   ["INT32", "STRING"], ["UINT32"]])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("p", [1, 7, 200])
def test_hash_partition_map(rng, names, nulls, p):
    jcols, pt = _make(rng, names, 211, null_cols=(0,) if nulls else ())
    got = phash.hash_partition_map(pt, p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhash.hash_partition_map(jcols, p)))


def test_single_int_column_goes_to_b1_on_the_cpu(rng, monkeypatch):
    # on a CPU tensor the B1 wrapper runs its plain version; the dispatch
    # itself must reach the wrapper for one INT32/INT64 column only
    calls = []
    real = phash.partition_map
    monkeypatch.setattr(phash, "partition_map", lambda *a: calls.append(a) or real(*a))
    _, pt = _make(rng, ["INT64"], 50, null_cols=(0,))
    phash.hash_partition_map(pt, 16)
    assert len(calls) == 1 and calls[0][2] is pt.columns[0].validity
    _, ps = _make(rng, ["INT16"], 50)
    phash.hash_partition_map(ps, 16)
    phash.hash_partition_map(pt, 16, seed=7)
    assert len(calls) == 1


@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
@pytest.mark.parametrize("p", [7, 16, 200])
def test_partition_map_plain_matches_pallas(rng, np_dt, p):
    info = np.iinfo(np_dt)
    keys = rng.integers(info.min, info.max, 3001, dtype=np_dt, endpoint=True)
    want = np.asarray(pallas_partition_map(jnp.asarray(keys), p, interpret=True))
    got = hk.partition_map_plain(torch.from_numpy(keys), p)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(hk.partition_map(torch.from_numpy(keys), p).numpy(), want)


@pytest.mark.parametrize("np_dt,name", [(np.int32, "INT32"), (np.int64, "INT64")])
def test_partition_map_plain_nulls_take_the_seed(rng, np_dt, name):
    keys = rng.integers(-1000, 1000, 500).astype(np_dt)
    valid = rng.random(500) < 0.6
    col = JColumn(getattr(jdt, name), data=jnp.asarray(keys), validity=jnp.asarray(valid))
    want = np.asarray(jhash.hash_partition_map([col], 200))
    got = hk.partition_map_plain(torch.from_numpy(keys), 200, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~valid] == 42).all()


def test_partition_map_rejects_other_widths():
    with pytest.raises(ValueError):
        pallas_partition_map(jnp.zeros(4, jnp.int16), 7, interpret=True)
    with pytest.raises(ValueError):
        hk.partition_map(torch.zeros(4, dtype=torch.int16), 7)
    with pytest.raises(ValueError):
        hk.partition_map_plain(torch.zeros(4, dtype=torch.float32), 7)
    with pytest.raises(ValueError):
        hk.partition_map(torch.zeros(4, dtype=torch.int32), 0)


@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_partition_map_empty(np_dt):
    # an empty tensor made from numpy carries stride 0
    keys = torch.from_numpy(np.zeros(0, np_dt))
    assert hk.partition_map(keys, 7).shape == (0,)
    assert hk.partition_map(keys, 7, torch.zeros(0, dtype=torch.bool)).shape == (0,)


# -- the shuffle write --------------------------------------------------------


@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "s"]])
@pytest.mark.parametrize("p", [1, 8, 200])
def test_hash_partition_matches_jax(rng, keys, p):
    names = ["INT32", "STRING", "FLOAT64", "DECIMAL128", "INT64"]
    jcols, pt = _make(rng, names, 257, null_cols=(0, 1, 3))
    cols = ["k", "s", "f", "d", "x"]
    pt.names = cols
    jt = JTable(jcols, cols)
    jout, joffs = jshuffle.hash_partition(jt, p, keys)
    pout, poffs = pshuffle.hash_partition(pt, p, keys)
    assert poffs == [int(x) for x in joffs]
    assert pout.names == jout.names
    arrays, valids = table_to_numpy(pout)
    for c, a, v in zip(jout.columns, arrays, valids):
        np.testing.assert_array_equal(np.asarray(c.valid_mask()),
                                      np.ones(pout.num_rows, bool) if v is None else v)
        if c.dtype.id == jdt.TypeId.STRING:
            np.testing.assert_array_equal(a[0], np.asarray(c.offsets))
            np.testing.assert_array_equal(a[1], np.asarray(c.chars))
        else:
            np.testing.assert_array_equal(a.view(np.uint8), np.asarray(c.data).view(np.uint8))
