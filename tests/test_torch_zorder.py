"""Port: ops/zorder (Delta's interleaveBits) against the JAX package's.
INT8, INT16, INT32, INT64 and DECIMAL128 columns, 1 to 5 of them, seeded
values with the type's extremes, nulls (read as 0), the zero-column case
and the rejections run through both packages; the offsets and bytes must
be equal exactly (tolerance 0), and both equal the numpy transcription of
Delta's loop that ``chip_smoke.py`` checks the card with."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import zorder as JZ

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import zorder as PZ

import chip_smoke

N = 29
WIDTH = {"INT8": 8, "INT16": 16, "INT32": 32, "INT64": 64, "DECIMAL128": 128}


def _host(tn: str, rng) -> np.ndarray:
    if tn == "DECIMAL128":
        a = rng.integers(0, 2**32, (N, 4), dtype=np.uint32)
        a[0], a[1] = 0, 0xFFFFFFFF
        a[2] = [0, 0, 0, 0x80000000]
        return a
    t = np.dtype(tn.lower())
    info = np.iinfo(t)
    a = rng.integers(info.min, info.max, N, dtype=t, endpoint=True)
    a[:3] = [info.min, info.max, -1]
    return a


def _limbs(a: np.ndarray, valid) -> np.ndarray:
    """The column's [N, L] uint32 limbs of the value bits, nulls 0."""
    if a.ndim == 2:
        limbs = a.astype(np.uint32)
    elif a.dtype.itemsize == 8:
        limbs = a.view(np.uint32).reshape(-1, 2)
    else:
        limbs = (a.astype(np.int64) & ((1 << (8 * a.dtype.itemsize)) - 1)).astype(np.uint32)[:, None]
    return np.where(np.asarray(valid)[:, None], limbs, 0) if valid is not None else limbs


def _run(tn: str, ncols: int, with_nulls: bool, seed: int):
    rng = np.random.default_rng(seed)
    arrays = [_host(tn, rng) for _ in range(ncols)]
    valids = [rng.random(N) < 0.8 if with_nulls and i % 2 == 0 else None for i in range(ncols)]
    d = pdt.decimal128(-2) if tn == "DECIMAL128" else getattr(pdt, tn)
    jd = jdt.decimal128(-2) if tn == "DECIMAL128" else getattr(jdt, tn)
    pcols = carry_table(arrays, [d] * ncols, valids, device="cpu").columns
    jcols = [JColumn(jd, data=jnp.asarray(a), validity=None if v is None else jnp.asarray(v))
             for a, v in zip(arrays, valids)]
    got = PZ.interleave_bits(N, *pcols)
    want = JZ.interleave_bits(N, *jcols)
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    np.testing.assert_array_equal(got.child.data.numpy(), np.asarray(want.child.data))
    oracle = chip_smoke._zorder_oracle([_limbs(a, v) for a, v in zip(arrays, valids)], WIDTH[tn])
    np.testing.assert_array_equal(got.child.data.numpy().reshape(N, -1), oracle)
    assert got.child.dtype.id == pdt.TypeId.UINT8 and got.dtype.id == pdt.TypeId.LIST


@pytest.mark.parametrize("tn", sorted(WIDTH))
@pytest.mark.parametrize("ncols", [1, 2, 3, 5])
def test_interleave_matches_jax_and_delta(tn, ncols):
    _run(tn, ncols, with_nulls=False, seed=ncols)


@pytest.mark.parametrize("tn", ["INT32", "INT64", "DECIMAL128"])
def test_interleave_with_nulls(tn):
    _run(tn, 3, with_nulls=True, seed=99)


def test_interleave_four_int64_columns():
    _run("INT64", 4, with_nulls=True, seed=4)


def test_interleave_table():
    rng = np.random.default_rng(5)
    t = carry_table([_host("INT16", rng), _host("INT16", rng)], [pdt.INT16] * 2, device="cpu")
    a = PZ.interleave_bits_table(t)
    b = PZ.interleave_bits(N, *t.columns)
    assert torch.equal(a.child.data, b.child.data) and torch.equal(a.offsets, b.offsets)


def test_zero_columns():
    got = PZ.interleave_bits(4, device="cpu")
    want = JZ.interleave_bits(4)
    assert len(got) == 4
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    assert got.child.data.numel() == 0


def test_zero_columns_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PZ.interleave_bits(4)


def test_mixed_types_rejected():
    a = Column.from_pylist([1], pdt.INT32, device="cpu")
    b = Column.from_pylist([1], pdt.INT16, device="cpu")
    with pytest.raises(ValueError, match="same type"):
        PZ.interleave_bits(1, a, b)


def test_non_fixed_width_rejected():
    s = Column.from_pylist(["x"], pdt.STRING, device="cpu")
    with pytest.raises(ValueError, match="fixed width"):
        PZ.interleave_bits(1, s)


def test_too_large_rejected():
    big = Column(pdt.INT64, data=torch.zeros((1,), dtype=torch.int64))
    big.data = big.data.expand(2**27)  # 2^27 rows x 8 B x 2 columns = 2 GiB
    with pytest.raises(ValueError, match="too large"):
        PZ.interleave_bits(2**27, big, big)
