"""Port: the ETL -> DMatrix bridge (``spark_rapids_jni_tpu_torch/models/xgboost_bridge.py``)
held against the JAX package's bit for bit: the dense features (nulls as
NaN), the quantile cuts and the bin ids, for ``max_bins`` 2 to 256, over
NaN, all-NaN, infinite, signed-zero and tied inputs, values equal to a
cut, and the column types a feature may have."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as RC, Table as RT, dtype as rdt
from spark_rapids_jni_tpu.models import datagen as rdatagen, xgboost_bridge as rxb
from spark_rapids_jni_tpu_torch.columnar import Column as PC, Table as PT, dtype as pdt
from spark_rapids_jni_tpu_torch.models import datagen as pdatagen, xgboost_bridge as pxb

BINS = (2, 3, 32, 256)


def _bits(a):
    """float32 bits, every NaN as one pattern (payloads are not compared)."""
    a = np.asarray(a, np.float32).copy()
    a[np.isnan(a)] = np.nan
    return a.view(np.uint32)


def _hostile(n=3001, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 7)).astype(np.float32)
    x[rng.random(n) < 0.1, 0] = np.nan
    x[:, 1] = np.round(x[:, 1] * 3)  # heavy ties
    x[:, 2] = np.nan  # all-NaN feature
    x[rng.random(n) < 0.05, 3] = np.inf
    x[rng.random(n) < 0.05, 3] = -np.inf
    x[rng.random(n) < 0.3, 4] = 0.0
    x[rng.random(n) < 0.3, 4] = -0.0
    x[:, 5] = rng.integers(0, 5, n)
    x[:, 6] = np.float32(7.25)  # one value: every cut equals it
    return x


def _both_cuts(x, max_bins):
    rc = np.asarray(rxb.quantile_cuts(jnp.asarray(x), max_bins))
    pc = pxb.quantile_cuts(torch.from_numpy(x), max_bins).numpy()
    return rc, pc


@pytest.mark.parametrize("max_bins", BINS)
def test_cuts_and_bins_bit_identical_on_hostile_features(max_bins):
    x = _hostile()
    rc, pc = _both_cuts(x, max_bins)
    assert pc.shape == rc.shape == (x.shape[1], max_bins - 1)
    assert np.array_equal(rc.view(np.uint32), pc.view(np.uint32))
    assert np.isinf(pc[2]).all() and (pc[2] > 0).all()  # all-NaN -> +inf cuts
    rb = np.asarray(rxb.quantize(jnp.asarray(x), jnp.asarray(rc)))
    pb = pxb.quantize(torch.from_numpy(x), torch.from_numpy(pc)).numpy()
    assert pb.dtype == np.int32 and np.array_equal(rb, pb)
    assert (pb[np.isnan(x)] == max_bins).all()


def test_values_equal_to_a_cut_and_at_infinity():
    """A value equal to a cut lands below it (``v > c`` counts strictly
    lesser cuts); +inf counts every finite cut and no +inf cut; -inf and a
    NaN cut count for nothing."""
    cuts = np.array([[-1.0, 0.0, 0.0, 2.5, np.inf],
                     [np.nan, 1.0, -np.inf, 3.0, 1.0]], np.float32)
    x = np.array([[-1.0, 1.0], [0.0, 3.0], [-0.0, -np.inf], [2.5, np.inf],
                  [np.inf, 0.5], [-np.inf, np.nan], [3.0, 1.0]], np.float32)
    rb = np.asarray(rxb.quantize(jnp.asarray(x), jnp.asarray(cuts)))
    pb = pxb.quantize(torch.from_numpy(x), torch.from_numpy(cuts)).numpy()
    assert np.array_equal(rb, pb)
    assert pb[:, 0].tolist() == [0, 1, 1, 3, 4, 0, 4]
    assert pb[:, 1].tolist() == [1, 3, 0, 4, 1, 6, 1]


def _random_table(mod, dt, **kw):
    return mod.create_random_table([dt.FLOAT64, dt.INT32, dt.FLOAT32, dt.FLOAT64], 500, seed=3,
                                   profiles={1: mod.Profile(null_probability=0.2)},
                                   names=["f0", "f1", "f2", "label"], **kw)


@pytest.mark.parametrize("max_bins", (2, 256))
def test_to_dmatrix_matches_the_reference(max_bins):
    rt = _random_table(rdatagen, rdt)
    pt = _random_table(pdatagen, pdt, device="cpu")
    rd = rxb.to_dmatrix(rt, ["f0", "f1", "f2"], label_col="label", max_bins=max_bins)
    pd = pxb.to_dmatrix(pt, ["f0", "f1", "f2"], label_col="label", max_bins=max_bins)
    assert (pd.num_rows, pd.num_features, pd.feature_names) == (500, 3, ["f0", "f1", "f2"])
    assert pd.features.dtype == torch.float32
    assert np.array_equal(_bits(rd.features), _bits(pd.features.numpy()))
    assert np.array_equal(_bits(rd.labels), _bits(pd.labels.numpy()))
    validity = pt.column("f1").validity.numpy()
    f1 = pd.features[:, 1].numpy()
    assert np.isnan(f1[~validity]).all() and not np.isnan(f1[validity]).any()
    assert np.array_equal(np.asarray(rd.cuts).view(np.uint32), pd.cuts.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(rd.binned), pd.binned.numpy())
    assert int(pd.binned.max()) <= max_bins


def test_feature_column_types_convert_like_the_reference():
    """Integer, unsigned (held in signed lanes by the port), boolean,
    decimal and float columns convert to float32 with the reference's
    rounding, nulls to NaN."""
    rng = np.random.default_rng(5)
    n = 256
    u64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    u64[:4] = [2**64 - 1, 2**63, 2**63 + 2**39 + 1, 2**63 - 1]
    cols = [
        ("INT64", rng.integers(-2**62, 2**62, n), None),
        ("UINT64", u64, rng.random(n) < 0.9),
        ("UINT32", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), None),
        ("UINT16", rng.integers(0, 2**16, n).astype(np.uint16), None),
        ("INT8", rng.integers(-128, 128, n).astype(np.int8), None),
        ("BOOL8", rng.integers(0, 2, n).astype(np.uint8), None),
        ("FLOAT64", rng.normal(size=n).astype(np.float64).view(np.uint64), None),
    ]
    from torch_memgov_sides import PORT, REF

    names = [f"c{i}" for i in range(len(cols))]
    rt, pt = REF.table(cols, names), PORT.table(cols, names)
    rd, pd = rxb.to_dmatrix(rt, names, max_bins=16), pxb.to_dmatrix(pt, names, max_bins=16)
    assert np.array_equal(_bits(rd.features), _bits(pd.features.numpy()))
    assert np.array_equal(np.asarray(rd.binned), pd.binned.numpy())


def test_all_nan_feature_and_string_rejected():
    n = 16
    cols = [PC(pdt.FLOAT32, data=torch.full((n,), float("nan"))),
            PC(pdt.FLOAT32, data=torch.arange(n, dtype=torch.float32))]
    dm = pxb.to_dmatrix(PT(cols, ["dead", "live"]), ["dead", "live"], max_bins=4)
    assert (dm.binned[:, 0] == dm.cuts.shape[1] + 1).all()
    assert torch.isfinite(dm.cuts[1]).all()
    rcols = [RC(rdt.FLOAT32, data=jnp.full((n,), jnp.nan, jnp.float32)),
             RC(rdt.FLOAT32, data=jnp.arange(n, dtype=jnp.float32))]
    rdm = rxb.to_dmatrix(RT(rcols, ["dead", "live"]), ["dead", "live"], max_bins=4)
    assert np.array_equal(np.asarray(rdm.cuts).view(np.uint32), dm.cuts.numpy().view(np.uint32))
    with pytest.raises(ValueError, match="encode string"):
        pxb.to_dmatrix(PT([PC.from_pylist(["a", "b"], pdt.STRING, device="cpu")], ["s"]), ["s"])
    with pytest.raises(ValueError, match="max_bins"):
        pxb.quantile_cuts(torch.zeros((4, 1)), 1)


def test_quantile_cuts_follow_numpy_and_the_empty_table():
    rng = np.random.default_rng(12345)
    x = rng.standard_normal((1000, 3)).astype(np.float32)
    cuts = pxb.quantile_cuts(torch.from_numpy(x), max_bins=16).numpy()
    for f in range(3):
        want = np.quantile(x[:, f], np.linspace(0, 1, 17)[1:-1], method="linear")
        np.testing.assert_allclose(cuts[f], want, rtol=1e-5)
        assert (np.diff(cuts[f]) >= 0).all()
    empty = pxb.quantile_cuts(torch.zeros((0, 2)), 4)
    assert empty.shape == (2, 3) and torch.isinf(empty).all()


def test_fused_multiply_add_matches_the_references_contraction():
    """The reference's compiled ``a + (b - a) * frac`` is one fused
    multiply-add on the CPU; ``_fma_f32`` gives its bits, including sums
    that fall on a float32 rounding midpoint (where a float64 sum rounded
    twice would be off by one)."""
    import jax

    rng = np.random.default_rng(9)
    n = 20_000
    a = rng.normal(size=n).astype(np.float32) * np.float32(100)
    d = rng.normal(size=n).astype(np.float32)
    f = rng.random(n).astype(np.float32)
    # constructed midpoint cases: d * f just above or below half an ulp of a
    a[:2000] = np.float32(1.0) + np.arange(2000, dtype=np.float32) * np.float32(2.0 ** -23)
    d[:2000] = np.float32(2.0 ** -24) * (1 + np.where(np.arange(2000) % 2, 1, -1)
                                          * np.float32(2.0 ** -23)).astype(np.float32)
    f[:2000] = np.float32(1.0) - np.float32(2.0 ** -24) * (np.arange(2000) % 3)
    ref = np.asarray(jax.jit(lambda a, d, f: a + d * f)(jnp.asarray(a), jnp.asarray(d),
                                                        jnp.asarray(f)))
    got = pxb._fma_f32(torch.from_numpy(a), torch.from_numpy(d), torch.from_numpy(f)).numpy()
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))
    # and the plain float32 expression (two roundings) is not it
    plain = (torch.from_numpy(a) + torch.from_numpy(d) * torch.from_numpy(f)).numpy()
    assert not np.array_equal(ref.view(np.uint32), plain.view(np.uint32))
