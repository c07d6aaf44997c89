"""Port: the equi-join tier (spark_rapids_jni_tpu_torch.ops.join over
ops.paged_join and B4's plain version) against the JAX package on the
same seeded inputs: here the paged table's build and the probe, exact
(meta, r_order and sizes; the probe's (lo, eq)). The gather maps are in
``test_torch_join_maps.py``, the joined tables and the slice as a whole
in ``test_torch_join_tables.py``; both take their inputs and checks from
here.

The JAX probe runs its Pallas body in interpret mode (``interpret=True``,
or ``SRJT_PALLAS_INTERPRET=1`` for the join entry points); with
``SRJT_PALLAS_JOIN=0`` the JAX join takes its sort-probe formulation.
Both knobs are set through ``monkeypatch.setenv`` and read live by the
JAX package."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops.pallas_kernels import build_paged_table as jbuild
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_probe_paged

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.ops import paged_join as pj

INT_NAMES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64"]
_TORCH_VIEW = {np.dtype(np.uint16): (np.int16, torch.uint16),
               np.dtype(np.uint32): (np.int32, torch.uint32),
               np.dtype(np.uint64): (np.int64, torch.uint64)}


def _tkeys(a: np.ndarray) -> torch.Tensor:
    """numpy integer keys -> a torch tensor whose type carries their
    signedness (wide unsigned keys as an unsigned view)."""
    if a.dtype in _TORCH_VIEW:
        signed, view = _TORCH_VIEW[a.dtype]
        return torch.from_numpy(a.view(signed)).view(view)
    return torch.from_numpy(a)


def _keys(rng, np_dt, n, pool=None):
    info = np.iinfo(np_dt)
    if pool is None:
        return rng.integers(info.min, info.max, n, dtype=np_dt, endpoint=True)
    vals = rng.integers(info.min, info.max, pool, dtype=np_dt, endpoint=True)
    return vals[rng.integers(0, pool, n)]


def _strings(rng, n, valid, pool=None):
    words = [rng.integers(97, 123, rng.integers(1, 9), dtype=np.uint8).tobytes()
             for _ in range(pool or n)]
    enc = [words[i] for i in rng.integers(0, len(words), n)] if pool else words
    if valid is not None:
        enc = [e if ok else b"" for e, ok in zip(enc, valid)]
    offs = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(np.int32)
    return offs, np.frombuffer(b"".join(enc), np.uint8).copy()


def _tables(specs, n):
    """specs: [(name, type name, numpy array or (offsets, chars), validity
    or None)] -> (JAX Table, port Table on the CPU)."""
    jcols, arrays, valids, pd = [], [], [], []
    for _name, tn, a, v in specs:
        d = jdt.decimal128(-2) if tn == "DECIMAL128" else getattr(jdt, tn)
        jv = None if v is None else jnp.asarray(v)
        if tn == "STRING":
            jcols.append(JColumn.strings_from_parts(a[0], a[1], validity=jv))
        else:
            jcols.append(JColumn(d, data=jnp.asarray(a), validity=jv))
        arrays.append(a)
        valids.append(v)
        pd.append(pdt.decimal128(-2) if tn == "DECIMAL128" else getattr(pdt, tn))
    names = [s[0] for s in specs]
    pt = carry_table(arrays, pd, valids, device="cpu")
    return JTable(jcols, names), Table(pt.columns, names)


def _assert_tables_equal(pt: Table, jt: JTable):
    arrays, valids = table_to_numpy(pt)
    assert pt.names == jt.names and pt.num_rows == jt.num_rows
    for c, a, v in zip(jt.columns, arrays, valids):
        want_v = np.asarray(c.valid_mask())
        np.testing.assert_array_equal(np.ones(len(want_v), bool) if v is None else v, want_v)
        if c.dtype.id == jdt.TypeId.STRING:
            np.testing.assert_array_equal(a[0], np.asarray(c.offsets))
            np.testing.assert_array_equal(a[1], np.asarray(c.chars))
        else:
            np.testing.assert_array_equal(a.view(np.uint8), np.asarray(c.data).view(np.uint8))


def _assert_maps_equal(got, want):
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _assert_table_equal_to_ref(port_tab, jax_tab):
    if jax_tab is None:
        assert port_tab is None
        return
    assert port_tab is not None
    for f in ("num_buckets", "n_pages", "nlimb", "c_max", "nm"):
        assert getattr(port_tab, f) == getattr(jax_tab, f), f
    np.testing.assert_array_equal(port_tab.meta.numpy(), np.asarray(jax_tab.meta))
    np.testing.assert_array_equal(port_tab.r_order.numpy(), np.asarray(jax_tab.r_order))


def _key_tables(rng, name, nl, nr, lnull=0.0, rnull=0.0, pool=40):
    np_dt = getattr(jdt, name).np_dtype
    keys = _keys(rng, np_dt, pool)
    lk, rk = keys[rng.integers(0, pool, nl)], keys[rng.integers(0, pool, nr)]
    lv = rng.random(nl) >= lnull if lnull else None
    rv = rng.random(nr) >= rnull if rnull else None
    jl, pl = _tables([("k", name, lk, lv)], nl)
    jr, pr = _tables([("k", name, rk, rv)], nr)
    return jl, pl, jr, pr


# -- the paged table build ----------------------------------------------------------


@pytest.mark.parametrize("name", INT_NAMES)
@pytest.mark.parametrize("nulls", [False, True])
def test_build_matches_reference(rng, name, nulls):
    np_dt = getattr(jdt, name).np_dtype
    keys = _keys(rng, np_dt, 3000, pool=1500)
    valid = rng.random(3000) < 0.8 if nulls else None
    want = jbuild(jnp.asarray(keys), None if valid is None else jnp.asarray(valid))
    got = pj.build_paged_table(_tkeys(keys), None if valid is None else torch.from_numpy(valid))
    _assert_table_equal_to_ref(got, want)
    # the slots hold the order words: each bucket's occupied range is
    # sorted, and together they are the build side's valid keys
    u = pj.compare_form(got.slots)
    page_first, _, start = pj.unpack_meta(got.meta)
    for b in range(got.num_buckets):
        s = u[page_first[b] * pj.PAGE: page_first[b] * pj.PAGE + got.counts[b]]
        assert torch.equal(s, torch.sort(s).values)
    assert int(got.counts.sum()) == got.nm


@pytest.mark.parametrize("n", [1, 17, 1024, 1025, 4097, 65536])
def test_build_sizes(rng, n):
    # the bucket count loop at its steps, up to the build cap
    keys = rng.integers(-2**40, 2**40, n)
    _assert_table_equal_to_ref(pj.build_paged_table(torch.from_numpy(keys)),
                               jbuild(jnp.asarray(keys)))


@pytest.mark.parametrize("case", ["empty", "all_null", "over_cap"])
def test_build_gates(rng, case):
    n = {"empty": 0, "all_null": 300, "over_cap": 65537}[case]
    keys = rng.integers(0, 1000, n).astype(np.int32)
    valid = np.zeros(n, bool) if case == "all_null" else None
    jv = None if valid is None else jnp.asarray(valid)
    assert jbuild(jnp.asarray(keys), jv) is None
    assert pj.build_paged_table(torch.from_numpy(keys),
                                None if valid is None else torch.from_numpy(valid)) is None


def test_build_all_overflow_skew():
    keys = np.full(2000, 7, np.int64)
    got = pj.build_paged_table(torch.from_numpy(keys))
    _assert_table_equal_to_ref(got, jbuild(jnp.asarray(keys)))
    assert got.c_max >= 16


# -- B4: the probe ------------------------------------------------------------------


def _probe_both(lk, lvalid, rk, rvalid):
    jt = jbuild(jnp.asarray(rk), None if rvalid is None else jnp.asarray(rvalid))
    pt = pj.build_paged_table(_tkeys(rk), None if rvalid is None else torch.from_numpy(rvalid))
    jlo, jeq = pallas_probe_paged(jnp.asarray(lk), None if lvalid is None else jnp.asarray(lvalid),
                                  jt, interpret=True)
    lv = None if lvalid is None else torch.from_numpy(lvalid)
    plo, peq = hk.probe_paged_plain(_tkeys(lk), lv, pt)
    assert plo.dtype == torch.int32 and peq.dtype == torch.int32
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))  # null rows included
    np.testing.assert_array_equal(peq.numpy(), np.asarray(jeq))
    wlo, weq = hk.probe_paged(_tkeys(lk), lv, pt)  # the wrapper on CPU tensors
    assert torch.equal(wlo, plo) and torch.equal(weq, peq)
    return peq


@pytest.mark.parametrize("name", ["INT8", "INT32", "INT64", "UINT32"])
@pytest.mark.parametrize("nulls", [False, True])
def test_probe_matches_pallas(rng, name, nulls):
    np_dt = getattr(jdt, name).np_dtype
    rk = _keys(rng, np_dt, 700, pool=300)
    lk = np.concatenate([rk[rng.integers(0, 700, 700)], _keys(rng, np_dt, 300)])
    lvalid = rng.random(1000) < 0.7 if nulls else None
    rvalid = rng.random(700) < 0.7 if nulls else None
    eq = _probe_both(lk, lvalid, rk, rvalid)
    assert int(eq.sum()) > 0


def test_probe_negative_keys(rng):
    rk = rng.integers(-50, 0, 900).astype(np.int64)
    lk = rng.integers(-60, 10, 1200).astype(np.int64)
    _probe_both(lk, None, rk, None)


def test_probe_all_overflow_skew():
    rk = np.full(2000, 7, np.int64)
    lk = np.asarray([7] * 60 + [3] * 5 + [8] * 3, np.int64)
    eq = _probe_both(lk, np.arange(68) % 11 != 0, rk, None)
    assert eq.numpy()[:60][np.arange(60) % 11 != 0].tolist() == [2000] * 54


def test_probe_rejects_width_mismatch(rng):
    tab = pj.build_paged_table(torch.arange(100, dtype=torch.int64))
    with pytest.raises(ValueError, match="width"):
        hk.probe_paged(torch.arange(10, dtype=torch.int32), None, tab)


def test_a_probe_failure_propagates(rng, monkeypatch):
    # no fallback: an error from B4 is the join's error
    def refuse(*args):
        raise RuntimeError("CUDA launch of probe_paged failed: cudaError 9")

    monkeypatch.setattr(pjoin, "probe_paged", refuse)
    _, pl, _, pr = _key_tables(rng, "INT32", 50, 30)
    with pytest.raises(RuntimeError, match="probe_paged"):
        pjoin.join_gather_maps(pl, pr, "inner")
    with pytest.raises(RuntimeError, match="probe_paged"):
        pjoin.left_join(Table(pl.columns, ["k"]), Table(pr.columns, ["k"]), ["k"])
