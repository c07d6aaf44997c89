"""Port: the equi-join tier (spark_rapids_jni_tpu_torch.ops.join over
ops.paged_join and B4's plain version) against the JAX package on the
same seeded inputs, and the slice as a whole (hash_partition ->
inner_join -> groupby_sum_bounded).

Exact: the paged table's meta, r_order and sizes, the probe's (lo, eq),
gather maps, joined tables and counts. The slice's float32 sums are held
to rtol 2e-6 / atol 1e-3 (the reference's bound for its group-by kernel,
tests/test_pallas_kernels.py), since the port adds in another order.

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
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.ops.pallas_kernels import build_paged_table as jbuild
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_probe_paged
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.ops import paged_join as pj
from spark_rapids_jni_tpu_torch.parallel import shuffle as pshuffle

RTOL, ATOL = 2e-6, 1e-3

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


# -- gather maps ------------------------------------------------------------------------


def _key_tables(rng, name, nl, nr, lnull=0.0, rnull=0.0, pool=40):
    np_dt = getattr(jdt, name).np_dtype
    keys = _keys(rng, np_dt, pool)
    lk, rk = keys[rng.integers(0, pool, nl)], keys[rng.integers(0, pool, nr)]
    lv = rng.random(nl) >= lnull if lnull else None
    rv = rng.random(nr) >= rnull if rnull else None
    jl, pl = _tables([("k", name, lk, lv)], nl)
    jr, pr = _tables([("k", name, rk, rv)], nr)
    return jl, pl, jr, pr


@pytest.mark.parametrize("name", ["INT32", "INT64", "UINT16"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_maps_match_the_pallas_tier(rng, name, how, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_INTERPRET", "1")
    jl, pl, jr, pr = _key_tables(rng, name, 600, 300, lnull=0.2, rnull=0.2)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


@pytest.mark.parametrize("name", ["INT8", "INT64", "UINT64"])
@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("nulls", [0.0, 0.4])
def test_join_maps_match_the_sort_probe(rng, name, how, nulls, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_JOIN", "0")
    jl, pl, jr, pr = _key_tables(rng, name, 500, 400, lnull=nulls, rnull=nulls)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


def test_inner_and_left_take_the_paged_table(rng, monkeypatch):
    calls = []
    real = pjoin.probe_paged
    monkeypatch.setattr(pjoin, "probe_paged", lambda *a: calls.append(1) or real(*a))
    _, pl, _, pr = _key_tables(rng, "INT32", 50, 30)
    for how in ("inner", "left", "full"):
        pjoin.join_gather_maps(pl, pr, how)
    assert len(calls) == 2  # not the full join
    _, sl, _, sr = _key_tables(rng, "INT64", 50, 30)
    pjoin.join_gather_maps(pl, sr, "inner")  # mismatched key types
    pjoin.join_gather_maps(Table(pl.columns * 2, ["a", "b"]), Table(pr.columns * 2, ["a", "b"]))
    assert len(calls) == 2


@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("case", ["empty_left", "empty_right", "both_empty", "all_null_build",
                                  "over_cap"])
def test_join_maps_edge_cases(rng, how, case, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_INTERPRET", "1")
    nl, nr = {"empty_left": (0, 50), "empty_right": (60, 0), "both_empty": (0, 0),
              "all_null_build": (70, 40), "over_cap": (300, 65537)}[case]
    lk = rng.integers(0, 100, nl).astype(np.int64)
    rk = rng.integers(0, 100, nr).astype(np.int64)
    rv = np.zeros(nr, bool) if case == "all_null_build" else None
    jl, pl = _tables([("k", "INT64", lk, None)], nl)
    jr, pr = _tables([("k", "INT64", rk, rv)], nr)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_maps_multi_key(rng, how):
    n = 400
    specs = lambda k0, k1, v: [("a", "INT32", k0, v), ("s", "STRING", k1, None)]  # noqa: E731
    a0 = rng.integers(0, 6, n).astype(np.int32)
    b0 = rng.integers(0, 6, n).astype(np.int32)
    s = _strings(rng, 2 * n, None, pool=5)
    sl = (s[0][: n + 1], s[1][: s[0][n]])
    sr = ((s[0][n:] - s[0][n]).astype(np.int32), s[1][s[0][n]:])
    jl, pl = _tables(specs(a0, sl, rng.random(n) < 0.9), n)
    jr, pr = _tables(specs(b0, sr, None), n)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


def test_long_string_keys_follow_the_reference():
    # a fault of the reference, recorded and kept for parity: the key
    # factorization compares STRING keys by length and 16-byte prefix
    # only, so two keys that differ past byte 16 match
    strs = [b"abcdefghijklmnopX", b"abcdefghijklmnopY"]
    offs = np.array([0, 17], np.int32)
    jl, pl = _tables([("k", "STRING", (offs, np.frombuffer(strs[0], np.uint8).copy()), None)], 1)
    jr, pr = _tables([("k", "STRING", (offs, np.frombuffer(strs[1], np.uint8).copy()), None)], 1)
    want = jjoin.join_gather_maps(jl, jr, "inner")
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, "inner"), want)
    assert np.asarray(want[0]).tolist() == [0]


@pytest.mark.parametrize("how", ["semi", "anti"])
@pytest.mark.parametrize("name", ["INT32", "STRING"])
def test_semi_anti_gather_map(rng, how, name):
    if name == "STRING":
        lv = rng.random(300) < 0.8
        jl, pl = _tables([("k", "STRING", _strings(rng, 300, lv, pool=30), lv)], 300)
        jr, pr = _tables([("k", "STRING", _strings(rng, 100, None, pool=30), None)], 100)
    else:
        jl, pl, jr, pr = _key_tables(rng, name, 300, 100, lnull=0.2, rnull=0.2, pool=60)
    got = pjoin.semi_anti_gather_map(pl, pr, how)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jjoin.semi_anti_gather_map(jl, jr, how)))


# -- joined tables ------------------------------------------------------------------------


def _fact_dim(rng, key_type, nl=400, nr=120):
    """A fact side and a dimension side sharing the key column "k"."""
    if key_type == "STRING":
        lkv = rng.random(nl) < 0.9
        lkey = _strings(rng, nl, lkv, pool=80)
        rkey = _strings(rng, nr, None, pool=80)
        rkv = None
    else:
        pool = rng.integers(-500, 500, 80).astype(np.int32)
        lkey, rkey = pool[rng.integers(0, 80, nl)], pool[rng.integers(0, 80, nr)]
        lkv, rkv = rng.random(nl) < 0.9, rng.random(nr) < 0.95
    left = [("k", key_type, lkey, lkv),
            ("qty", "INT32", rng.integers(0, 100, nl).astype(np.int32), rng.random(nl) < 0.9),
            ("price", "FLOAT32", rng.standard_normal(nl).astype(np.float32), None),
            ("amt", "DECIMAL128", rng.integers(0, 2**32, (nl, 4), dtype=np.uint32), None)]
    rv = rng.random(nr) < 0.85
    right = [("brand", "INT32", rng.integers(0, 50, nr).astype(np.int32), None),
             ("k", key_type, rkey, rkv),
             ("name", "STRING", _strings(rng, nr, rv), rv),
             ("f", "FLOAT64", rng.standard_normal(nr).view(np.uint64), None)]
    return _tables(left, nl), _tables(right, nr)


@pytest.mark.parametrize("key_type", ["INT32", "STRING"])
@pytest.mark.parametrize("how", ["inner", "left", "full", "semi", "anti"])
def test_joined_tables(rng, key_type, how, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_INTERPRET", "1")
    (jl, pl), (jr, pr) = _fact_dim(rng, key_type)
    fn = {"inner": "inner_join", "left": "left_join", "full": "full_join",
          "semi": "left_semi_join", "anti": "left_anti_join"}[how]
    _assert_tables_equal(getattr(pjoin, fn)(pl, pr, ["k"]), getattr(jjoin, fn)(jl, jr, ["k"]))


@pytest.mark.parametrize("how", ["inner_join", "left_join", "full_join"])
def test_joined_tables_against_an_empty_side(rng, how):
    (jl, pl), (jr, pr) = _fact_dim(rng, "INT32", nl=50, nr=20)
    empty = np.zeros(0, np.int32)
    je, pe = _tables([("k", "INT32", empty, None), ("x", "INT64", empty.astype(np.int64), None)], 0)
    _assert_tables_equal(getattr(pjoin, how)(pl, pe, ["k"]), getattr(jjoin, how)(jl, je, ["k"]))
    _assert_tables_equal(getattr(pjoin, how)(pe, pr, ["k"]), getattr(jjoin, how)(je, jr, ["k"]))


# -- the slice as a whole ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_shuffle_join_aggregate_slice(seed):
    """hash_partition -> inner_join -> groupby_sum_bounded at ~20K fact
    rows x 2K build rows, the chip path's shape cut to size."""
    rng = np.random.default_rng(seed)
    nf, nd, brands = 20_000, 2_048, 256
    item = rng.integers(0, 4_096, nf).astype(np.int32)
    fv = rng.random(nf) < 0.9
    fact = [("item_sk", "INT32", item, fv),
            ("qty", "INT32", rng.integers(1, 100, nf).astype(np.int32), rng.random(nf) < 0.9),
            ("ext_sales_price", "FLOAT32", (rng.random(nf) * 100).astype(np.float32), None),
            ("store_sk", "INT64", rng.integers(0, 500, nf), None)]
    dv = rng.random(nd) < 0.9
    dim = [("item_sk", "INT32", rng.choice(4_096, nd, replace=False).astype(np.int32), None),
           ("brand_id", "INT32", rng.integers(0, brands, nd).astype(np.int32), None),
           ("brand", "STRING", _strings(rng, nd, dv), dv)]
    jf, pf = _tables(fact, nf)
    jd, pd = _tables(dim, nd)

    jpart, joffs = jshuffle.hash_partition(jf, 200, ["item_sk"])
    ppart, poffs = pshuffle.hash_partition(pf, 200, ["item_sk"])
    assert poffs == [int(x) for x in joffs]
    _assert_tables_equal(ppart, jpart)

    jj = jjoin.inner_join(jpart, jd, ["item_sk"])
    pjn = pjoin.inner_join(ppart, pd, ["item_sk"])
    _assert_tables_equal(pjn, jj)
    assert pjn.num_rows > 1000

    js, jc = jagg.groupby_sum_bounded(jj.column("brand_id").data,
                                      jj.column("ext_sales_price").data, brands)
    ps, pc = pagg.groupby_sum_bounded(pjn.column("brand_id").data,
                                      pjn.column("ext_sales_price").data, brands)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
