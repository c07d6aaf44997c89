"""Port: each hand-written CUDA kernel against its plain PyTorch version on
the card. These tests need a CUDA device and skip without one (the
condition is evaluated when each test is set up, not at import). They
import neither jax nor the JAX package, so on a machine with a card they
run without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

B1, B4, B5-B10, the row transcode and the join maps are exact; B3
counts are exact and its float32 sums are held to rtol 2e-6 / atol 1e-3,
the reference's bound, because the kernel's atomics add in an order that
changes from run to run."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import aggregate
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")

RTOL, ATOL = 2e-6, 1e-3


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def _cuda32(rng, shape):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32).view(np.int32)).cuda()


@pytest.mark.parametrize("p,n", [(3, 16), (196, 40), (1, 8), (7, 515), (49, 600), (198, 100_003)])
def test_expand_u32_planes_kernel_matches_plain(rng, p, n):
    x = _cuda32(rng, (p, n))
    before = rb.expand_u32_planes.launches
    got = rb.expand_u32_planes(x)
    torch.cuda.synchronize()
    assert rb.expand_u32_planes.launches == before + 1
    assert torch.equal(got, rb.expand_u32_planes_plain(x))


@pytest.mark.parametrize("p,n", [(3, 16), (196, 40), (1, 8), (7, 515), (49, 600), (198, 100_003)])
def test_pack_u8_planes_kernel_matches_plain(rng, p, n):
    x8 = torch.from_numpy(rng.integers(0, 256, (4 * p, n), dtype=np.uint8)).cuda()
    before = rb.pack_u8_planes.launches
    got = rb.pack_u8_planes(x8)
    torch.cuda.synchronize()
    assert rb.pack_u8_planes.launches == before + 1
    assert torch.equal(got, rb.pack_u8_planes_plain(x8))


def test_plane_kernels_take_unaligned_views(rng):
    # contiguous views that start 4 bytes past an allocation's 16-byte
    # boundary: the kernels must take their scalar path there
    flat = _cuda32(rng, (5 * 1024 + 1,))
    x = flat[1:].view(5, 1024)
    assert x.data_ptr() % 16 != 0
    got = rb.expand_u32_planes(x)
    assert torch.equal(got, rb.expand_u32_planes_plain(x))
    flat8 = torch.from_numpy(rng.integers(0, 256, 20 * 1024 + 1, dtype=np.uint8)).cuda()
    y8 = flat8[1:].view(20, 1024)
    assert torch.equal(rb.pack_u8_planes(y8), rb.pack_u8_planes_plain(y8))


def test_plane_kernels_reject_wrong_types():
    with pytest.raises(ValueError):
        rb.expand_u32_planes(torch.zeros((2, 8), dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError):
        rb.pack_u8_planes(torch.zeros((6, 8), dtype=torch.uint8, device="cuda"))


@pytest.mark.parametrize("n,num_keys", [(5000, 4096), (300, 7), (40000, 130), (2048, 16384),
                                        (3000, 65536), (200_000, 8192), (200_000, 8193)])
def test_groupby_sum_outer_kernel_matches_plain(rng, n, num_keys):
    keys = torch.from_numpy(rng.integers(-5, num_keys + 5, n)).cuda()
    vals = torch.from_numpy((rng.standard_normal(n) * 100).astype(np.float32)).cuda()
    before = hk.groupby_sum_outer.launches
    gs, gc = hk.groupby_sum_outer(keys, vals, num_keys)
    torch.cuda.synchronize()
    assert hk.groupby_sum_outer.launches == before + 1
    ws, wc = hk.groupby_sum_outer_plain(keys, vals, num_keys)
    assert gs.dtype == torch.float32 and gc.dtype == torch.int64
    assert torch.equal(gc, wc)
    torch.testing.assert_close(gs, ws, rtol=RTOL, atol=ATOL)


def test_groupby_keys_past_2_32_drop_on_the_card():
    keys = torch.tensor([0, 1, 2**32, -3, 2**32 + 1, 2**40], dtype=torch.int64, device="cuda")
    vals = torch.tensor([1.0, 2.0, 100.0, 200.0, 300.0, 400.0], device="cuda")
    s, c = hk.groupby_sum_outer(keys, vals, 4)
    assert c.tolist() == [1, 1, 0, 0] and s.tolist() == [1.0, 2.0, 0.0, 0.0]


def test_groupby_empty_input_launches_nothing():
    before = hk.groupby_sum_outer.launches
    s, c = hk.groupby_sum_outer(torch.zeros(0, dtype=torch.int64, device="cuda"),
                                torch.zeros(0, device="cuda"), 16)
    assert hk.groupby_sum_outer.launches == before
    assert int(c.sum()) == 0 and float(s.abs().sum()) == 0.0


def test_slice_on_the_card_matches_the_cpu(rng):
    nine = [pdt.INT8, pdt.INT16, pdt.INT32, pdt.INT64, pdt.UINT8, pdt.UINT16, pdt.UINT32,
            pdt.UINT64, pdt.BOOL8]
    dtypes = [pdt.INT64, pdt.FLOAT32] + nine + [pdt.FLOAT64, pdt.decimal128(-2)]
    n = 3001
    arrays = [rng.integers(0, 512, n), rng.standard_normal(n).astype(np.float32)]
    for d in nine:
        info = np.iinfo(d.np_dtype)
        hi = 1 if d.id == pdt.TypeId.BOOL8 else info.max
        arrays.append(rng.integers(info.min, hi, n, dtype=d.np_dtype, endpoint=True))
    arrays += [rng.standard_normal(n), rng.integers(0, 2**32, (n, 4), dtype=np.uint32)]
    valids = [rng.random(n) < 0.8 if i % 3 == 2 else None for i in range(len(dtypes))]
    out = {}
    for dev in ("cpu", "cuda"):
        t = Table.from_numpy(arrays, dtypes, valids, device=dev)
        rows = rc.convert_to_rows(t)
        dec = rc.convert_from_rows(rows[0], dtypes)
        s, c = aggregate.groupby_sum_bounded(dec.columns[0].data, dec.columns[1].data, 512)
        out[dev] = (rows[0].child.data.cpu(), [x.to_numpy() for x in dec.columns],
                    [x.valid_mask().cpu() for x in dec.columns], s.cpu(), c.cpu())
    (b0, d0, v0, s0, c0), (b1, d1, v1, s1, c1) = out["cpu"], out["cuda"]
    assert torch.equal(b0, b1)
    for x, y in zip(d0, d1):
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
    for x, y in zip(v0, v1):
        assert torch.equal(x, y)
    assert torch.equal(c0, c1)
    torch.testing.assert_close(s0, s1, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# string kernels: B8, B9, B10, B5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,w,out_w", [(1, 8, 4), (37, 8, 8), (1001, 64, 32), (513, 2048, 1024),
                                       (7, 256, 128), (300, 12, 12)])
def test_rotl_take_kernel_matches_plain(rng, n, w, out_w):
    x = torch.from_numpy(rng.integers(0, 256, (n, w), dtype=np.uint8)).cuda()
    sh = torch.from_numpy(rng.integers(0, w, n).astype(np.int32)).cuda()
    sh[0] = 0
    before = rb.rotl_take.launches
    got = rb.rotl_take(x, sh, out_w)
    torch.cuda.synchronize()
    assert rb.rotl_take.launches == before + 1
    assert torch.equal(got, rb.rotl_take_plain(rb._as_u32(x), sh, out_w))
    got32 = rb.rotl_take32(rb._as_u32(x), sh.to(torch.int64), out_w)
    assert rb.rotl_take.launches == before + 2
    assert torch.equal(got32, got)


def test_rotl_take_kernel_takes_an_unaligned_byte_view(rng):
    flat = torch.from_numpy(rng.integers(0, 256, 64 * 33 + 1, dtype=np.uint8)).cuda()
    x = flat[1:].view(33, 64)  # starts one byte past a word
    sh = torch.from_numpy(rng.integers(0, 64, 33).astype(np.int32)).cuda()
    assert torch.equal(rb.rotl_take(x, sh, 32), rb.rotl_take_plain(rb._as_u32(x), sh, 32))


@pytest.mark.parametrize("n,widths,maxvar,tail", [(1, (4,), 4, False), (1001, (16, 32), 96, False),
                                                  (333, (4, 32, 32), 128, True),
                                                  (4097, (32,) * 16, 576, True)])
def test_var_accumulate_kernel_matches_plain(rng, n, widths, maxvar, tail):
    mats, shifts = [], []
    at = np.full(n, 3 if tail else 0)
    if tail:
        mats.append(rng.integers(0, 256, (n, 4), dtype=np.uint8))
        mats[-1][:, 3] = 0
        shifts.append(np.zeros(n, np.int32))
    for w in widths:
        lens = rng.integers(0, w + 1, n)
        m = rng.integers(0, 256, (n, w), dtype=np.uint8)
        m[np.arange(w)[None, :] >= lens[:, None]] = 0
        mats.append(m)
        shifts.append(at.astype(np.int32))
        at = at + lens
    shifts[-1][: min(n, 3)] = maxvar + 1  # shifts past the section clear the row
    pm = [torch.from_numpy(m).cuda() for m in mats]
    ps = [torch.from_numpy(s).cuda() for s in shifts]
    before = rb.var_accumulate.launches
    got = rb.var_accumulate(pm, ps, maxvar)
    torch.cuda.synchronize()
    assert rb.var_accumulate.launches == before + 1
    assert torch.equal(got, rb.var_accumulate_plain(pm, ps, maxvar))


@pytest.mark.parametrize("t,g", [(1, 8), (999, 8), (5001, 64), (2049, 256)])
def test_asm_epilogue_kernel_matches_plain(rng, t, g):
    tiles = [torch.from_numpy(rng.integers(0, 2**32, (t, g // 4), dtype=np.uint32).view(np.int32)).cuda()
             for _ in range(3)]
    pmod = torch.from_numpy(rng.integers(0, 2 * g, t).astype(np.int32)).cuda()
    delta = torch.from_numpy(rng.integers(0, g + 9, t).astype(np.int32)).cuda()
    alen = torch.from_numpy(rng.integers(0, g + 1, t).astype(np.int32)).cuda()  # not word multiples
    before = rb.asm_epilogue.launches
    got = rb.asm_epilogue(*tiles, pmod, delta, alen, g)
    torch.cuda.synchronize()
    assert rb.asm_epilogue.launches == before + 1
    assert torch.equal(got, rb.asm_epilogue_plain(*tiles, pmod, delta, alen, g))


def _ragged(rng, n, max_len, gap, null_frac, tail):
    lens = rng.integers(0, max_len + 1, n)
    lens[rng.random(n) < null_frac] = 0
    gaps = rng.integers(0, gap + 1, n)
    base = np.cumsum(np.concatenate([[0], (lens + gaps)[:-1]]))
    pool = rng.integers(1, 256, int(base[-1] + lens[-1]) + tail).astype(np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)])
    return (torch.from_numpy(pool).cuda(), torch.from_numpy(base.astype(np.int64)).cuda(),
            torch.from_numpy(offs.astype(np.int64)).cuda(), int(offs[-1]))


# (rows, max length, gap, null share, pool bytes past the last string):
# a pool that ends mid-word right after the last string, zero-length rows,
# many short rows sharing words, one giant row, unaligned N
@pytest.mark.parametrize("n,max_len,gap,null_frac,tail", [
    (1, 4097, 0, 0.0, 0), (1001, 3, 0, 0.0, 0), (777, 32, 7, 0.5, 1), (30001, 32, 40, 0.1, 3),
    (5, 0, 3, 0.0, 2), (200_003, 13, 0, 0.9, 0)])
def test_ragged_compact_kernel_matches_plain(rng, n, max_len, gap, null_frac, tail):
    pool, base, offs, total = _ragged(rng, n, max_len, gap, null_frac, tail)
    before = hk.ragged_compact.launches
    got = hk.ragged_compact(pool, base, offs, total)
    torch.cuda.synchronize()
    assert hk.ragged_compact.launches == before + (1 if total else 0)
    want = hk.ragged_compact_plain(pool, base, offs, total)
    assert got.dtype == torch.uint8 and got.shape == (total,)
    assert torch.equal(got, want)


def test_string_slice_on_the_card_matches_the_cpu(rng):
    names = ["STRING" if i % 10 == 0 else [pdt.INT32, pdt.FLOAT64, pdt.INT64, pdt.INT16][i % 4]
             for i in range(35)]
    dtypes = [pdt.STRING if d == "STRING" else d for d in names]
    dtypes[1], dtypes[2] = pdt.FLOAT32, pdt.INT64
    n = 5003
    arrays, valids = [], []
    for i, d in enumerate(dtypes):
        v = rng.random(n) < 0.8 if i % 5 == 0 else None
        if d.id == pdt.TypeId.STRING:
            lens = rng.integers(1, 33, n) * (v if v is not None else 1)
            offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
            arrays.append((offs, rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)))
        elif i == 1:
            arrays.append(rng.standard_normal(n).astype(np.float32))
        elif i == 2:
            arrays.append(rng.integers(0, 512, n))
        elif d.id == pdt.TypeId.FLOAT64:
            arrays.append(rng.standard_normal(n))
        else:
            info = np.iinfo(d.np_dtype)
            arrays.append(rng.integers(info.min, info.max, n, dtype=d.np_dtype, endpoint=True))
        valids.append(v)
    from spark_rapids_jni_tpu_torch.interop import carry_table

    counts = {k: 0 for k in ("rotl", "vacc", "asm", "compact")}
    out = {}
    for dev in ("cpu", "cuda"):
        before = (rb.rotl_take.launches, rb.var_accumulate.launches, rb.asm_epilogue.launches,
                  hk.ragged_compact.launches)
        t = carry_table(arrays, dtypes, valids, device=dev)
        rows = rc.convert_to_rows(t)
        dec = rc.convert_from_rows(rows[0], dtypes)
        s, c = aggregate.groupby_sum_bounded(dec.columns[2].data, dec.columns[1].data, 512)
        after = (rb.rotl_take.launches, rb.var_accumulate.launches, rb.asm_epilogue.launches,
                 hk.ragged_compact.launches)
        for k, b, a in zip(counts, before, after):
            counts[k] = a - b
        out[dev] = (rows[0], dec, s.cpu(), c.cpu())
    assert all(v > 0 for v in counts.values()), counts  # the card run launched each kernel
    (r0, d0, s0, c0), (r1, d1, s1, c1) = out["cpu"], out["cuda"]
    assert torch.equal(r0.child.data, r1.child.data.cpu())
    assert torch.equal(r0.offsets, r1.offsets.cpu())
    for a, b in zip(d0.columns, d1.columns):
        assert torch.equal(a.valid_mask(), b.valid_mask().cpu())
        if a.dtype.id == pdt.TypeId.STRING:
            assert torch.equal(a.offsets, b.offsets.cpu()) and torch.equal(a.chars, b.chars.cpu())
        else:
            np.testing.assert_array_equal(a.to_numpy().view(np.uint8), b.to_numpy().view(np.uint8))
    assert torch.equal(c0, c1)
    torch.testing.assert_close(s0, s1, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the join path: B1 (partition_map) and B4 (probe_paged)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 100_003])
@pytest.mark.parametrize("p", [1, 7, 200])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
@pytest.mark.parametrize("nulls", [False, True])
def test_partition_map_kernel_matches_plain(rng, n, p, np_dt, nulls):
    info = np.iinfo(np_dt)
    keys = torch.from_numpy(rng.integers(info.min, info.max, n, dtype=np_dt, endpoint=True)).cuda()
    valid = torch.from_numpy(rng.random(n) < 0.7).cuda() if nulls else None
    before = hk.partition_map.launches
    got = hk.partition_map(keys, p, valid)
    torch.cuda.synchronize()
    assert hk.partition_map.launches == before + (1 if n else 0)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, hk.partition_map_plain(keys, p, valid))
    assert torch.equal(got.cpu(), hk.partition_map_plain(keys.cpu(), p,
                                                         None if valid is None else valid.cpu()))


def _probe_case(rng, case, np_dt):
    from spark_rapids_jni_tpu_torch.ops import paged_join as pj

    info = np.iinfo(np_dt)
    if case == "skew":
        rk = np.full(2000, 7, np_dt)
        lk = np.asarray([7] * 600 + [3] * 50, np_dt)
    else:
        pool = rng.integers(info.min, info.max, 3000, dtype=np_dt, endpoint=True)
        rk = pool[rng.integers(0, 3000, 40_000 if case == "random" else 5000)]
        lk = np.concatenate([pool[rng.integers(0, 3000, 200_000)],
                             rng.integers(info.min, info.max, 50_000, dtype=np_dt)])
    heavy = case == "null_heavy"
    rv = torch.from_numpy(rng.random(rk.shape[0]) < (0.3 if heavy else 0.95)).cuda()
    lv = torch.from_numpy(rng.random(lk.shape[0]) < (0.3 if heavy else 0.9)).cuda()
    tab = pj.build_paged_table(torch.from_numpy(rk).cuda(), rv)
    assert tab is not None
    return torch.from_numpy(lk).cuda(), lv, tab


@pytest.mark.parametrize("case", ["random", "null_heavy", "skew"])
@pytest.mark.parametrize("np_dt", [np.int8, np.int32, np.int64])
def test_probe_paged_kernel_matches_plain(rng, case, np_dt):
    lk, lv, tab = _probe_case(rng, case, np_dt)
    if case == "skew":
        assert tab.c_max >= 16
    before = hk.probe_paged.launches
    lo, eq = hk.probe_paged(lk, lv, tab)
    torch.cuda.synchronize()
    assert hk.probe_paged.launches == before + 1
    wlo, weq = hk.probe_paged_plain(lk, lv, tab)
    assert torch.equal(lo, wlo) and torch.equal(eq, weq)
    lo2, eq2 = hk.probe_paged(lk, None, tab)
    wlo2, weq2 = hk.probe_paged_plain(lk, None, tab)
    assert torch.equal(lo2, wlo2) and torch.equal(eq2, weq2)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("np_dt,name", [(np.int32, "INT32"), (np.int64, "INT64"),
                                        (np.uint32, "UINT32")])
def test_join_gather_maps_on_the_card_match_the_cpu(rng, how, np_dt, name):
    from spark_rapids_jni_tpu_torch.ops import join as pjoin

    lk = rng.integers(0, 5000, 100_000).astype(np_dt)
    rk = rng.choice(8000, 4000, replace=False).astype(np_dt)
    lv, rv = rng.random(100_000) < 0.9, rng.random(4000) < 0.95
    out = {}
    for dev in ("cpu", "cuda"):
        left = Table.from_numpy([lk], [getattr(pdt, name)], [lv], names=["k"], device=dev)
        right = Table.from_numpy([rk], [getattr(pdt, name)], [rv], names=["k"], device=dev)
        before = hk.probe_paged.launches
        lmap, rmap = pjoin.join_gather_maps(left, right, how)
        out[dev] = (lmap.cpu(), rmap.cpu(), hk.probe_paged.launches - before)
    assert torch.equal(out["cpu"][0], out["cuda"][0]) and torch.equal(out["cpu"][1], out["cuda"][1])
    assert out["cuda"][2] == (0 if how == "full" else 1)


def test_join_path_on_the_card_matches_the_cpu(rng):
    from spark_rapids_jni_tpu_torch.interop import carry_table
    from spark_rapids_jni_tpu_torch.ops import join as pjoin
    from spark_rapids_jni_tpu_torch.parallel import shuffle

    nf, nd = 200_000, 16_384
    fv = rng.random(nf) < 0.9
    fact = [rng.integers(0, 32_768, nf).astype(np.int32), rng.random(nf).astype(np.float32)]
    lens = rng.integers(1, 51, nd)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    dim = [rng.choice(32_768, nd, replace=False).astype(np.int32),
           rng.integers(0, 4096, nd).astype(np.int32),
           (offs, rng.integers(97, 123, int(offs[-1]), dtype=np.uint8))]
    out = {}
    for dev in ("cpu", "cuda"):
        f = Table(carry_table(fact, [pdt.INT32, pdt.FLOAT32], [fv, None], device=dev).columns,
                  ["item_sk", "price"])
        d = Table(carry_table(dim, [pdt.INT32, pdt.INT32, pdt.STRING], device=dev).columns,
                  ["item_sk", "brand_id", "brand"])
        part, offsets = shuffle.hash_partition(f, 200, ["item_sk"])
        j = pjoin.inner_join(part, d, ["item_sk"])
        s, c = aggregate.groupby_sum_bounded(j.column("brand_id").data, j.column("price").data, 4096)
        out[dev] = (offsets, [x.cpu() for x in (j.column("item_sk").data, j.column("brand").offsets,
                                                j.column("brand").chars, c)], s.cpu())
    assert out["cpu"][0] == out["cuda"][0]
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert torch.equal(a, b)
    torch.testing.assert_close(out["cpu"][2], out["cuda"][2], rtol=RTOL, atol=ATOL)


def test_a_failing_launch_raises_and_nothing_degrades(rng, monkeypatch):
    from spark_rapids_jni_tpu_torch import _build
    from spark_rapids_jni_tpu_torch.ops import join as pjoin

    class _Refused:
        def __getattr__(self, name):
            return lambda *args: 9  # cudaErrorInvalidConfiguration

    host = rng.integers(0, 100, 1000).astype(np.int32)
    keys = torch.from_numpy(host).cuda()
    left = Table.from_numpy([host], [pdt.INT32], names=["k"], device="cuda")
    monkeypatch.setattr(_build, "library", lambda name: _Refused())
    with pytest.raises(RuntimeError, match="partition_map"):
        hk.partition_map(keys, 7)
    with pytest.raises(RuntimeError, match="probe_paged"):
        pjoin.inner_join(left, left, ["k"])
