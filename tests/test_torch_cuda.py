"""Port: each hand-written CUDA kernel against its plain PyTorch version on
the card. These tests need a CUDA device and skip without one (the
condition is evaluated when each test is set up, not at import). They
import neither jax nor the JAX package, so on a machine with a card they
run without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

B1, B4, B5-B10, the row transcode and the join maps are exact; B3
counts are exact and its float32 sums are held to rtol 2e-6 / atol 1e-3,
the reference's bound, because the kernel's atomics add in an order that
changes from run to run; B2's sums to 1e-4, its reference's bound."""

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


def _vacc_inputs(rng, n, widths, shift_hi, view_offset=0):
    """K random uint8 [n, w] matrices (every byte may be set, so windows
    overlap) made as views ``view_offset`` bytes into a device buffer, and
    independent random shifts in [0, shift_hi) for each matrix and row."""
    mats, shifts = [], []
    for w in widths:
        flat = torch.from_numpy(rng.integers(0, 256, n * w + view_offset, dtype=np.uint8)).cuda()
        mats.append(flat[view_offset:].view(n, w))
        shifts.append(torch.from_numpy(rng.integers(0, shift_hi, n).astype(np.int32)).cuda())
    return mats, shifts


def _vacc_check(mats, shifts, maxvar):
    before = rb.var_accumulate.launches
    got = rb.var_accumulate(mats, shifts, maxvar)
    torch.cuda.synchronize()
    assert rb.var_accumulate.launches == before + 1
    assert torch.equal(got, rb.var_accumulate_plain(mats, shifts, maxvar))
    return got


# (rows, widths, maxvar, shifts below): non-monotone, overlapping windows
# at any shift, N = 1, N not a multiple of the tile's rows (36 at 112
# words), K = 1, K = 17, one row wider than a whole shared tile (8192
# words against 4096), and every window starting past the section
@pytest.mark.parametrize("n,widths,maxvar,shift_hi", [
    (1, (4,), 4, 4), (1, (32, 8), 64, 64), (37, (32,) * 16, 448, 448), (1001, (16, 32, 4), 96, 96),
    (4097, (32,), 128, 200), (999, (4,) + (32,) * 16, 448, 448), (3, (32, 4096, 32768), 32768, 32768),
    (2, (16384,), 32768, 20000), (50, (32, 32), 64, 8)])
def test_var_accumulate_kernel_any_shifts(rng, n, widths, maxvar, shift_hi):
    _vacc_check(*_vacc_inputs(rng, n, widths, shift_hi), maxvar)


@pytest.mark.parametrize("n,widths,maxvar", [(1, (8,), 64), (333, (32, 4, 32), 128)])
def test_var_accumulate_kernel_every_shift_past_the_section(rng, n, widths, maxvar):
    mats, _ = _vacc_inputs(rng, n, widths, 1)
    shifts = [torch.full((n,), maxvar + i, dtype=torch.int32, device="cuda") for i in range(len(widths))]
    assert not _vacc_check(mats, shifts, maxvar).any()


@pytest.mark.parametrize("offset", [1, 4, 8])
def test_var_accumulate_kernel_takes_unaligned_views(rng, offset):
    # 1: not word aligned (the wrapper copies); 4 and 8: word aligned but
    # not 16-byte aligned (the kernel's 4-byte loads)
    _vacc_check(*_vacc_inputs(rng, 1001, (32, 12, 32), 160, view_offset=offset), 160)


@pytest.mark.parametrize("tile_words", [4, 8, 24])
def test_var_accumulate_kernel_word_range_tiles(rng, monkeypatch, tile_words):
    # a small tile budget splits every row into word ranges across blocks
    monkeypatch.setattr(rb, "_VACC_TILE_WORDS", tile_words)
    _vacc_check(*_vacc_inputs(rng, 77, (32, 32, 8), 96), 96)


@pytest.mark.parametrize("by_value", [0, 32])
def test_var_accumulate_kernel_device_table(rng, monkeypatch, by_value):
    # K above the by-value cap (40 > 32), or every K, goes through the device table
    monkeypatch.setattr(rb, "_VACC_BY_VALUE", by_value)
    _vacc_check(*_vacc_inputs(rng, 130, (8,) * 40, 256), 256)


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


# -- B2, the exact FLOAT64 accumulator and TPC-H q1/q6 ---------------------------------

B2_TOL = 1e-4  # the reference's bound for its one-hot kernel


@pytest.mark.parametrize("n", [0, 1, 7, 1_000_000])
@pytest.mark.parametrize("num_keys", [1, 4096])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_groupby_sum_bounded_kernel_matches_plain(rng, n, num_keys, np_dt):
    keys = rng.integers(-5, num_keys + 5, n).astype(np_dt)
    if np_dt == np.int64 and n:
        keys[:: max(n // 5, 1)] = 2**32 + rng.integers(0, num_keys)  # drop, not wrap
    k = torch.from_numpy(keys).cuda()
    v = torch.from_numpy((rng.standard_normal(n) * 100).astype(np.float32)).cuda()
    before = hk.groupby_sum_bounded.launches
    got = hk.groupby_sum_bounded(k, v, num_keys)
    torch.cuda.synchronize()
    assert hk.groupby_sum_bounded.launches == before + (1 if n else 0)
    want = hk.groupby_sum_bounded_plain(k, v, num_keys)
    assert got.dtype == torch.float32 and got.shape == (num_keys,)
    torch.testing.assert_close(got, want, rtol=B2_TOL, atol=B2_TOL)
    torch.testing.assert_close(got.cpu(), hk.groupby_sum_bounded(k.cpu(), v.cpu(), num_keys),
                               rtol=B2_TOL, atol=B2_TOL)


@pytest.mark.parametrize("num_keys", [0, 1, 7, 4096])
def test_groupby_sum_bounded_kernel_domains(rng, num_keys):
    keys = torch.from_numpy(rng.integers(-3, num_keys + 3, 100_000)).cuda()
    vals = torch.from_numpy((rng.standard_normal(100_000) * 100).astype(np.float32)).cuda()
    before = hk.groupby_sum_bounded.launches
    got = hk.groupby_sum_bounded(keys, vals, num_keys)
    torch.cuda.synchronize()
    assert hk.groupby_sum_bounded.launches == before + (1 if num_keys else 0)
    assert got.shape == (num_keys,) and got.dtype == torch.float32
    torch.testing.assert_close(got, hk.groupby_sum_bounded_plain(keys, vals, num_keys),
                               rtol=B2_TOL, atol=B2_TOL)


def test_groupby_sum_bounded_kernel_nan_and_inf_bins(rng):
    n = 300_000  # many blocks, so a bin's +inf and -inf meet across blocks
    keys = rng.integers(0, 16, n)
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    for i, (key, special) in enumerate([(1, np.nan), (2, np.inf), (3, -np.inf), (4, np.inf),
                                        (4, -np.inf), (5, np.nan), (5, np.inf)]):
        vals[np.flatnonzero(keys == key)[i::7919][:3]] = special  # i: the pairs' rows differ
    k, v = torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()
    got = hk.groupby_sum_bounded(k, v, 16)
    want = hk.groupby_sum_bounded_plain(k, v, 16)
    assert torch.isnan(got[[1, 4, 5]]).all() and got[2] == np.inf and got[3] == -np.inf
    torch.testing.assert_close(got, want, rtol=B2_TOL, atol=B2_TOL, equal_nan=True)


def test_groupby_sum_bounded_kernel_leaves_nothing_behind(rng):
    # 100 calls in a row: a scratch carried over from a call would add in
    keys = torch.from_numpy(rng.integers(-5, 4101, 200_000)).cuda()
    vals = torch.from_numpy((rng.standard_normal(200_000) * 100).astype(np.float32)).cuda()
    want = hk.groupby_sum_bounded_plain(keys, vals, 4096)
    outs = [hk.groupby_sum_bounded(keys, vals, 4096) for _ in range(100)]
    torch.cuda.synchronize()
    for got in outs:
        torch.testing.assert_close(got, want, rtol=B2_TOL, atol=B2_TOL)


def test_groupby_sum_bounded_kernel_on_two_streams(rng):
    inputs = [(torch.from_numpy(rng.integers(-5, 4101, 1_000_000).astype(dt)).cuda(),
               torch.from_numpy((rng.standard_normal(1_000_000) * 100).astype(np.float32)).cuda())
              for dt in (np.int64, np.int32)]
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, (k, v) in zip(streams, inputs):
        st.wait_stream(main)
        with torch.cuda.stream(st):
            outs.append(hk.groupby_sum_bounded(k, v, 4096))
    for st in streams:
        main.wait_stream(st)
    torch.cuda.synchronize()
    for got, (k, v) in zip(outs, inputs):
        torch.testing.assert_close(got, hk.groupby_sum_bounded_plain(k, v, 4096),
                                   rtol=B2_TOL, atol=B2_TOL)


def _traced_device_work(fn):
    """Names of the device activities one call of ``fn`` enqueues, from
    torch.profiler after a warm-up step (a sleep kernel, left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    names = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: names.extend(
                     e.name for e in p.events()
                     if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    return names


def test_groupby_sum_bounded_enqueues_one_kernel(rng):
    keys = torch.from_numpy(rng.integers(-5, 4101, 1_000_000)).cuda()
    vals = torch.from_numpy((rng.standard_normal(1_000_000) * 100).astype(np.float32)).cuda()
    hk.groupby_sum_bounded(keys, vals, 4096)
    torch.cuda.synchronize()
    # the tracer has missed a launch on rare occasions: no traced call may
    # show other device work, and one of three must show the kernel alone
    seen = []
    for _ in range(3):
        names = _traced_device_work(lambda: hk.groupby_sum_bounded(keys, vals, 4096))
        assert all("groupby_bounded_kernel" in name for name in names), names
        seen.append(len(names))
        if len(names) == 1:
            break
    assert seen[-1] == 1, seen


def test_groupby_sum_bounded_kernel_agrees_with_b3(rng):
    keys = torch.from_numpy(rng.integers(-5, 4101, 1_000_000)).cuda()
    vals = torch.from_numpy((rng.standard_normal(1_000_000) * 100).astype(np.float32)).cuda()
    s3, _ = hk.groupby_sum_outer(keys, vals, 4096)
    torch.testing.assert_close(hk.groupby_sum_bounded(keys, vals, 4096), s3, rtol=RTOL, atol=ATOL)


def test_groupby_sum_bounded_rejects_large_domain_on_the_card():
    with pytest.raises(ValueError, match="num_keys"):
        hk.groupby_sum_bounded(torch.zeros(8, dtype=torch.int32, device="cuda"),
                               torch.zeros(8, device="cuda"), 4097)


def _f64_values(rng, n):
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    v[::97] = np.inf
    v[5::101] = -np.inf
    v[7::211] = np.nan
    v[::13] = rng.integers(1, 1 << 52, v[::13].shape[0]).view(np.float64)  # subnormals
    v[3::17] = -0.0
    return v


@pytest.mark.parametrize("n,g", [(0, 3), (1, 1), (10_000, 7), (100_000, 41), (1_000_000, 6)])
def test_f64acc_on_the_card_matches_the_cpu(rng, n, g):
    from spark_rapids_jni_tpu_torch.ops import f64acc

    bits = torch.from_numpy(_f64_values(rng, n).view(np.int64))
    seg = torch.from_numpy(rng.integers(0, g, n))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    for fn in (f64acc.segment_sum_f64bits, f64acc.segment_mean_f64bits):
        cpu = fn(bits, seg, g, valid=valid)
        gpu = fn(bits.cuda(), seg.cuda(), g, valid=valid.cuda())
        cpu, gpu = (cpu, gpu) if isinstance(cpu, torch.Tensor) else (cpu[0], gpu[0])
        assert torch.equal(gpu.cpu(), cpu)


def test_f64acc_conversions_on_the_card_match_the_cpu(rng):
    from spark_rapids_jni_tpu_torch.ops import f64acc

    x = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, 10_000, dtype=np.int64))
    cnt = torch.from_numpy(rng.integers(0, 2**31, 10_000))
    bits = torch.from_numpy(_f64_values(rng, 10_000).view(np.int64))
    for fn, args in [(f64acc.i64_to_f64bits, (x,)), (f64acc.u64_to_f64bits, (x,)),
                     (f64acc.mean_i64_div, (x, cnt)),
                     (lambda s, c: f64acc.mean_i64_div(s, c, unsigned=True), (x, cnt)),
                     (f64acc.div_f64bits_by_int, (bits, cnt))]:
        assert torch.equal(fn(*[a.cuda() for a in args]).cpu(), fn(*args))


def test_tpch_on_the_card_matches_the_cpu():
    from spark_rapids_jni_tpu_torch.interop import table_to_numpy
    from spark_rapids_jni_tpu_torch.models import compiled, tpch

    out = {}
    for dev in ("cpu", "cuda"):
        li = tpch.gen_lineitem(200_000, seed=7, device=dev)
        q1 = table_to_numpy(tpch.q1(li))[0]
        out[dev] = (q1, tpch.q6(li), compiled.q1_fused(li), compiled.q6_fused(li))
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert out["cpu"][1] == out["cuda"][1] == out["cuda"][3] == out["cpu"][3]
    for k, v in out["cpu"][2].items():
        assert np.array_equal(v.view(np.uint8), out["cuda"][2][k].view(np.uint8)), k


def test_groupby_aggregate_on_the_card_matches_the_cpu(rng):
    from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy

    n = 50_000
    keys = [rng.integers(0, 40, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int8)]
    vals = [rng.standard_normal(n).view(np.uint64), rng.integers(-10**9, 10**9, n),
            rng.integers(0, 2**32, n, dtype=np.uint32)]
    valid = [rng.random(n) < 0.9, None, rng.random(n) < 0.8]
    aggs = [(c, h) for c in ("f", "i", "u") for h in ("sum", "mean", "min", "max", "count",
                                                      "nunique")]
    out = {}
    for dev in ("cpu", "cuda"):
        kt = Table(carry_table(keys, [pdt.INT32, pdt.INT8], device=dev).columns, ["a", "b"])
        vt = Table(carry_table(vals, [pdt.FLOAT64, pdt.INT64, pdt.UINT32], valid,
                               device=dev).columns, ["f", "i", "u"])
        out[dev] = table_to_numpy(aggregate.groupby_aggregate(kt, vt, aggs))
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_pipeline_joins_on_the_card_match_the_cpu(rng):
    from spark_rapids_jni_tpu_torch import pipeline as pp
    from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
    from spark_rapids_jni_tpu_torch.ops.expressions import col

    n, nd = 100_000, 4096
    fact = [rng.integers(0, 5000, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int8),
            rng.standard_normal(n).view(np.uint64)]
    dim = [rng.permutation(5000)[:nd].astype(np.int32), rng.standard_normal(nd).view(np.uint64),
           rng.integers(0, 2, nd).astype(np.int8)]
    plans = [
        pp.PlanSpec(joins=(pp.JoinSpec("d", "fk", "dk", num_keys=5000, payload=("dp",)),),
                    group_by=(pp.GroupKey("g", 3),),
                    aggregates=(pp.Agg("dp", "sum"), pp.Agg("v", "mean"), pp.Agg("v", "max"))),
        pp.PlanSpec(joins=(pp.JoinSpec("d", "fk", "dk", payload=("dp",),
                                       build_filter=col("flag") == 1),),
                    aggregates=(pp.Agg("dp", "sum"), pp.Agg("v", "count_all"))),
        pp.PlanSpec(joins=(pp.JoinSpec("d", "fk", "dk", num_keys=5000, how="anti"),),
                    filter=col("v") > 0.0, aggregates=(pp.Agg("v", "sum"),)),
    ]
    for plan in plans:
        out = {}
        for dev in ("cpu", "cuda"):
            f = Table(carry_table(fact, [pdt.INT32, pdt.INT8, pdt.FLOAT64], device=dev).columns,
                      ["fk", "g", "v"])
            d = Table(carry_table(dim, [pdt.INT32, pdt.FLOAT64, pdt.INT8], device=dev).columns,
                      ["dk", "dp", "flag"])
            out[dev] = table_to_numpy(pp.compile_plan(plan)(f, {"d": d}))[0]
        for a, b in zip(out["cpu"], out["cuda"]):
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
