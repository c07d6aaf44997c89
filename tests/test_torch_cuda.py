"""Port: each hand-written CUDA kernel against its plain PyTorch version on
the card. These tests need a CUDA device and skip without one (the
condition is evaluated when each test is set up, not at import). They
import neither jax nor the JAX package, so on a machine with a card they
run without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

B1, B4, B5-B10 (with ``rows_to_planes`` and ``extract_strings_many``,
the kernels that took B7's and B8's places on the transcode's path), the
row transcode and the join maps are exact; B3
counts are exact and its float32 sums are held to rtol 2e-6 / atol 1e-3,
the reference's bound, because the kernel's atomics add in an order that
changes from run to run; B2's sums to 1e-4, its reference's bound. The
probe cases shared with the CPU tests come from ``torch_paged_cases``
(beside this file, no jax). The IO tests read files of the harness
writers (``torch_io_writers``, no pyarrow) on the card and hold every
column, frame and row blob against the same read on the CPU, exactly."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import aggregate
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

import torch_paged_cases as cases

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


@pytest.mark.parametrize("n,num_keys", [((1 << 24) - 1, 4096), (1000, 1), (300_000, 8192),
                                        (300_000, 8193), (300_000, 65536)])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_groupby_sum_outer_kernel_key_widths(rng, n, num_keys, np_dt):
    # n = 2^24 - 1: the aggregate tier's gate (ops/aggregate.py) for B3
    keys = torch.from_numpy(rng.integers(-5, num_keys + 5, n).astype(np_dt)).cuda()
    vals = torch.from_numpy((rng.standard_normal(n) * 100).astype(np.float32)).cuda()
    gs, gc = hk.groupby_sum_outer(keys, vals, num_keys)
    ws, wc = hk.groupby_sum_outer_plain(keys, vals, num_keys)
    assert gs.dtype == torch.float32 and gc.dtype == torch.int64
    assert torch.equal(gc, wc)
    torch.testing.assert_close(gs, ws, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_keys", [7, 8192, 65536])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_groupby_sum_outer_kernel_all_keys_out_of_domain(rng, num_keys, np_dt):
    keys = torch.from_numpy(np.where(rng.random(100_000) < 0.5, -1, num_keys).astype(np_dt)).cuda()
    vals = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)).cuda()
    gs, gc = hk.groupby_sum_outer(keys, vals, num_keys)
    assert not gc.any() and not gs.any()


@pytest.mark.parametrize("num_keys", [4096, 65536])
def test_groupby_sum_outer_kernel_leaves_nothing_behind(rng, num_keys):
    # 50 calls in a row: a scratch carried over from a call would add in
    keys = torch.from_numpy(rng.integers(-5, num_keys + 5, 200_000)).cuda()
    vals = torch.from_numpy((rng.standard_normal(200_000) * 100).astype(np.float32)).cuda()
    ws, wc = hk.groupby_sum_outer_plain(keys, vals, num_keys)
    outs = [hk.groupby_sum_outer(keys, vals, num_keys) for _ in range(50)]
    torch.cuda.synchronize()
    for gs, gc in outs:
        assert torch.equal(gc, wc)
        torch.testing.assert_close(gs, ws, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_keys", [1, 4096, 8192, 8193, 65536])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_groupby_sum_outer_enqueues_one_kernel(rng, num_keys, np_dt):
    # one kernel and nothing else: no fill, no cast of int32 keys, no
    # rounding after
    keys = torch.from_numpy(rng.integers(-5, num_keys + 5, 1_000_000).astype(np_dt)).cuda()
    vals = torch.from_numpy((rng.standard_normal(1_000_000) * 100).astype(np.float32)).cuda()
    hk.groupby_sum_outer(keys, vals, num_keys)
    torch.cuda.synchronize()
    # the tracer has missed a launch on rare occasions: no traced call may
    # show other device work, and one of three must show the kernel alone
    seen = []
    for _ in range(3):
        names = _traced_device_work(lambda: hk.groupby_sum_outer(keys, vals, num_keys))
        assert all("groupby_outer_kernel" in name for name in names), names
        seen.append(len(names))
        if len(names) == 1:
            break
    assert seen[-1] == 1, seen


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
        before = (rb.rows_to_planes.launches, rb.pack_u8_planes.launches)
        t = Table.from_numpy(arrays, dtypes, valids, device=dev)
        rows = rc.convert_to_rows(t)
        dec = rc.convert_from_rows(rows[0], dtypes)
        # the card's decode reads the blob into word planes in one launch, not B7
        assert (rb.rows_to_planes.launches - before[0], rb.pack_u8_planes.launches - before[1]) \
            == ((1 if dev == "cuda" else 0), 0)
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
# string kernels: B8, B9, B10 (asm_epilogue, assemble_rows), B5
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


def _decode_like(rng, n, lens, tail=0, fixed=24, mis=0):
    """A row blob laid out as the decode sees it: row r holds ``fixed``
    bytes, then its strings column after column ([n, K] ``lens``), then 0-7
    pad bytes. Returns (pool, row_starts int64, [K] u32 slot offsets
    int32, [K] int32 offsets, [K] totals); the pool ends ``tail`` bytes
    past the last row's strings and starts ``mis`` bytes past a word."""
    k = lens.shape[1]
    slot = fixed + np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(lens, 1)[:, :-1]], 1)
    sizes = fixed + lens.sum(1) + rng.integers(0, 8, n)
    sizes[-1] = fixed + lens[-1].sum()
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    buf = torch.from_numpy(rng.integers(0, 256, mis + int(sizes.sum()) + tail, dtype=np.uint8)).cuda()
    offs = [np.concatenate([[0], np.cumsum(lens[:, c])]).astype(np.int32) for c in range(k)]
    return (buf[mis:], torch.from_numpy(starts).cuda(),
            [torch.from_numpy(slot[:, c].astype(np.int32)).cuda() for c in range(k)],
            [torch.from_numpy(o).cuda() for o in offs], [int(o[-1]) for o in offs])


def _compact_many_check(pool, starts, slots, offs, totals):
    before = (hk.ragged_compact_many.launches, hk.ragged_compact.launches)
    got = hk.ragged_compact_many(pool, list(zip(slots, offs, totals)), row_starts=starts)
    torch.cuda.synchronize()
    assert hk.ragged_compact_many.launches == before[0] + (1 if any(totals) else 0)
    assert hk.ragged_compact.launches == before[1]
    assert len(got) == len(slots)
    for g, s, o, t in zip(got, slots, offs, totals):
        want = hk.ragged_compact_plain(pool, starts + s.to(torch.int64), o, t)
        assert g.dtype == torch.uint8 and g.shape == (t,)
        assert torch.equal(g, want)
    # the same columns with int64 bases, and int64 offsets
    got64 = hk.ragged_compact_many(pool, [(starts + s.to(torch.int64), o.to(torch.int64), t)
                                          for s, o, t in zip(slots, offs, totals)])
    assert all(torch.equal(a, b) for a, b in zip(got64, got))


# 1 column, the string path's 16, and more than the 32 the kernel takes
# in its arguments (a device table); with empty, all-null and sparse
# columns among them
@pytest.mark.parametrize("ncols", [1, 16, 40])
def test_ragged_compact_many_kernel_matches_plain(rng, ncols):
    n = 20_001
    lens = rng.integers(1, 33, (n, ncols))
    for c in range(ncols):
        if c % 5 == 1:
            lens[:, c] = 0  # all null
        elif c % 5 == 2:
            lens[rng.random(n) < 0.97, c] = 0  # long runs of nulls
        elif c % 5 == 3:
            lens[rng.random(n) < 0.1, c] = 0
    _compact_many_check(*_decode_like(rng, n, lens))


def test_ragged_compact_many_kernel_device_table(rng, monkeypatch):
    # every column through the device table, at 16 columns
    monkeypatch.setattr(hk, "_COMPACT_BY_VALUE", 4)
    _compact_many_check(*_decode_like(rng, 5003, rng.integers(0, 40, (5003, 16))))


# (rows, longest string, null share, pool bytes past the last string,
# misalignment): runs of zero-length rows longer than a block stages
# (300,000 rows, 99.9% null), 1-3 byte strings (more rows a block than it
# stages), one string longer than a block's 8 KB, strings ending at the
# pool's last byte, pools that start 1-3 bytes past a word
@pytest.mark.parametrize("n,max_len,null_frac,tail,mis", [
    (300_000, 32, 0.999, 0, 0), (100_003, 3, 0.0, 0, 1), (50_000, 1, 0.5, 5, 2),
    (2001, 32, 0.0, 0, 3), (7, 32, 0.0, 0, 0), (1, 1, 0.0, 0, 1)])
def test_ragged_compact_many_kernel_classes(rng, n, max_len, null_frac, tail, mis):
    lens = rng.integers(1, max_len + 1, (n, 3))
    lens[rng.random((n, 3)) < null_frac] = 0
    lens[-1, 2] = max(lens[-1, 2], 1)  # the last string ends at the pool's end (tail 0)
    _compact_many_check(*_decode_like(rng, n, lens, tail=tail, mis=mis))


def test_ragged_compact_many_kernel_long_rows(rng):
    # one string of 100 KB (a dozen blocks), between short ones
    n = 300
    lens = rng.integers(0, 33, (n, 2))
    lens[n // 2, 0] = 100_000
    lens[n // 3, 1] = 8192 * 3 + 5
    _compact_many_check(*_decode_like(rng, n, lens, mis=1))


def test_ragged_compact_many_empty_columns_launch_nothing(rng):
    pool, starts, slots, offs, _ = _decode_like(rng, 100, np.zeros((100, 3), np.int64))
    before = hk.ragged_compact_many.launches
    got = hk.ragged_compact_many(pool, [(s, o, 0) for s, o in zip(slots, offs)], row_starts=starts)
    assert hk.ragged_compact_many.launches == before
    assert [g.shape for g in got] == [(0,)] * 3


def _padded_rows(rng, n, min_row, spread, long_row=0):
    """int32 [N, W] padded rows (bytes past a row's size zero), its sizes
    and offsets on the card."""
    sizes = (min_row + rng.integers(0, spread // 8 + 1, n) * 8).astype(np.int64)
    if long_row:
        sizes[n // 2] = long_row
    width = (int(sizes.max()) + 3) // 4 * 4 + 12
    rp = np.zeros((n, width), np.uint8)
    for r in range(n):
        rp[r, : sizes[r]] = rng.integers(0, 256, sizes[r])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return (torch.from_numpy(rp).cuda().view(torch.int32), torch.from_numpy(sizes).cuda(),
            torch.from_numpy(offsets).cuda(), int(offsets[-1]))


def _asm_parts(rp32, layout, split):
    """The padded rows as the kernel may get them: one row-major part, two
    row-major parts, or the encode's layout (a transposed view of word
    planes, then a row-major part), or a part that starts a word past a
    16-byte boundary."""
    if layout == "rows":
        return [rp32]
    if layout == "two":
        return [rp32[:, :split].contiguous(), rp32[:, split:].contiguous()]
    if layout == "path":
        return [rp32[:, :split].t().contiguous().t(), rp32[:, split:].contiguous()]
    flat = torch.empty(rp32.numel() + 1, dtype=torch.int32, device=rp32.device)
    view = flat[1:].view(rp32.shape)
    view.copy_(rp32)
    return [view]


def _asm_check(parts, sizes, offsets, total, min_row):
    before = (rb.assemble_rows.launches, rb.asm_epilogue.launches)
    got = rb.assemble_rows(parts, sizes, offsets, total, min_row)
    torch.cuda.synchronize()
    assert (rb.assemble_rows.launches, rb.asm_epilogue.launches) == (before[0] + 1, before[1])
    want = rb.assemble_rows_plain(parts, sizes, offsets, total, min_row)
    assert got.dtype == torch.uint8 and got.shape == (total,)
    assert torch.equal(got, want)


# min_row 8, 16, 136 and 1016: the plain version's tiles of 8 to 256
# bytes; every layout the kernel reads
@pytest.mark.parametrize("min_row,spread", [(8, 24), (16, 300), (136, 128), (1016, 512)])
@pytest.mark.parametrize("layout", ["rows", "two", "path", "unaligned"])
def test_assemble_rows_kernel_matches_plain(rng, min_row, spread, layout):
    rp32, sizes, offsets, total = _padded_rows(rng, 3001, min_row, spread)
    split = min(rp32.shape[1] - 1, max(1, min_row // 4 - 1 + (min_row // 4) % 2))  # odd where it can
    _asm_check(_asm_parts(rp32, layout, split), sizes, offsets, total, min_row)


@pytest.mark.parametrize("n,min_row,long_row", [(1, 8, 0), (1, 1016, 0), (1, 8, 50_000),
                                                 (257, 16, 100_000), (40, 1016, 40_008)])
@pytest.mark.parametrize("layout", ["rows", "path"])
def test_assemble_rows_kernel_one_row_and_long_rows(rng, n, min_row, long_row, layout):
    rp32, sizes, offsets, total = _padded_rows(rng, n, min_row, 64, long_row)
    _asm_check(_asm_parts(rp32, layout, 253 if rp32.shape[1] > 253 else 1), sizes, offsets, total,
               min_row)


def test_assemble_rows_rejects_unaligned_rows():
    z = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, 8, 16], device="cuda")
    with pytest.raises(ValueError, match="8-aligned"):
        rb.assemble_rows(z, offs[1:] - offs[:-1], offs, 12, 8)
    with pytest.raises(ValueError, match="int32"):
        rb.assemble_rows(z.to(torch.int64), offs[1:] - offs[:-1], offs, 16, 8)


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

    wrappers = {"extract": rb.extract_strings_many, "vacc": rb.var_accumulate,
                "assemble": rb.assemble_rows, "planes": rb.rows_to_planes,
                "compact": hk.ragged_compact_many, "rotl": rb.rotl_take, "pack": rb.pack_u8_planes}
    out = {}
    for dev in ("cpu", "cuda"):
        before = {k: w.launches for k, w in wrappers.items()}
        t = carry_table(arrays, dtypes, valids, device=dev)
        rows = rc.convert_to_rows(t)
        dec = rc.convert_from_rows(rows[0], dtypes)
        s, c = aggregate.groupby_sum_bounded(dec.columns[2].data, dec.columns[1].data, 512)
        counts = {k: w.launches - before[k] for k, w in wrappers.items()}
        out[dev] = (rows[0], dec, s.cpu(), c.cpu())
    # the card run: one extraction of all four string columns, one B9, one
    # compaction for the blob, one read of the fixed sections into word
    # planes and one compaction of all four string columns; no B8, no B7
    assert counts == {"extract": 1, "vacc": 1, "assemble": 1, "planes": 1, "compact": 1,
                      "rotl": 0, "pack": 0}, counts
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
# rows_to_planes and extract_strings_many: B7 and B8 on the transcode's path
# ---------------------------------------------------------------------------


def _rows_blob(rng, n, width, align, mis=0):
    """A row blob of n rows of ``width`` bytes or more on the card, row
    starts a multiple of ``align`` (1: any) with gaps, the last row ending
    at the blob's end; the blob a view ``mis`` bytes into its buffer."""
    gaps = rng.integers(0, 9, n)
    starts, at = np.zeros(n, np.int64), int(rng.integers(0, 4))
    for r in range(n):
        at = -(-at // align) * align
        starts[r] = at
        at += width + int(gaps[r])
    size = int(starts[-1]) + width if n else 0
    buf = torch.from_numpy(rng.integers(0, 256, size + mis, dtype=np.uint8)).cuda()
    return buf[mis:], torch.from_numpy(starts).cuda()


def _r2p_check(blob, starts, width, n=None):
    before = (rb.rows_to_planes.launches, rb.pack_u8_planes.launches, rb.rotl_take.launches)
    got = rb.rows_to_planes(blob, starts, width, n)
    torch.cuda.synchronize()
    rows = starts.shape[0] if isinstance(starts, torch.Tensor) else n
    launched = 1 if rows and width else 0
    assert (rb.rows_to_planes.launches, rb.pack_u8_planes.launches,
            rb.rotl_take.launches) == (before[0] + launched, before[1], before[2])
    assert got.dtype == torch.int32 and got.shape == ((width + 3) // 4, rows)
    assert torch.equal(got, rb.rows_to_planes_plain(blob, starts, width, n))
    return got


def _composition(blob, starts, width):
    """The reference decode's composition on the card: padded_extract (the
    tile gather + B8) cut to W bytes, padded to whole words, transposed to
    byte planes, packed by B7."""
    fixed = rb.padded_extract(blob, starts, width)[:, :width]
    fixed = torch.nn.functional.pad(fixed, (0, (-width) % 4))
    return rb.pack_u8_planes(fixed.t().contiguous())


# (rows, W, row start alignment, the blob's storage offset): the string
# path's W = 1012 over several bands, the tail word (W = 1011, 13),
# 4-aligned and odd starts, blobs 1-3 bytes past a word, N = 1
@pytest.mark.parametrize("n,width,align,mis", [
    (100_003, 1012, 8, 0), (5001, 1011, 8, 0), (3000, 13, 4, 0), (3001, 278, 1, 3),
    (777, 1012, 1, 1), (64, 5, 2, 2), (1, 24, 8, 0), (65, 4, 1, 0)])
def test_rows_to_planes_kernel_matches_plain(rng, n, width, align, mis):
    blob, starts = _rows_blob(rng, n, width, align, mis)
    got = _r2p_check(blob, starts, width)
    # bit for bit the composition it replaces, the tail word's bytes past W included
    assert torch.equal(got, _composition(blob, starts, width))


@pytest.mark.parametrize("n,width,mis", [(1_000_003, 792, 0), (4097, 24, 0), (130, 792, 1),
                                         (1, 8, 3)])
def test_rows_to_planes_kernel_uniform_stride(rng, n, width, mis):
    buf = torch.from_numpy(rng.integers(0, 256, n * width + mis, dtype=np.uint8)).cuda()
    blob = buf[mis:]
    got = _r2p_check(blob, width, width, n)
    if mis == 0:  # the library yardstick: a view and one transpose
        assert torch.equal(got, blob.view(torch.int32).view(n, width // 4).t().contiguous())


def test_rows_to_planes_kernel_past_the_blob_end(rng):
    # rows that start 5, 1 and 0 bytes before the end read zeros past it;
    # the blob starts 3 bytes past a word and ends 2 bytes into one
    buf = torch.from_numpy(rng.integers(1, 256, 4096, dtype=np.uint8)).cuda()
    blob = buf[3:102]
    starts = torch.tensor([0, 40, 94, 98, 99, 7], dtype=torch.int64, device="cuda")
    got = _r2p_check(blob, starts, 13)
    assert not got[:, 4].any() and got[2:, 2].eq(0).all()


def test_rows_to_planes_kernel_empty_cases(rng):
    z = torch.zeros((0,), dtype=torch.uint8, device="cuda")
    _r2p_check(z, torch.zeros((0,), dtype=torch.int64, device="cuda"), 13)  # N = 0
    got = _r2p_check(z, torch.zeros((70,), dtype=torch.int64, device="cuda"), 13)  # empty blob
    assert not got.any()
    _r2p_check(torch.ones(64, dtype=torch.uint8, device="cuda"), 8, 0, 8)  # W = 0
    # int32 starts are taken as they are given
    blob, starts = _rows_blob(rng, 300, 40, 8)
    _r2p_check(blob, starts.to(torch.int32), 40)


def _string_cols(rng, n, specs):
    """String columns on the card: for each (longest, null share, pool
    tail bytes, storage offset) a pool, int32 starts and lengths; the last
    string of each ends at its strings' end."""
    pools, starts, lens = [], [], []
    for max_len, null_frac, tail, mis in specs:
        ln = rng.integers(0, max_len + 1, n)
        ln[rng.random(n) < null_frac] = 0
        if n:
            ln[-1] = max_len
        offs = np.concatenate([[0], np.cumsum(ln)]).astype(np.int32)
        buf = torch.from_numpy(rng.integers(0, 256, int(offs[-1]) + tail + mis,
                                            dtype=np.uint8)).cuda()
        pools.append(buf[mis:])
        starts.append(torch.from_numpy(offs[:-1]).cuda())
        lens.append(torch.from_numpy(ln.astype(np.int32)).cuda())
    return pools, starts, lens


def _extract_check(pools, starts, lens, widths):
    before = (rb.extract_strings_many.launches, rb.rotl_take.launches)
    got = rb.extract_strings_many(pools, starts, lens, widths)
    torch.cuda.synchronize()
    n = starts[0].shape[0] if starts else 0
    launched = 1 if n and any(widths) else 0
    assert (rb.extract_strings_many.launches, rb.rotl_take.launches) == (before[0] + launched,
                                                                          before[1])
    want = rb.extract_strings_many_plain(pools, starts, lens, widths)
    assert len(got) == len(want)
    for g, w, lc in zip(got, want, widths):
        assert g.dtype == torch.uint8 and g.shape == (n, lc) and g.is_contiguous()
        assert g.data_ptr() % 16 == 0  # var_accumulate takes it without a copy
        assert torch.equal(g, w)
    return got


# the string path's 16 columns of 1-32 bytes (widths 32), odd-length and
# empty columns, pools 1-3 bytes past a word, lengths past the width, one
# row, more columns than travel by value (a device table)
@pytest.mark.parametrize("n,specs,widths", [
    (100_003, [(32, 0.1, 0, 0)] * 16, [32] * 16),
    (3001, [(7, 0.5, 1, 1), (0, 0.0, 0, 0), (40, 0.0, 3, 2), (3, 0.9, 0, 3)], [8, 4, 16, 4]),
    (1, [(32, 0.0, 0, 1), (5, 0.0, 0, 0)], [32, 8]),
    (2049, [(13, 0.2, 2, k % 4) for k in range(40)], [16] * 40),
    (500, [(3000, 0.1, 0, 1)], [3000])])
def test_extract_strings_many_kernel_matches_plain(rng, n, specs, widths):
    _extract_check(*_string_cols(rng, n, specs), widths)


def test_extract_strings_many_kernel_device_table(rng, monkeypatch):
    # every column through the device table, at the string path's 16
    monkeypatch.setattr(rb, "_EXTRACT_BY_VALUE", 0)
    _extract_check(*_string_cols(rng, 5003, [(32, 0.1, 0, 1)] * 16), [32] * 16)


def test_extract_strings_many_kernel_empty_cases(rng):
    z8 = torch.zeros((0,), dtype=torch.uint8, device="cuda")
    z32 = torch.zeros((0,), dtype=torch.int32, device="cuda")
    _extract_check([z8, z8], [z32, z32], [z32, z32], [8, 4])  # N = 0
    zn = torch.zeros((300,), dtype=torch.int32, device="cuda")
    got = _extract_check([z8, z8], [zn, zn], [zn, zn], [8, 0])  # empty pools; a width of 0
    assert not got[0].any()
    pools, starts, lens = _string_cols(rng, 300, [(9, 0.1, 0, 0)])
    _extract_check(pools, [s.to(torch.int64) for s in starts], lens, [12])  # int64 starts
    assert rb.extract_strings_many([], [], [], []) == []


def test_a_refused_transcode_launch_raises(rng, monkeypatch):
    from spark_rapids_jni_tpu_torch import _build

    class _Refused:
        def __getattr__(self, name):
            return lambda *args: 9  # cudaErrorInvalidConfiguration

    blob, starts = _rows_blob(rng, 100, 40, 8)
    pools, sts, lens = _string_cols(rng, 100, [(9, 0.1, 0, 0)])
    before = (rb.rows_to_planes.launches, rb.extract_strings_many.launches)
    monkeypatch.setattr(_build, "library", lambda name: _Refused())
    with pytest.raises(RuntimeError, match="rows_to_planes"):
        rb.rows_to_planes(blob, starts, 40)
    with pytest.raises(RuntimeError, match="extract_strings_many"):
        rb.extract_strings_many(pools, sts, lens, [12])
    assert (rb.rows_to_planes.launches, rb.extract_strings_many.launches) == before


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

    lk, lv, rk, rv = cases.probe_case(rng, case, np_dt)
    tab = pj.build_paged_table(torch.from_numpy(rk).cuda(), torch.from_numpy(rv).cuda())
    assert tab is not None
    return torch.from_numpy(lk).cuda(), torch.from_numpy(lv).cuda(), tab


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


def _probe_check(lk, lv, tab):
    before = hk.probe_paged.launches
    lo, eq = hk.probe_paged(lk, lv, tab)
    torch.cuda.synchronize()
    assert hk.probe_paged.launches == before + 1
    wlo, weq = hk.probe_paged_plain(lk, lv, tab)
    assert torch.equal(lo, wlo) and torch.equal(eq, weq)
    return eq


@pytest.mark.parametrize("np_dt", [np.int8, np.int16, np.int32, np.int64])
def test_probe_paged_kernel_at_segment_and_page_boundaries(rng, np_dt):
    # runs of equal keys ending before, at and past a segment and a page,
    # probes equal to every fence and next to it, a bucket holding a whole
    # number of segments
    from spark_rapids_jni_tpu_torch.ops import paged_join as pj

    keys, full = cases.boundary_build(rng, np_dt)
    tab = pj.build_paged_table(torch.from_numpy(keys).cuda())
    assert int(tab.counts[full]) % tab.fence_stride == 0 and tab.c_max >= 2
    lk, lv = cases.boundary_probes(rng, np_dt, keys, _table_on(tab, "cpu"))
    eq = _probe_check(torch.from_numpy(lk).cuda(), torch.from_numpy(lv).cuda(), tab)
    assert int(eq.sum()) > 0
    _probe_check(torch.from_numpy(lk).cuda(), None, tab)


def _table_on(tab, dev):
    return type(tab)(*(x.to(dev) if isinstance(x, torch.Tensor) else x for x in tab))


def test_probe_paged_kernel_on_the_largest_shared_table(rng):
    # 2,048 buckets and pages of int64 words: 152 KB of shared memory a block
    tab, keys = cases.largest_table(rng)
    assert tab.fence_stride == 16 and 12 * tab.num_buckets + tab.fences.numel() * 8 == 12 * 2048 + 131_072
    lk = np.concatenate([keys, keys[::7] + 1, rng.integers(-2**62, 2**62, 200_000)])
    lv = torch.from_numpy(rng.random(lk.shape[0]) < 0.9).cuda()
    eq = _probe_check(torch.from_numpy(lk).cuda(), lv, _table_on(tab, "cuda"))
    assert int(eq.sum()) > 0


def test_a_refused_probe_raises(rng, monkeypatch):
    from spark_rapids_jni_tpu_torch import _build
    from spark_rapids_jni_tpu_torch.ops import paged_join as pj

    lk, lv, tab = _probe_case(rng, "random", np.int32)
    with pytest.raises(ValueError, match="fences"):
        hk.probe_paged(lk, lv, tab._replace(fences=None))
    # the launch refuses a stride the build never gives int32 words, and
    # fences off a 16-byte boundary
    with pytest.raises(RuntimeError, match="probe_paged"):
        hk.probe_paged(lk, lv, tab._replace(fences=tab.slots[::4].contiguous(), fence_stride=4,
                                            fence_first=tab.fence_first * 2))
    shifted = torch.empty(tab.fences.numel() + 1, dtype=tab.fences.dtype, device="cuda")[1:]
    shifted.copy_(tab.fences)
    with pytest.raises(RuntimeError, match="probe_paged"):
        hk.probe_paged(lk, lv, tab._replace(fences=shifted))

    class _Refused:
        def __getattr__(self, name):
            return lambda *args: 1  # cudaErrorInvalidValue: a table the kernel does not take

    before = hk.probe_paged.launches
    monkeypatch.setattr(_build, "library", lambda name: _Refused())
    with pytest.raises(RuntimeError, match="probe_paged"):
        hk.probe_paged(lk, lv, tab)
    assert hk.probe_paged.launches == before
    assert isinstance(tab, pj.PagedHashTable)


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


def test_a_refused_string_launch_raises(rng, monkeypatch):
    from spark_rapids_jni_tpu_torch import _build

    class _Refused:
        def __getattr__(self, name):
            return lambda *args: 9  # cudaErrorInvalidConfiguration

    pool, starts, slots, offs, totals = _decode_like(rng, 1000, rng.integers(1, 9, (1000, 2)))
    rp32, sizes, offsets, total = _padded_rows(rng, 100, 16, 64)
    before = (hk.ragged_compact_many.launches, hk.ragged_compact.launches, rb.assemble_rows.launches)
    monkeypatch.setattr(_build, "library", lambda name: _Refused())
    with pytest.raises(RuntimeError, match="ragged_compact"):
        hk.ragged_compact_many(pool, list(zip(slots, offs, totals)), row_starts=starts)
    with pytest.raises(RuntimeError, match="ragged_compact"):
        hk.ragged_compact(pool, starts + slots[0].to(torch.int64), offs[0], totals[0])
    with pytest.raises(RuntimeError, match="assemble_rows"):
        rb.assemble_rows([rp32], sizes, offsets, total, 16)
    assert (hk.ragged_compact_many.launches, hk.ragged_compact.launches,
            rb.assemble_rows.launches) == before


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


# -- the Spark-exact operators: the casts' padded chars through B8's kernel,
# and each new operation on CUDA tensors against the same call on CPU ones --


def _string_column(strings, valid, dev):
    from spark_rapids_jni_tpu_torch.columnar import Column

    c = Column.from_pylist(strings, pdt.STRING, device=dev)
    return Column(pdt.STRING, validity=torch.tensor(valid, device=dev), offsets=c.offsets,
                  chars=c.chars)


@pytest.mark.parametrize("strings", [
    ["", "a", "hello world", "", "  12  ", "xyz", "0123456789abcdef0"],
    ["", "", ""],
    ["x" * 37, "", "yy", "-12.5e3", "\t9\n"] * 1000,
])
def test_padded_chars_kernel_matches_plain(strings):
    from spark_rapids_jni_tpu_torch.ops.strings import to_padded

    valid = [i % 3 != 1 for i in range(len(strings))]
    before = rb.extract_strings_many.launches
    got, glens = to_padded(_string_column(strings, valid, "cuda"))
    torch.cuda.synchronize()
    # a column without characters is padded without a gather
    assert rb.extract_strings_many.launches == before + (1 if any(strings) else 0)
    want, wlens = to_padded(_string_column(strings, valid, "cpu"))
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want) and torch.equal(glens.cpu(), wlens)


def _int_strings(rng, n):
    vals = rng.integers(-(10**8), 10**8, n).tolist()
    strs = [str(v) for v in vals]
    extra = ["9223372036854775807", "-9223372036854775808", "-9223372036854775809",
             "18446744073709551615", "18446744073709551616", " +12 ", "12.7", "1 2", "", "abc"]
    strs[:len(extra)] = extra
    return strs, [i % 17 != 5 for i in range(n)]


@pytest.mark.parametrize("tn", ["INT8", "INT32", "INT64", "UINT16", "UINT64"])
def test_string_to_integer_on_the_card_matches_the_cpu(rng, tn):
    from spark_rapids_jni_tpu_torch.ops import cast_string

    strs, valid = _int_strings(rng, 20_000)
    got = cast_string.string_to_integer(_string_column(strs, valid, "cuda"), False, getattr(pdt, tn))
    want = cast_string.string_to_integer(_string_column(strs, valid, "cpu"), False, getattr(pdt, tn))
    assert torch.equal(got.data.cpu(), want.data) and torch.equal(got.validity.cpu(), want.validity)


def test_ansi_cast_on_the_card_raises_the_row(rng):
    from spark_rapids_jni_tpu_torch.ops import cast_string

    strs = [str(v) for v in rng.integers(-1000, 1000, 5000).tolist()]
    strs[3210] = "7q"
    with pytest.raises(cast_string.CastError) as e:
        cast_string.string_to_integer(_string_column(strs, [True] * 5000, "cuda"), True, pdt.INT64)
    assert (e.value.row_with_error, e.value.string_with_error) == (3210, "7q")


@pytest.mark.parametrize("precision,scale", [(38, -10), (18, -4), (9, -2)])
def test_string_to_decimal_on_the_card_matches_the_cpu(rng, precision, scale):
    from spark_rapids_jni_tpu_torch.ops import cast_string

    strs = []
    for i in range(20_000):
        k = int(rng.integers(1, 39))
        d = "".join(str(int(x)) for x in rng.integers(0, 10, k))
        p = int(rng.integers(0, k + 1))
        s = d[:p] + "." + d[p:] if i % 3 else d
        strs.append(("-" if i % 2 else "") + s + (f"e{int(rng.integers(-20, 21))}" if i % 5 == 0 else ""))
    valid = [i % 13 != 4 for i in range(len(strs))]
    got = cast_string.string_to_decimal(_string_column(strs, valid, "cuda"), False, precision, scale)
    want = cast_string.string_to_decimal(_string_column(strs, valid, "cpu"), False, precision, scale)
    assert got.dtype == want.dtype
    assert torch.equal(got.data.cpu(), want.data) and torch.equal(got.validity.cpu(), want.validity)


def _decimal_operands(rng, n, dev):
    from spark_rapids_jni_tpu_torch.interop import carry_table

    cols = []
    for _ in range(2):
        vals = [int(rng.integers(-10**18, 10**18)) * 10 ** int(rng.integers(0, 20)) for _ in range(n)]
        vals[::97] = [0] * len(vals[::97])
        blob = b"".join(v.to_bytes(16, "little", signed=True) for v in vals)
        cols.append(np.frombuffer(blob, np.uint32).reshape(n, 4))
    valid = [np.arange(n) % 19 != 3, None]
    return carry_table(cols, [pdt.decimal128(-10)] * 2, valid, device=dev).columns


# DECIMAL(38, 10) operands: a quotient scale s gives n_shift_exp = s, so 2
# takes the divide-twice regime, -40 the 10^38-split one, the rest the
# multiply-then-divide one
@pytest.mark.parametrize("op,scale", [("multiply128", -6), ("divide128", -6), ("divide128", -2),
                                      ("divide128", -30), ("divide128", 2), ("divide128", -40)])
def test_decimal_ops_on_the_card_match_the_cpu(op, scale):
    from spark_rapids_jni_tpu_torch.ops import decimal_utils

    out = {}
    for dev in ("cpu", "cuda"):
        a, b = _decimal_operands(np.random.default_rng(7), 4096, dev)
        out[dev] = getattr(decimal_utils, op)(a, b, scale)
    for g, w in zip(out["cuda"].columns, out["cpu"].columns):
        assert torch.equal(g.data.cpu(), w.data) and torch.equal(g.validity.cpu(), w.validity)


def test_limbs_on_the_card_match_the_cpu(rng):
    from spark_rapids_jni_tpu_torch.ops import limbs as L

    vals = [int(x) << int(s) for x, s in zip(rng.integers(0, 2**62, 3000), rng.integers(0, 194, 3000))]
    vals[:4] = [0, 1, 2**256 - 1, 10**76]
    dens = [v >> 97 or 1 for v in vals]
    dens[:3] = [0, 10**38, 2**255 + 1]
    num, den = torch.from_numpy(L.from_ints(vals, 8)), torch.from_numpy(L.from_ints(dens, 8))
    for fn in (lambda a, b: L.divmod_bits(a, b), lambda a, b: (L.mul(a, b, 8),),
               lambda a, b: L.sub(a, b), lambda a, b: (L.precision10(a), L.is_all_nines(a))):
        for g, w in zip(fn(num.cuda(), den.cuda()), fn(num, den)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("tn,ncols", [("INT32", 3), ("INT64", 4), ("DECIMAL128", 2), ("INT8", 5)])
def test_interleave_bits_on_the_card_matches_the_cpu(rng, tn, ncols):
    from spark_rapids_jni_tpu_torch.interop import carry_table
    from spark_rapids_jni_tpu_torch.ops import zorder

    n = 50_000
    if tn == "DECIMAL128":
        arrays = [rng.integers(0, 2**32, (n, 4), dtype=np.uint32) for _ in range(ncols)]
        d = pdt.decimal128(0)
    else:
        t = np.dtype(tn.lower())
        arrays = [rng.integers(np.iinfo(t).min, np.iinfo(t).max, n, dtype=t) for _ in range(ncols)]
        d = getattr(pdt, tn)
    valid = [rng.random(n) < 0.9] + [None] * (ncols - 1)
    out = {dev: zorder.interleave_bits(n, *carry_table(arrays, [d] * ncols, valid, device=dev).columns)
           for dev in ("cpu", "cuda")}
    assert torch.equal(out["cuda"].offsets.cpu(), out["cpu"].offsets)
    assert torch.equal(out["cuda"].child.data.cpu(), out["cpu"].child.data)


def test_unsigned_expressions_on_the_card_match_the_cpu(rng):
    from spark_rapids_jni_tpu_torch.interop import carry_table
    from spark_rapids_jni_tpu_torch.ops import expressions as ex

    n = 100_000
    arrays = [rng.integers(0, 2**32, n, dtype=np.uint32), rng.integers(0, 2**64, n, dtype=np.uint64),
              rng.integers(0, 2**64, n, dtype=np.uint64), rng.integers(-10**9, 10**9, n)]
    arrays[2][::7] = 0
    valid = [rng.random(n) < 0.95, None, None, None]
    exprs = [(ex.col("u32") + 7) % 1000 > 3, (ex.col("u64") + 7) % 1000 > 3,
             ex.col("u64") % ex.col("v64"), ex.col("u64") * ex.col("v64"), ex.col("u64") > ex.col("v64"),
             ex.col("u64") + ex.col("i64"), ex.col("u64").cast(pdt.UINT32), ex.col("u32") - 5,
             ex.col("u64").cast(pdt.FLOAT64), (ex.col("i64") * 1e9).cast(pdt.UINT64)]
    out = {}
    for dev in ("cpu", "cuda"):
        t = Table(carry_table(arrays, [pdt.UINT32, pdt.UINT64, pdt.UINT64, pdt.INT64], valid,
                              device=dev).columns, ["u32", "u64", "v64", "i64"])
        out[dev] = [e.evaluate(t) for e in exprs]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert g.dtype == w.dtype and torch.equal(g.data.cpu(), w.data)
        assert (g.validity is None) == (w.validity is None)
        assert g.validity is None or torch.equal(g.validity.cpu(), w.validity)


# -- the string and regex tier (ops/utf8, ops/strings, ops/regex) ----------
# chip_smoke.py's string_ops operations on a small table of its columns
# (emails, URLs, multilingual text, comma lists), on the card and on the CPU

STRING_OPS = [
    "length_email", "length_multi", "upper_email", "lower_url", "upper_multi", "lower_multi",
    "substring_email_3_5", "substring_url_0_12", "substring_email_-6_4", "substring_multi_2_3",
    "concat", "concat_ws", "contains_at", "startswith_https", "endswith_com", "strip_multi",
    "instr_multi", "utf8_roundtrip", "contains_re_digits", "matches_re_email", "extract_re_0",
    "extract_re_1", "extract_re_2", "split_re_-1", "split_re_3", "split_re_0", "replace_re_digits",
]


@pytest.fixture(scope="module")
def string_ops_tables():
    import chip_smoke

    return {dev: chip_smoke._string_ops_inputs(20261017, 6000, device=dev)[1]
            for dev in ("cpu", "cuda")}


def _same_string_result(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_string_result(g, w)
        return
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
        return
    assert got.dtype == want.dtype and len(got) == len(want)
    for part in ("data", "offsets", "chars", "validity"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        assert g is None or torch.equal(g.cpu(), w), part


@pytest.mark.parametrize("name", STRING_OPS)
def test_string_op_on_the_card_matches_the_cpu(string_ops_tables, name):
    import chip_smoke

    ops = {dev: chip_smoke._string_ops(t) for dev, t in string_ops_tables.items()}
    assert sorted(ops["cuda"]) == sorted(STRING_OPS)
    got, _, _, launches, predicted = chip_smoke._capture_string_ops(ops["cuda"][name])
    torch.cuda.synchronize()
    assert launches == predicted  # one B8 launch a padding call, one B5 a nonzero compaction
    _same_string_result(got, ops["cpu"][name]())


@pytest.mark.parametrize("values", [[], [None, None], ["", ""], ["ab", None, "", "日本"]])
def test_string_edges_on_the_card_match_the_cpu(values):
    from spark_rapids_jni_tpu_torch.columnar import Column
    from spark_rapids_jni_tpu_torch.ops import regex, strings

    cols = {dev: Column.from_pylist(values, pdt.STRING, device=dev) for dev in ("cpu", "cuda")}
    calls = [lambda c: strings.upper(c), lambda c: strings.substring(c, 2, 1),
             lambda c: strings.concat([c, c], b","), lambda c: strings.instr(c, b"b"),
             lambda c: regex.extract_re(c, r"(\w)", 1), lambda c: regex.split_re(c, "b", 0),
             lambda c: regex.replace_re(c, r"\w", b"__")]
    for call in calls:
        _same_string_result(call(cols["cuda"]), call(cols["cpu"]))


@pytest.mark.parametrize("extra", [0, 1, 3])
def test_utf8_codec_on_the_card_matches_the_cpu(rng, extra):
    from spark_rapids_jni_tpu_torch.ops import utf8

    n, L = 3000, 21 + extra  # widths that are not a multiple of 4
    mat = rng.integers(0, 256, (n, L), dtype=np.uint8)  # malformed UTF-8 almost everywhere
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        cp, cp_lens, byte_off = utf8.decode_padded(torch.from_numpy(mat).to(dev),
                                                   torch.from_numpy(lens).to(dev))
        out[dev] = (cp, cp_lens, byte_off, *utf8.encode_padded(cp, cp_lens))
    for g, w in zip(out["cuda"], out["cpu"]):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_regex_device_tables_are_cached_per_device():
    from spark_rapids_jni_tpu_torch.ops import regex

    prog = regex.compile_pattern(r"[\w.]+@\w+")
    tables = prog.device_tables("cuda")
    assert prog.device_tables(torch.device("cuda")) is tables
    assert all(t.is_cuda for t in tables) and prog.device_tables("cpu")[0].device.type == "cpu"


# ---------------------------------------------------------------------------
# the data plane and IO: the readers' device work, frames, nested handles.
# The files come from the harness writers (no pyarrow on the card's host).
# ---------------------------------------------------------------------------


def _same_column(g, w, where="column"):
    assert g.dtype == w.dtype, where
    for f in ("data", "validity", "offsets", "chars"):
        a, b = getattr(g, f), getattr(w, f)
        assert (a is None) == (b is None), (where, f)
        if a is not None:
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b), (where, f)
    if g.child is not None:
        _same_column(g.child, w.child, where + ".child")
    for i, (a, b) in enumerate(zip(g.children or (), w.children or ())):
        _same_column(a, b, f"{where}.{i}")


def _same_table(g, w, names=True):
    assert not names or g.names == w.names
    assert g.num_columns == w.num_columns
    for nm, a, b in zip(w.names, g.columns, w.columns):
        _same_column(a, b, nm)


@pytest.fixture(scope="module")
def io_files():
    import torch_io_writers as writers

    cols = writers.lineitem_columns(20_000, 91)
    small = dict(row_group_bytes=300_000, page_bytes=30_000, dict_bytes=8_000)
    rng = np.random.default_rng(92)
    n = 3000
    nulls = [writers.Col("all_null", "int32", np.zeros(n, np.int32), np.zeros(n, bool)),
             writers.Col("some_null", "double", rng.standard_normal(n), rng.random(n) > 0.5),
             writers.Col("str_null", "string", writers.lineitem_strings(n, 93)[1],
                         rng.random(n) > 0.3)]
    return {
        "snappy": writers.write_parquet(cols, "snappy", **small),
        "uncompressed": writers.write_parquet(cols, None, **small),
        "nulls": writers.write_parquet(nulls, "snappy", **small),
        "empty": writers.write_parquet([writers.Col("x", "int32", np.zeros(0, np.int32))], None),
        "orc": writers.write_orc(cols, stripe_bytes=300_000, block=8192),
        "nested": writers.write_parquet_nested(writers.nested_data(5000, 94), "snappy",
                                               rows_per_page=700),
    }


@pytest.mark.parametrize("name", ["snappy", "uncompressed", "nulls", "empty", "nested"])
def test_parquet_read_on_the_card_matches_the_cpu(io_files, name):
    from spark_rapids_jni_tpu_torch.io import parquet_reader

    got = parquet_reader.read_table(io_files[name], device="cuda")
    torch.cuda.synchronize()
    _same_table(got, parquet_reader.read_table(io_files[name], device="cpu"))


def test_parquet_read_defaults_to_the_card(io_files):
    from spark_rapids_jni_tpu_torch.io import codecs, parquet_reader

    before = codecs.CALLS["snappy"]
    t = parquet_reader.read_table(io_files["snappy"])
    assert all(c.device.type == "cuda" for c in t.columns)
    assert codecs.CALLS["snappy"] > before  # the native codec, no pyarrow here


def test_orc_read_on_the_card_matches_the_cpu(io_files):
    from spark_rapids_jni_tpu_torch.io import orc_reader

    got = orc_reader.read_table(io_files["orc"], device="cuda")
    _same_table(got, orc_reader.read_table(io_files["orc"], device="cpu"))


def test_rle_expansion_on_the_card_clamps_like_jax():
    import torch_io_writers as writers
    from spark_rapids_jni_tpu_torch.io import parquet_reader as pr

    vals = np.random.default_rng(95).integers(0, 4096, 5000).astype(np.uint32)
    data = writers.rle_hybrid(vals, 12)
    got = pr._rle_expand_device(data, 12, vals.size, torch.device("cuda"))
    assert torch.equal(got.cpu(), torch.from_numpy(vals.astype(np.int32)))
    # an RLE run whose literal is far past the stream: the clamped window
    # index keeps the gather inside the buffer (no device assert)
    run = writers._varint(200 << 1) + (4000).to_bytes(2, "little")
    got = pr._rle_expand_device(run, 12, 200, torch.device("cuda"))
    torch.cuda.synchronize()
    assert got.cpu().tolist() == [4000] * 200


def test_dictionary_take_on_the_card_clamps_like_jax():
    from spark_rapids_jni_tpu_torch.io import parquet_reader as pr

    page = b"".join(len(v).to_bytes(4, "little") + v for v in (b"a", b"bb", b"ccc"))
    d = pr._Dictionary(page, pr._T_BYTE_ARRAY, 3, torch.device("cuda"))
    got = d.take(torch.tensor([0, 2, 9, -1], dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert got.lens.cpu().tolist() == [1, 3, 3, 1]
    assert bytes(got.chars.cpu().numpy()) == b"acccccca"


@pytest.mark.parametrize("lens", [[], [0, 0], [3, 0, 5, 1]])
def test_ragged_positions_on_the_card(lens):
    from spark_rapids_jni_tpu_torch.ops import bitutils

    x = torch.tensor(lens, dtype=torch.int32)
    for g, w in zip(bitutils.ragged_positions(x.cuda()), bitutils.ragged_positions(x)):
        if isinstance(w, int):
            assert g == w
        else:
            assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("checked", [True, False])
def test_frames_on_the_card(io_files, checked):
    from spark_rapids_jni_tpu_torch.columnar import frames
    from spark_rapids_jni_tpu_torch.io import parquet_reader
    from spark_rapids_jni_tpu_torch.utils import integrity
    from spark_rapids_jni_tpu_torch.utils.errors import DataCorruption

    t = parquet_reader.read_table(io_files["nulls"], device="cuda")
    with (integrity.enabled() if checked else integrity.disabled()):
        buf = frames.encode_table(t)
        assert buf == frames.encode_table(parquet_reader.read_table(io_files["nulls"],
                                                                    device="cpu"))
        back = frames.decode_table(buf)
    # a decoded frame carries default column names
    _same_table(back, parquet_reader.read_table(io_files["nulls"], device="cpu"), names=False)
    if checked:
        bad = bytearray(buf)
        bad[-2] ^= 1
        with integrity.enabled(), pytest.raises(DataCorruption):
            frames.decode_table(bytes(bad))


def test_read_rows_on_the_card_match_the_cpu(io_files):
    from spark_rapids_jni_tpu_torch.io import parquet_reader

    rows = {dev: rc.convert_to_rows(parquet_reader.read_table(io_files["snappy"], device=dev))
            for dev in ("cpu", "cuda")}
    assert torch.equal(rows["cuda"][0].child.data.cpu(), rows["cpu"][0].child.data)
    assert torch.equal(rows["cuda"][0].offsets.cpu(), rows["cpu"][0].offsets)


def test_nested_handles_on_the_card():
    from spark_rapids_jni_tpu_torch.columnar import Column

    kid = Column.from_numpy(np.arange(4, dtype=np.int64))
    s = Column.struct_from_parts([kid], ["k"], validity=np.array([1, 0, 1, 1], bool))
    lst = Column.list_from_parts(np.array([0, 1, 1, 4], np.int32),
                                 Column.from_numpy(np.arange(4, dtype=np.int32)))
    assert s.device.type == "cuda" and s.validity.is_cuda and lst.offsets.is_cuda
    assert s.to_pylist() == [{"k": 0}, None, {"k": 2}, {"k": 3}]
    assert lst.to_pylist() == [[0], [], [1, 2, 3]]


# -- the in-mesh distribution tier: 8 shards on one card against 8 on the CPU


@pytest.fixture
def meshes8():
    from spark_rapids_jni_tpu_torch.parallel.mesh import make_mesh

    return {dev: make_mesh({"data": 8}, devices=[torch.device(dev)] * 8)
            for dev in ("cpu", "cuda:0")}


def _on_both(fn, *arrays):
    """``fn(mesh, *tensors)`` on the card's mesh and the CPU's."""
    return [fn(dev, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays))
            for dev in ("cuda:0", "cpu")]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (list, tuple)):
        return [_host(y) for y in x]
    return x


def _assert_same(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want


def test_exchange_on_the_card_matches_the_cpu_mesh(meshes8, rng):
    from spark_rapids_jni_tpu_torch.parallel import shuffle

    n = 8 * 4096
    vals = rng.integers(-2**62, 2**62, n, dtype=np.int64)
    neg = rng.integers(-2**31, 0, n).astype(np.int32)
    dest = rng.integers(0, 8, n).astype(np.int32)
    got, want = _on_both(lambda dev, v, w, d: _host(shuffle.all_to_all_exchange(
        [v, w], d, meshes8[dev])), vals, neg, dest)
    _assert_same(got, want)
    assert got[1].sum() == n and not got[2].any()


def test_distributed_groupby_on_the_card_matches_the_cpu_mesh(meshes8, rng):
    from spark_rapids_jni_tpu_torch.parallel import distributed

    n = 8 * 4096
    keys = rng.integers(0, 4096, n).astype(np.int64)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    before = hk.partition_map.launches
    got, want = _on_both(lambda dev, k, v: list(distributed.distributed_groupby_sum(
        k, v, meshes8[dev])), keys, vals)
    assert hk.partition_map.launches == before + 8  # B1 once a shard
    _assert_same(got, want)
    got, want = _on_both(lambda dev, a, b, v: list(distributed.distributed_groupby_sum_multi(
        [a, b], v, meshes8[dev])), (keys % 64).astype(np.int32), (keys // 64).astype(np.int32),
        vals)
    _assert_same(got, want)


def test_distributed_join_and_sort_on_the_card_match_the_cpu_mesh(meshes8, rng):
    from spark_rapids_jni_tpu_torch.parallel import join_distributed, sort_distributed

    n = 8 * 2048
    lk, rk = rng.integers(0, 5000, n).astype(np.int64), np.arange(n, dtype=np.int64)
    lv, rv = rng.integers(0, 1000, n).astype(np.int32), rng.standard_normal(n)
    got, want = _on_both(lambda dev, *a: list(join_distributed.distributed_inner_join(
        *a, meshes8[dev])), lk, lv, rk, rv)
    _assert_same(got, want)
    skewed = np.where(rng.random(n) < 0.9, 7, rng.integers(-2**62, 2**62, n)).astype(np.int64)
    for keys in (rng.integers(-2**62, 2**62, n, dtype=np.int64), skewed):
        for desc in (False, True):
            got, want = _on_both(lambda dev, k: list(sort_distributed.distributed_sort(
                k, meshes8[dev], descending=desc)), keys)
            _assert_same(got, want)
            assert not got[1]
            np.testing.assert_array_equal(got[0], np.sort(keys)[::-1] if desc else np.sort(keys))


@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_single_key_destinations_run_b1(rng, np_dt):
    from spark_rapids_jni_tpu_torch.parallel import distributed

    keys = torch.from_numpy(rng.integers(-2**31, 2**31, 100_003).astype(np_dt))
    before = hk.partition_map.launches
    got = distributed._hash_dest(keys.cuda(), 8)
    torch.cuda.synchronize()
    assert hk.partition_map.launches == before + 1
    assert torch.equal(got.cpu(), hk.partition_map_plain(keys, 8))
    # composite keys chain murmur3: no B1
    distributed._hash_dest_multi([keys.cuda(), keys.cuda()], 8)
    assert hk.partition_map.launches == before + 1


def test_exchange_overflow_raises_on_the_card(meshes8):
    from spark_rapids_jni_tpu_torch.parallel import shuffle
    from spark_rapids_jni_tpu_torch.utils.errors import RetryableError

    vals = torch.arange(8 * 64, device="cuda")
    dest = torch.zeros((8 * 64,), dtype=torch.int32, device="cuda")
    with pytest.raises(RetryableError):
        shuffle.all_to_all_exchange([vals], dest, meshes8["cuda:0"], capacity=4)
    (r,), m, o = shuffle.all_to_all_exchange([vals], dest, meshes8["cuda:0"], capacity=4,
                                             on_overflow="retry")
    assert r.is_cuda and not bool(o.any()) and int(m.sum()) == 8 * 64


def test_table_tier_on_the_card_matches_the_cpu_mesh(meshes8):
    from spark_rapids_jni_tpu_torch.models import tpcds

    web = {dev: tpcds.gen_web(8000, seed=13, device=dev) for dev in ("cpu", "cuda")}
    got = tpcds.q95_distributed(web["cuda"], meshes8["cuda:0"])
    assert got == tpcds.q95_distributed(web["cpu"], meshes8["cpu"]) == tpcds.q95(web["cpu"])
    store = {dev: tpcds.gen_store(20000, seed=12, device=dev) for dev in ("cpu", "cuda")}
    g = tpcds.q52_distributed(store["cuda"], meshes8["cuda:0"])
    w = tpcds.q52_distributed(store["cpu"], meshes8["cpu"])
    assert g.names == w.names and g.num_rows == w.num_rows > 0
    for a, b in zip(g.columns, w.columns):
        assert a.data.is_cuda and torch.equal(a.data.cpu(), b.data)


def test_mesh_and_executor_raise_without_a_card(monkeypatch):
    from spark_rapids_jni_tpu_torch.parallel import device, mesh

    assert mesh.make_mesh().shape == {"data": torch.cuda.device_count()}
    assert device.device_for_executor(0).type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.device_for_executor(0)


# -- the runtime core around the ops (op_boundary) ------------------------------------


def test_an_oom_inside_a_wrapped_op_is_retryable():
    from spark_rapids_jni_tpu_torch.utils.dispatch import op_boundary
    from spark_rapids_jni_tpu_torch.utils.errors import RetryableError

    free, total = torch.cuda.mem_get_info()

    @op_boundary("t.alloc")
    def alloc(nbytes):
        return torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    with pytest.raises(RetryableError, match="CUDA out of memory") as ei:
        alloc(total + (1 << 30))
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    assert alloc(1 << 20).numel() == 1 << 20


def test_a_refused_launch_in_a_wrapped_op_is_fatal_and_not_retried(rng, monkeypatch):
    from spark_rapids_jni_tpu_torch import _build
    from spark_rapids_jni_tpu_torch.utils import retry
    from spark_rapids_jni_tpu_torch.utils.errors import FatalDeviceError

    calls = []

    class _Refused:
        def __getattr__(self, name):
            def launch(*args):
                calls.append(name)
                return 9  # cudaErrorInvalidConfiguration
            return launch

    table = Table.from_numpy([rng.integers(0, 100, 1000).astype(np.int64)], [pdt.INT64],
                             device="cuda")
    monkeypatch.setattr(_build, "library", lambda name: _Refused())
    rb.expand_u32_planes.launches = 0
    retry.reset_stats()
    with retry.enabled(max_attempts=4, base_delay_ms=0):
        with pytest.raises(FatalDeviceError, match="CUDA launch of expand_u32_planes failed: "
                                                   "cudaError 9"):
            rc.convert_to_rows(table)
    assert calls == ["expand_u32_planes_launch"]  # attempted exactly once
    assert rb.expand_u32_planes.launches == 0
    assert retry.stats()["fatal"] == 1 and retry.stats()["retries"] == 0


def test_the_profiler_sees_the_op_range_around_its_kernel(rng):
    import chip_smoke
    from spark_rapids_jni_tpu_torch.ops import join as pjoin

    table = Table.from_numpy([rng.integers(0, 100, 100_000).astype(np.int64)], [pdt.INT64],
                             names=["k"], device="cuda")
    dim = Table.from_numpy([np.arange(100, dtype=np.int64)], [pdt.INT64], names=["k"],
                           device="cuda")
    # the helper retakes a trace that misses a launch, and raises when a
    # range holds no kernel of the expected name
    got = chip_smoke._ranges_enclose(
        lambda: (rc.convert_to_rows(table), pjoin.inner_join(table, dim, ["k"])),
        {"convert_to_rows": "expand", "inner_join": "probe"})
    assert any("expand" in n for n in got["ranges"]["convert_to_rows"])
    assert any("probe" in n for n in got["ranges"]["inner_join"])


def test_tcp_exchange_pair_lands_partitions_on_the_card(rng):
    """An in-process TcpExchange pair on cuda:0: each rank's hash_partition
    launches B1 (bit for bit its plain version), every fetched partition is
    decoded onto cuda:0, and each rank receives what a CPU pair receives."""
    import threading

    from spark_rapids_jni_tpu_torch.ops import hashing
    from spark_rapids_jni_tpu_torch.ops.copying import slice_table
    from spark_rapids_jni_tpu_torch.parallel import shuffle

    rows = 50_000
    keys = rng.integers(-2**40, 2**40, rows).astype(np.int64)
    valid = rng.random(rows) > 0.1
    vals = rng.integers(-1000, 1000, rows).astype(np.int64)
    calls, lock = [], threading.Lock()
    real = hashing.partition_map

    def rec(k, p, v=None):
        out = real(k, p, v)
        with lock:
            calls.append((k, p, v, out))
        return out

    def world(device):
        full = Table.from_numpy([keys, vals], [pdt.INT64, pdt.INT64], [valid, None],
                                names=["k", "v"], device=device)
        exs = [shuffle.TcpExchange(r, device=device) for r in (0, 1)]
        out = {}
        try:
            def run(r):
                lo, hi = shuffle._shard_bounds(rows, 2, r)
                out[r] = exs[r].exchange_table(slice_table(full, lo, hi), ["k"],
                                               {1 - r: exs[1 - r].address})

            threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert set(out) == {0, 1}
        finally:
            for ex in exs:
                ex.close()
        return out

    hk.partition_map.launches = 0
    hashing.partition_map = rec
    try:
        card = world("cuda")
    finally:
        hashing.partition_map = real
    assert len(calls) == 2 and hk.partition_map.launches == 2
    for k, p, v, got in calls:
        assert k.is_cuda and torch.equal(got, hk.partition_map_plain(k, p, v))
    cpu = world("cpu")
    for r in (0, 1):
        for a, b in zip(card[r].columns, cpu[r].columns):
            assert a.data.device == torch.device("cuda", torch.cuda.current_device())
            assert torch.equal(a.data.cpu(), b.data)
            assert (a.validity is None) == (b.validity is None)
            if a.validity is not None:
                assert torch.equal(a.validity.cpu(), b.validity)



def _plan_tables_to_cpu(tabs):
    from spark_rapids_jni_tpu_torch.columnar import Column

    return {k: Table([Column(c.dtype, data=c.data.cpu(),
                             validity=None if c.validity is None else c.validity.cpu())
                      for c in t.columns], list(t.names)) for k, t in tabs.items()}


@pytest.mark.parametrize("name", ["q1", "q10", "q38", "q9", "q27", "q73"])
def test_plan_query_on_the_card_matches_the_cpu(name):
    """A compiled registry plan over card tables equals the same plan over
    the same tables on the CPU, bit for bit; its operator-tier single-key
    joins launch B4 on the card (as many as the CPU run takes its plain
    version)."""
    from spark_rapids_jni_tpu_torch import plan as P
    from spark_rapids_jni_tpu_torch.models import tpcds_plans as tp
    from spark_rapids_jni_tpu_torch.ops import join

    d = tp.PLAN_QUERIES[name]
    tabs = d.gen(6000, device="cuda")
    cpu_tabs = _plan_tables_to_cpu(tabs)
    calls = []
    real = join.probe_paged

    def rec(*args):
        calls.append(args[0].device.type)
        return real(*args)

    join.probe_paged = rec
    try:
        want = P.compile_ir(d.plan(), cpu_tabs, name=name)()
        before = hk.probe_paged.launches
        cp = P.compile_ir(d.plan(), tabs, name=name)
        got = cp()
        torch.cuda.synchronize()
    finally:
        join.probe_paged = real
    _same_table(got, want)
    assert hk.probe_paged.launches - before == calls.count("cuda") == calls.count("cpu")
    assert cp.last_report["memgov_admitted_bytes"] == 0


def test_plan_ppart_on_the_card_runs_b1(rng):
    from spark_rapids_jni_tpu_torch import plan as P

    keys = rng.integers(-2**31, 2**31, 100_003, dtype=np.int64).astype(np.int32)
    t = Table.from_numpy([keys], [pdt.INT32], names=["k"], device="cuda")
    ir = P.Filter(P.Scan("t"), P.ppart(("k",), 7) == P.plit(np.int32(3)))
    before = hk.partition_map.launches
    got = P.compile_ir(ir, {"t": t}, name="ppart")()
    torch.cuda.synchronize()
    assert hk.partition_map.launches == before + 1
    cpu = Table.from_numpy([keys], [pdt.INT32], names=["k"], device="cpu")
    _same_table(got, P.compile_ir(ir, {"t": cpu}, name="ppart")())
