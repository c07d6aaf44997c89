"""Port: the block plans of the two ragged gathers in csrc/strings.cu, B5
``ragged_compact_rows_kernel`` (``hopper_kernels.ragged_compact`` /
``ragged_compact_many``) and ``assemble_rows_kernel``
(``ragged_bytes.assemble_rows``), emulated in numpy on the CPU.

``_emulate_compact`` follows the B5 kernel block by block: the grid over
the columns (``compact_block_plan`` and each block's search for its
column), the block's output words, its first and last row by the
block-wide search over the offsets (``block_find_rows``, itself held
against a binary search), the rows it stages (or, past the cap, reads in
place), each thread's 16-byte chunk with its owner found among the staged
rows, the segments of a chunk one row each (zero-length rows skipped by a
search), and each segment read as aligned 32-bit pool words funnelled into
the chunk, bytes outside the pool read as 0 (the pool may start 1-3 bytes
past a word). ``_emulate_assemble`` follows ``assemble_rows_kernel``: the
block's byte range and rows, each row's words of a part that land in the
range, the row-major parts copied a row at a time, the transposed parts
through the shared-memory tile thread by thread, and the words past the
parts zero. Both
are held against the plain versions, against the JAX package's
``ragged_compact`` and ``assemble_rows`` (their own CPU formulations), and
against numpy ragged gathers, at small sizes and with small blocks so that
every boundary case falls in a few hundred bytes. Every output is bytes:
every comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import ragged_bytes as jrb

from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb

CSRC = Path(rb.__file__).resolve().parent.parent / "csrc" / "strings.cu"

_jax_ragged_compact = jax.jit(jrb.ragged_compact, static_argnums=(3,))
_jax_assemble_rows = jax.jit(jrb.assemble_rows, static_argnums=(3, 4))


def _constant(name):
    """A constexpr integer of strings.cu, a literal or a quotient of one."""
    expr = re.search(rf"constexpr int(?:64_t)? {name} = ([^;]+);", CSRC.read_text()).group(1)
    expr = expr.replace("(int)", "").replace("(", "").replace(")", "")
    if "/" in expr:
        a, b = expr.split("/")
        return _constant(a.strip()) // int(b) if not a.strip().isdigit() else int(a) // int(b)
    return int(expr)


def _last_at_or_below(off, lo, hi, b):
    """The kernels' binary search: the last i in [lo, hi] with off(i) <= b."""
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if off(mid) <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _block_find_rows(off, n, t0, t1, half, rounds=None):
    """``block_find_rows``: two halves of ``half`` threads narrow [0, n-1]
    to the last row at or below t0, resp. t1, each thread probing one row
    a round and the half counting its probes at or below its target."""
    lo, hi = [0, 0], [n - 1, n - 1]
    targets = (t0, t1)
    while lo[0] < hi[0] or lo[1] < hi[1]:
        for h in (0, 1):
            if lo[h] < hi[h]:
                step = (hi[h] - lo[h] + half - 1) // half
                probes = [lo[h] + (j + 1) * step for j in range(half)]
                votes = [p <= hi[h] and off(p) <= targets[h] for p in probes]
                c = sum(votes)
                assert votes == [True] * c + [False] * (half - c)  # a prefix
                lo[h], hi[h] = lo[h] + c * step, min(hi[h], lo[h] + (c + 1) * step - 1)
        if rounds is not None:
            rounds[0] += 1
    return lo[0], lo[1]


# a block's first and last row by the block-wide search, against the
# plain binary search: a million rows in three rounds of 128 probes
@pytest.mark.parametrize("n,half,kind", [(1, 128, "plain"), (2, 128, "zero_runs"),
                                         (1000, 128, "plain"), (5000, 4, "zero_runs"),
                                         (1_000_000, 128, "plain"), (300_000, 256, "zero_runs")])
def test_block_find_rows_matches_a_binary_search(rng, n, half, kind):
    lens = rng.integers(1, 33, n)
    if kind == "zero_runs":
        lens[rng.random(n) < 0.99] = 0
    offs = np.concatenate([[0], np.cumsum(lens)])
    total = int(offs[-1])
    for t0 in sorted(rng.integers(0, max(total, 1), 20).tolist()) + [0, max(total - 1, 0)]:
        t1 = min(total - 1, t0 + int(rng.integers(0, 9000))) if total else 0
        rounds = [0]
        got = _block_find_rows(lambda r: int(offs[r]), n, t0, max(t0, t1), half, rounds)
        want = (_last_at_or_below(lambda r: int(offs[r]), 0, n - 1, t0),
                _last_at_or_below(lambda r: int(offs[r]), 0, n - 1, max(t0, t1)))
        assert got == want
        assert rounds[0] <= max(1, int(np.ceil(np.log(n) / np.log(half))) + 1)


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------


class _Pool:
    """The pool as the kernel sees it: aligned words from 1-3 bytes before
    its start (``mis``), bytes outside it garbage that the masks drop."""

    def __init__(self, pool: np.ndarray, mis: int):
        self.mis, self.lim = mis, mis + pool.shape[0]
        al = np.full(self.lim + 8, 0xA5, np.uint8)
        al[mis:self.lim] = pool
        self.words = al[: (al.shape[0] // 4) * 4].view("<u4").astype(np.int64)

    def word(self, q):
        b = 4 * q
        if b + 4 <= self.mis or b >= self.lim:
            return 0
        v = int(self.words[q])
        if b < self.mis:
            v &= (0xFFFFFFFF << (8 * (self.mis - b))) & 0xFFFFFFFF
        if b + 4 > self.lim:
            v &= 0xFFFFFFFF >> (8 * (b + 4 - self.lim))
        return v

    def funnel_into(self, o, a0, lo, hi):
        sh = (a0 & 3) * 8
        q0 = a0 >> 2
        t0, t1 = lo >> 2, (hi - 1) >> 2
        cur = self.word(q0 + t0)
        for t in range(t0, t1 + 1):
            nxt = self.word(q0 + t + 1) if (sh or t < t1) else 0
            v = cur if sh == 0 else ((cur >> sh) | (nxt << (32 - sh))) & 0xFFFFFFFF
            blo, bhi = max(lo - 4 * t, 0), min(hi - 4 * t, 4)
            keep = (0xFFFFFFFF if bhi >= 4 else (1 << (8 * bhi)) - 1) & (0xFFFFFFFF << (8 * blo))
            o[t] |= v & keep
            cur = nxt


def _emulate_compact(pool, mis, cols, words, cap, stats=None):
    """B5's launch over ``cols`` [(base int64 [N], offs [N+1], total)] in
    numpy: the wrapper drops empty columns, then block by block as the
    kernel runs. Returns one uint8 [total] array a column."""
    p = _Pool(pool, mis)
    live = [k for k, c in enumerate(cols) if c[2]]
    first, blocks = hk.compact_block_plan([cols[k][2] for k in live], words)
    outs = {k: np.full((cols[k][2] + 3) // 4, 0xDEADBEEF, np.int64) for k in live}
    for blk in range(blocks):
        j = _last_at_or_below(lambda i: first[i], 0, len(live) - 1, blk)
        base, offs, total = cols[live[j]]
        out = outs[live[j]]
        nwords = (total + 3) // 4
        w0 = (blk - first[j]) * words
        w1 = min(w0 + words, nwords)
        b_lo, b_hi = 4 * w0, min(4 * w1, total)
        n = base.shape[0]
        r0, r1 = _block_find_rows(lambda r: int(offs[r]), n, b_lo, b_hi - 1, half=128)
        rows = r1 - r0 + 1
        staged = rows <= cap
        if stats is not None:
            stats["staged" if staged else "in_place"] += 1
        # staged or in place, the block reads its rows' offsets and bases
        s_offs = [int(offs[r0 + i]) for i in range(rows + 1)]
        s_base = [int(base[r0 + i]) for i in range(rows)]
        off, bas = s_offs.__getitem__, s_base.__getitem__
        for q in range(w0, w1, 4):  # one thread's chunk
            o = [0, 0, 0, 0]
            c0, cend = 4 * q, min(4 * q + 16, b_hi)
            i = _last_at_or_below(off, 0, rows - 1, c0)
            b = c0
            while True:  # one segment a row: row i owns byte b
                se = min(off(i + 1), cend)
                p.funnel_into(o, mis + bas(i) + (c0 - off(i)), b - c0, se - c0)
                if se >= cend:
                    break
                b = se  # the next row with a byte here, past zero-length ones
                i = i + 1 if off(i + 2) > b else _last_at_or_below(off, i + 1, rows - 1, b)
            for t in range(min(4, w1 - q)):
                out[q + t] = o[t]
    res = []
    for k, (_, _, total) in enumerate(cols):
        if k not in outs:
            res.append(np.zeros(0, np.uint8))
            continue
        assert (outs[k] != 0xDEADBEEF).all()  # every word written
        res.append(outs[k].astype("<u4").view(np.uint8)[:total])
    return res


def _compact_case(rng, kind, ncols=3):
    """(pool, [K] int64 bases, [K] offsets, [K] totals, mis) for one input
    class: K string columns laid out in rows as the decode reads them."""
    n, max_len, null_frac, mis, tail = {
        "plain": (200, 32, 0.1, 0, 0),
        "all_null_and_empty": (50, 32, 1.0, 0, 3),
        "zero_runs": (900, 16, 0.97, 0, 0),
        "short_strings": (600, 3, 0.0, 0, 0),
        "one_long_row": (40, 16, 0.0, 2, 0),
        "unaligned_pool": (150, 32, 0.2, 1, 0),
        "pool_end": (30, 32, 0.0, 3, 0),
        "one_row": (1, 29, 0.0, 1, 0),
    }[kind]
    lens = rng.integers(1, max_len + 1, (n, ncols))
    lens[rng.random((n, ncols)) < null_frac] = 0
    if kind == "one_long_row":
        lens[n // 2, 0] = 700
    if kind in ("pool_end", "unaligned_pool", "plain"):
        lens[-1, -1] = max(lens[-1, -1], 5)  # the last string ends at the pool's last byte
    fixed = 12
    slot = fixed + np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(lens, 1)[:, :-1]], 1)
    sizes = fixed + lens.sum(1) + rng.integers(0, 8, n)
    sizes[-1] = fixed + lens[-1].sum()
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pool = rng.integers(1, 256, int(sizes.sum()) + tail).astype(np.uint8)
    offs = [np.concatenate([[0], np.cumsum(lens[:, c])]).astype(np.int64) for c in range(ncols)]
    bases = [(starts + slot[:, c]).astype(np.int64) for c in range(ncols)]
    return pool, bases, offs, [int(o[-1]) for o in offs], mis


def _gather(pool, base, offs):
    parts = [pool[b : b + (e - s)] for b, s, e in zip(base, offs[:-1], offs[1:])]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


# (input class, output words a block, rows a block stages): blocks of 8
# words with a cap of 6 rows put the block boundaries, the cap and the
# halo bytes of a block's last word inside a few hundred bytes; the
# kernel's own constants run once per class too
@pytest.mark.parametrize("kind", ["plain", "all_null_and_empty", "zero_runs", "short_strings",
                                  "one_long_row", "unaligned_pool", "pool_end", "one_row"])
@pytest.mark.parametrize("words,cap", [(8, 6), (4, 1536), (2048, 1536)])
def test_emulated_compact_matches_plain_and_jax(rng, kind, words, cap):
    pool, bases, offs, totals, mis = _compact_case(rng, kind)
    stats = {"staged": 0, "in_place": 0}
    got = _emulate_compact(pool, mis, list(zip(bases, offs, totals)), words, cap, stats)
    for g, b, o, t in zip(got, bases, offs, totals):
        np.testing.assert_array_equal(g, _gather(pool, b, o))
        want = hk.ragged_compact_plain(torch.from_numpy(pool), torch.from_numpy(b),
                                       torch.from_numpy(o), t)
        np.testing.assert_array_equal(g, want.numpy())
    if words == 8 and kind != "one_row":
        # the JAX package's formulation, once a class (it compiles a shape)
        b, o, t = bases[0], offs[0], totals[0]
        jwant = np.asarray(_jax_ragged_compact(jnp.asarray(pool), jnp.asarray(b), jnp.asarray(o), t))
        np.testing.assert_array_equal(got[0], jwant)
    if (words, cap) == (8, 6) and kind in ("zero_runs", "short_strings"):
        assert stats["in_place"] > 0  # a block over more rows than it stages
    if (words, cap) == (2048, 1536) and any(totals):
        assert stats["staged"] > 0


# the columns a launch takes: empty ones get no block, the others their
# word count's blocks in order
@pytest.mark.parametrize("totals,words,want", [
    ([5], 2048, ([0], 1)),
    ([8192, 8193, 0, 1], 2048, ([0, 1, 3, 3], 4)),
    ([0, 0], 8, ([0, 0], 0)),
    ([33, 32, 31], 8, ([0, 2, 3], 4)),
    ([4 * 2048 * 7 + 1], 2048, ([0], 8)),
    ([16_500_000] * 16, 2048, ([k * 2015 for k in range(16)], 16 * 2015)),
])
def test_compact_block_plan(totals, words, want):
    assert hk.compact_block_plan(totals, words) == want


@pytest.mark.parametrize("ncols", [1, 16, 40])
def test_compact_many_on_the_cpu_matches_plain(rng, ncols):
    # row starts plus u32 slot offsets, as the decode hands them over
    pool, bases, offs, totals, _ = _compact_case(rng, "plain", ncols)
    n = bases[0].shape[0]
    starts = bases[0] - 12
    slots = [torch.from_numpy((b - starts).astype(np.int32)) for b in bases]
    before = (hk.ragged_compact_many.launches, hk.ragged_compact.launches)
    got = hk.ragged_compact_many(torch.from_numpy(pool),
                                 [(s, torch.from_numpy(o.astype(np.int32)), t)
                                  for s, o, t in zip(slots, offs, totals)],
                                 row_starts=torch.from_numpy(starts))
    assert (hk.ragged_compact_many.launches, hk.ragged_compact.launches) == before
    assert len(got) == ncols and all(g.dtype == torch.uint8 for g in got)
    assert n == starts.shape[0]
    for g, b, o in zip(got, bases, offs):
        np.testing.assert_array_equal(g.numpy(), _gather(pool, b, o))


def test_compact_many_rejects_bad_inputs():
    pool = torch.zeros(16, dtype=torch.uint8)
    base, offs = torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="row_starts"):
        hk.ragged_compact_many(pool, [(base, offs, 0)], row_starts=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="offs"):
        hk.ragged_compact_many(pool, [(base, offs[:-1], 0)])


# ---------------------------------------------------------------------------
# assemble_rows
# ---------------------------------------------------------------------------


def _emulate_assemble(parts, offsets, total, block_bytes, tile_rows, tile_cols, threads=256):
    """``assemble_rows_kernel`` in numpy. ``parts``: [(logical [N, w]
    uint32, transposed)]; a transposed part is stored as its [w, N]
    planes. Returns the uint8 [total] blob and how often each word was
    written."""
    out = np.full(total // 4, 0xDEADBEEF, np.uint64)
    writes = np.zeros(total // 4, np.int64)
    n = offsets.shape[0] - 1

    def row_words(s_offs, i, lo, hi, pc0, pw):  # asm_row_words
        ro, re = s_offs[i], s_offs[i + 1]
        return max(((max(lo, ro) - ro) >> 2) - pc0, 0), min(((min(hi, re) - ro) >> 2) - pc0, pw)

    def put(d, v):
        out[d] = v
        writes[d] += 1

    for lo in range(0, total, block_bytes):
        hi = min(lo + block_bytes, total)
        r0, r1 = _block_find_rows(lambda r: int(offsets[r]), n, lo, hi - 1, half=threads // 2)
        rows = r1 - r0 + 1
        assert rows <= block_bytes // 8  # what the block's shared memory holds
        s_offs = [int(offsets[r0 + i]) for i in range(rows + 1)]
        pc0 = 0
        for m, tr in parts + [(None, False)]:  # the last: zero words past the parts
            pw = 1 << 40 if m is None else m.shape[1]
            if not tr:  # a warp a row, lanes on consecutive words
                for i in range(rows):
                    c0, c1 = row_words(s_offs, i, lo, hi, pc0, pw)
                    for c in range(c0, c1):
                        put((s_offs[i] >> 2) + pc0 + c, 0 if m is None else int(m[r0 + i, c]))
            else:  # the tile: read down the planes, write along the rows
                planes = np.ascontiguousarray(m.T)  # what lies in memory
                per = tile_rows * tile_cols // threads
                for rr in range(0, rows, tile_rows):
                    for cc in range(0, pw, tile_cols):
                        tile = np.zeros((tile_rows, tile_cols), np.int64)
                        for t in range(threads):
                            rl = t % tile_rows
                            c0, c1 = (row_words(s_offs, rr + rl, lo, hi, pc0, pw)
                                      if rr + rl < rows else (0, 0))
                            for u in range(per):
                                cl = t // tile_rows + u * (threads // tile_rows)
                                c = cc + cl
                                tile[rl, cl] = int(planes[c, r0 + rr + rl]) if c0 <= c < c1 else 0
                        for t in range(threads):
                            for u in range(per):
                                wr = t // tile_cols + u * (threads // tile_cols)
                                wc = t % tile_cols
                                if rr + wr < rows:
                                    w0, w1 = row_words(s_offs, rr + wr, lo, hi, pc0, pw)
                                    if w0 <= cc + wc < w1:
                                        put((s_offs[rr + wr] >> 2) + pc0 + cc + wc, tile[wr, wc])
            if m is not None:
                pc0 += m.shape[1]
    return out.astype("<u4").view(np.uint8), writes


def _padded(rng, n, min_row, spread, long_row=0, width_pad=12):
    """uint8 [N, W] padded rows (zero past each size), sizes, offsets."""
    sizes = (min_row + rng.integers(0, spread // 8 + 1, n) * 8).astype(np.int64)
    if long_row:
        sizes[n // 2] = long_row
    width = (int(sizes.max()) + 3) // 4 * 4 + width_pad
    rp = np.zeros((n, width), np.uint8)
    for r in range(n):
        rp[r, : sizes[r]] = rng.integers(1, 256, sizes[r])
    return rp, sizes, np.concatenate([[0], np.cumsum(sizes)])


def _split(rp32, layout, at):
    if layout == "rows":
        return [(rp32, False)]
    if layout == "two":
        return [(rp32[:, :at], False), (rp32[:, at:], False)]
    return [(rp32[:, :at], True), (rp32[:, at:], False)]  # the encode's: planes, then rows


# (min_row, spread, rows, long row, layout, block bytes): the plain
# version's tiles of 8 to 256 bytes; blocks of 64 bytes (4 chunks) so the
# boundaries fall inside rows, and the kernel's 16 KB
@pytest.mark.parametrize("min_row,spread,n,long_row", [
    (8, 24, 60, 0), (16, 300, 30, 0), (136, 128, 12, 0), (1016, 64, 4, 0),
    (8, 8, 1, 0), (16, 16, 9, 600)])
@pytest.mark.parametrize("layout", ["rows", "two", "path"])
@pytest.mark.parametrize("block_bytes", [64, 16384])
def test_emulated_assemble_matches_plain_and_jax(rng, min_row, spread, n, long_row, layout,
                                                 block_bytes):
    rp, sizes, offsets = _padded(rng, n, min_row, spread, long_row)
    total = int(offsets[-1])
    rp32 = rp.view("<u4")
    at = max(1, min(rp32.shape[1] - 1, min_row // 4 - 1 + (min_row // 4) % 2))
    small = block_bytes == 64  # 4 x 8 tiles of 32 threads, or the kernel's own
    got, writes = _emulate_assemble(_split(rp32, layout, at), offsets, total, block_bytes,
                                    tile_rows=4 if small else 16, tile_cols=8 if small else 128,
                                    threads=32 if small else 256)
    assert (writes == 1).all()  # each word once, by one block and one phase
    gather = np.concatenate([rp[r, : sizes[r]] for r in range(n)])
    np.testing.assert_array_equal(got, gather)
    tparts = [torch.from_numpy(np.ascontiguousarray(m).view(np.int32)) for m, _ in
              _split(rp32, layout, at)]
    want = rb.assemble_rows_plain(tparts, torch.from_numpy(sizes), torch.from_numpy(offsets), total,
                                  min_row)
    np.testing.assert_array_equal(got, want.numpy())
    if layout == "rows" and block_bytes == 64:  # the JAX package, once a row class
        jwant = np.asarray(_jax_assemble_rows(jnp.asarray(rp32), jnp.asarray(sizes),
                                              jnp.asarray(offsets), total, min_row))
        np.testing.assert_array_equal(got, jwant)


@pytest.mark.parametrize("min_row,spread,n,layout", [
    (8, 0, 1, "rows"), (8, 64, 33, "path"), (24, 40, 17, "two"), (72, 8, 5, "path"),
    (136, 256, 20, "rows"), (256, 512, 9, "path"), (1016, 16, 3, "two"), (504, 1000, 6, "path")])
def test_assemble_rows_plain_is_a_ragged_gather(rng, min_row, spread, n, layout):
    rp, sizes, offsets = _padded(rng, n, min_row, spread)
    rp32 = rp.view("<u4")
    at = max(1, min(rp32.shape[1] - 1, 2 * (min_row // 8) - 1))
    parts = []
    for m, tr in _split(rp32, layout, at):
        t = torch.from_numpy(np.ascontiguousarray(m).view(np.int32))
        parts.append(t.t().contiguous().t() if tr else t)  # a transposed view, as the encode's
    total = int(offsets[-1])
    got = rb.assemble_rows(parts, torch.from_numpy(sizes), torch.from_numpy(offsets), total, min_row)
    assert got.dtype == torch.uint8 and got.shape == (total,)
    np.testing.assert_array_equal(got.numpy(), np.concatenate([rp[r, : sizes[r]] for r in range(n)]))


def test_assemble_rows_rejects_bad_rows():
    z = torch.zeros((2, 4), dtype=torch.int32)
    offs = torch.tensor([0, 8, 16])
    with pytest.raises(ValueError, match="8-aligned"):
        rb.assemble_rows(z, offs[1:] - offs[:-1], offs, 16, 4)
    with pytest.raises(ValueError, match="offsets"):
        rb.assemble_rows(z, offs[1:] - offs[:-1], offs[:-1], 16, 8)


# ---------------------------------------------------------------------------
# the wrappers' constants against the kernel's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,value", [
    ("kCompactWords", hk._COMPACT_WORDS), ("kCompactByValue", hk._COMPACT_BY_VALUE),
    ("kAsmParts", rb._ASM_PARTS)])
def test_wrapper_constants_match_the_kernel(name, value):
    assert _constant(name) == value


def test_staged_rows_fit_shared_memory_without_opt_in():
    # B5 stages offsets and bases, assemble_rows offsets and one tile;
    # rows of 8 bytes or more fill at most kAsmRows of a block's range
    compact = 8 * (2 * _constant("kCompactRowCap") + 1)
    tile = 4 * _constant("kAsmTileRows") * (_constant("kAsmTileCols") + 1)
    assert compact <= 48 * 1024
    assert _constant("kAsmRows") == _constant("kAsmBytes") // 8
    assert 8 * (_constant("kAsmRows") + 1) + tile <= 48 * 1024
    # whole 16-byte chunks a thread (B5), whole tile words a thread
    # (assemble_rows), and halves of whole warps for the row search
    assert _constant("kCompactWords") % (4 * _constant("kCompactThreads")) == 0
    assert _constant("kAsmTileRows") * _constant("kAsmTileCols") % _constant("kAsmThreads") == 0
    assert _constant("kAsmThreads") % _constant("kAsmTileRows") == 0
    assert _constant("kAsmThreads") % _constant("kAsmTileCols") == 0
    assert _constant("kCompactThreads") % 64 == 0 and _constant("kAsmThreads") % 64 == 0
