"""Port: the two kernels that took B8's place on the transcode's path --
``rows_to_planes`` (the decode: the row blob straight to word planes,
B7 with B8's fixed-section gather absorbed) and ``extract_strings_many``
(the encode: every string column padded and masked in one launch) --
as plain versions on the CPU against the JAX package's compositions
they replace, and as a numpy emulation of each CUDA kernel's blocks.

- ``rows_to_planes_plain`` against ``jrb.pack_u8_planes(pad4(
  jrb.padded_extract(..)[:, :W]).T, interpret=True)``: the JAX
  ``padded_extract`` runs its plain rotate on the CPU, as the JAX
  package's own tests run it, and B7's Pallas body runs in interpret
  mode.
- ``extract_strings_many_plain`` against the JAX ``padded_extract``
  masked by the lengths (the reference encode's ``_var_section``).
- A rows column whose offsets are shifted by 3 bytes, decoded by both
  packages' ``convert_from_rows``.
- ``_emulate_rows_to_planes`` / ``_emulate_extract`` follow
  ``csrc/planes.cu`` ``rows_to_planes_kernel`` and ``csrc/strings.cu``
  ``extract_strings_kernel`` block by block and thread by thread: the
  grid, the staged starts, each lane's words, the aligned-word funnel of
  ``csrc/bytes.cuh`` on a buffer that starts 0-3 bytes past a word, the
  masks, the tile and the stores. They are held against the plain
  versions, so the index arithmetic the kernels run is checked here
  although the kernels themselves run only on a card.

Every output is bytes or words: every comparison is exact. Few distinct
shapes, because the JAX side compiles once per shape."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import ragged_bytes as jrb
from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as prb
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc

CSRC = Path(prb.__file__).resolve().parent.parent / "csrc"


def _constant(source, name):
    """A constexpr integer of a CUDA source, a literal or a quotient of two."""
    text = (CSRC / source).read_text()
    expr = re.search(rf"constexpr int(?:64_t)? {name} = ([^;]+);", text).group(1).strip()
    if "/" in expr:
        a, b = (x.strip() for x in expr.split("/"))
        return (int(a) if a.isdigit() else _constant(source, a)) // (
            int(b) if b.isdigit() else _constant(source, b))
    return int(expr)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _blob_rows(rng, n, width, align, gap=9):
    """A uint8 blob of n rows of ``width`` bytes or more, row starts a
    multiple of ``align`` (1: any), with gaps between rows; the last row
    ends exactly at the blob's end."""
    starts, at = [], int(rng.integers(0, 4))
    for _ in range(n):
        at = -(-at // align) * align
        starts.append(at)
        at += width + int(rng.integers(0, gap))
    starts = np.asarray(starts, np.int64)
    blob = rng.integers(0, 256, int(starts[-1]) + width, dtype=np.uint8)
    return blob, starts


def _jax_planes(blob, starts, width):
    """The reference decode's composition: padded_extract -> the first W
    bytes -> pad to whole words -> byte planes -> B7 (interpret mode)."""
    fixed = np.asarray(jrb.padded_extract(jnp.asarray(blob), jnp.asarray(starts), width))[:, :width]
    fixed = np.pad(fixed, ((0, 0), (0, (-width) % 4)))
    return np.asarray(jrb.pack_u8_planes(jnp.asarray(np.ascontiguousarray(fixed.T)), interpret=True))


def _u32(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# rows_to_planes
# ---------------------------------------------------------------------------


# (row starts' alignment, rows, W): 8-aligned (every convert_to_rows
# blob), 4-aligned, odd; W a multiple of 4 or not (the tail word's bytes
# past W zero); N in {1, 7, 8, 300}
@pytest.mark.parametrize("align,n,width", [(8, 300, 24), (4, 8, 13), (1, 7, 13), (1, 300, 13),
                                           (8, 1, 24)])
def test_rows_to_planes_matches_jax(rng, align, n, width):
    blob, starts = _blob_rows(rng, n, width, align)
    want = _jax_planes(blob, starts, width)
    got = prb.rows_to_planes(torch.from_numpy(blob), torch.from_numpy(starts), width)
    assert got.dtype == torch.int32 and tuple(got.shape) == ((width + 3) // 4, n)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n", [1, 300])
def test_rows_to_planes_uniform_stride_matches_jax(rng, n):
    width = 24
    blob = rng.integers(0, 256, n * width, dtype=np.uint8)
    starts = np.arange(n, dtype=np.int64) * width
    want = _jax_planes(blob, starts, width)
    got = prb.rows_to_planes(torch.from_numpy(blob), width, width, n)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(got), blob.view(np.uint32).reshape(n, -1).T)


def test_rows_to_planes_past_the_blob_end_reads_zero(rng):
    # the last rows start 5 bytes and 0 bytes before the end: their
    # windows run past the blob, and those bytes are 0, as padded_extract
    # zero-fills past its pool
    blob = rng.integers(1, 256, 100, dtype=np.uint8)
    starts = np.array([0, 40, 95, 99], np.int64)
    got = _u32(prb.rows_to_planes(torch.from_numpy(blob), torch.from_numpy(starts), 13))
    want = np.zeros((4, 16), np.uint8)
    for r, s in enumerate(starts):
        seg = blob[s : s + 13]
        want[r, : seg.shape[0]] = seg
    np.testing.assert_array_equal(got, want.view(np.uint32).T)


def test_rows_to_planes_empty_cases():
    z = torch.zeros((0,), dtype=torch.uint8)
    assert tuple(prb.rows_to_planes(z, torch.zeros((0,), dtype=torch.int64), 13).shape) == (4, 0)
    got = prb.rows_to_planes(z, torch.zeros((3,), dtype=torch.int64), 13)  # an empty blob
    assert tuple(got.shape) == (4, 3) and not got.any()
    assert tuple(prb.rows_to_planes(torch.ones(8, dtype=torch.uint8), 8, 0, 1).shape) == (0, 1)
    with pytest.raises(ValueError, match="row count"):
        prb.rows_to_planes(z, 8, 8)
    with pytest.raises(ValueError, match="uint8"):
        prb.rows_to_planes(z.to(torch.int32), torch.zeros((1,), dtype=torch.int64), 8)


# ---------------------------------------------------------------------------
# extract_strings_many
# ---------------------------------------------------------------------------


def _string_column(rng, n, max_len, null_frac, tail=0):
    """(pool, starts, lens): strings of 0..max_len bytes, a share null or
    empty, the last one max_len bytes, the pool ending ``tail`` bytes past
    it."""
    lens = rng.integers(0, max_len + 1, n)
    lens[rng.random(n) < null_frac] = 0
    lens[-1] = max_len
    offs = np.concatenate([[0], np.cumsum(lens)])
    pool = rng.integers(0, 256, int(offs[-1]) + tail, dtype=np.uint8)
    return pool, offs[:-1].astype(np.int32), lens.astype(np.int32)


def _jax_extract(pool, starts, lens, lc, max_len):
    """The reference encode's extraction: padded_extract at the column's
    longest string, cut to lc, masked by the lengths."""
    p = np.asarray(jrb.padded_extract(jnp.asarray(pool), jnp.asarray(starts.astype(np.int64)),
                                      max_len))[:, :lc]
    return np.where(np.arange(lc)[None, :] < lens[:, None], p, 0).astype(np.uint8)


def test_extract_strings_many_matches_jax(rng):
    n = 300
    # null and empty strings; a column whose last string ends at the
    # pool's last byte; lengths past the width (lc 8 < 20)
    cols = [_string_column(rng, n, 32, 0.3), _string_column(rng, n, 7, 0.5, tail=3),
            _string_column(rng, n, 20, 0.1)]
    widths, maxlens = [32, 8, 8], [32, 7, 20]
    got = prb.extract_strings_many([torch.from_numpy(c[0]) for c in cols],
                                   [torch.from_numpy(c[1]) for c in cols],
                                   [torch.from_numpy(c[2]) for c in cols], widths)
    assert [tuple(g.shape) for g in got] == [(n, w) for w in widths]
    for g, (pool, starts, lens), lc, ml in zip(got, cols, widths, maxlens):
        np.testing.assert_array_equal(g.numpy(), _jax_extract(pool, starts, lens, lc, ml))


def test_extract_strings_at_the_pool_end_and_past_the_width(rng):
    pool = rng.integers(1, 256, 41, dtype=np.uint8)
    starts = np.array([0, 30, 41, 35], np.int32)  # row 2: empty, at the very end
    lens = np.array([30, 11, 0, 6], np.int32)
    (got,) = prb.extract_strings_many([torch.from_numpy(pool)], [torch.from_numpy(starts)],
                                      [torch.from_numpy(lens)], [12])
    want = np.zeros((4, 12), np.uint8)
    for r, (s, ln) in enumerate(zip(starts, lens)):
        want[r, : min(ln, 12)] = pool[s : s + min(ln, 12)]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _jax_extract(pool, starts, lens, 12, 30))


def test_extract_strings_empty_pool_matches_the_port_composition():
    # an all-null column has an empty pool; the JAX package cannot gather
    # from one, so the port's own padded_extract composition is the oracle
    pool = torch.zeros((0,), dtype=torch.uint8)
    starts = torch.zeros((5,), dtype=torch.int32)
    lens = torch.zeros((5,), dtype=torch.int32)
    (got,) = prb.extract_strings_many([pool], [starts], [lens], [4])
    want = torch.where(torch.arange(4)[None, :] < lens[:, None],
                       prb.padded_extract(pool, starts, 1)[:, :4], 0)
    assert torch.equal(got, want) and not got.any()


def test_extract_strings_many_empty_and_wrong_inputs():
    assert prb.extract_strings_many([], [], [], []) == []
    z8, z32 = torch.zeros((0,), dtype=torch.uint8), torch.zeros((0,), dtype=torch.int32)
    (got,) = prb.extract_strings_many([z8], [z32], [z32], [8])
    assert tuple(got.shape) == (0, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        prb.extract_strings_many([z8], [z32], [z32], [6])
    with pytest.raises(ValueError, match="width a column"):
        prb.extract_strings_many([z8], [z32], [z32], [])


def test_cpu_tensors_launch_nothing(rng):
    before = (prb.rows_to_planes.launches, prb.extract_strings_many.launches)
    blob, starts = _blob_rows(rng, 9, 16, 8)
    prb.rows_to_planes(torch.from_numpy(blob), torch.from_numpy(starts), 16)
    pool, s, ln = _string_column(rng, 9, 8, 0.2)
    prb.extract_strings_many([torch.from_numpy(pool)], [torch.from_numpy(s)],
                             [torch.from_numpy(ln)], [8])
    assert (prb.rows_to_planes.launches, prb.extract_strings_many.launches) == before


# ---------------------------------------------------------------------------
# the decode over rows whose offsets are shifted by 3 bytes
# ---------------------------------------------------------------------------


def _table(rng, names, n):
    """A seeded JAX table of ``names`` (every third column nullable,
    strings of 0-19 bytes) and the two packages' dtypes."""
    jcols = []
    for i, nm in enumerate(names):
        v = rng.random(n) < 0.8 if i % 3 == 0 else None
        if nm == "STRING":
            lens = rng.integers(0, 20, n) * (1 if v is None else v)
            offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
            a = (offs, rng.integers(0, 256, int(offs[-1]), dtype=np.uint8))
            jcols.append(JColumn.strings_from_parts(a[0], a[1],
                                                    validity=None if v is None else jnp.asarray(v)))
        else:
            info = np.iinfo(np.dtype(nm.lower()))
            a = rng.integers(info.min, info.max, n, dtype=np.dtype(nm.lower()), endpoint=True)
            jcols.append(JColumn(getattr(jdt, nm), data=jnp.asarray(a),
                                 validity=None if v is None else jnp.asarray(v)))
    return JTable(jcols), [getattr(jdt, nm) for nm in names], [getattr(pdt, nm) for nm in names]


@pytest.mark.parametrize("names", [["INT32", "STRING", "INT64", "STRING", "INT16"],
                                   ["INT8", "INT64", "INT32", "UINT16"]])
def test_rows_shifted_by_three_bytes_decode_like_jax(rng, names):
    n = 40
    jt, jd, pd = _table(rng, names, n)
    jrows = jrc.convert_to_rows(jt)[0]
    blob = np.concatenate([rng.integers(0, 256, 3, dtype=np.uint8),
                           np.asarray(jrows.child.data).view(np.uint8)])
    offs = (np.asarray(jrows.offsets).astype(np.int64) + 3).astype(np.int32)
    jshift = JColumn.list_from_parts(jnp.asarray(offs),
                                     JColumn(jdt.INT8, data=jnp.asarray(blob.view(np.int8))))
    pshift = Column.list_from_parts(torch.from_numpy(offs),
                                    Column(pdt.INT8, data=torch.from_numpy(blob.view(np.int8).copy())))
    want, got = jrc.convert_from_rows(jshift, jd), prc.convert_from_rows(pshift, pd)
    for i, (a, b) in enumerate(zip(want.columns, got.columns)):
        np.testing.assert_array_equal(b.valid_mask().numpy(), np.asarray(a.valid_mask()))
        if a.dtype.id == jdt.TypeId.STRING:
            np.testing.assert_array_equal(b.offsets.numpy(), np.asarray(a.offsets), err_msg=str(i))
            np.testing.assert_array_equal(b.chars.numpy(), np.asarray(a.chars), err_msg=str(i))
        else:
            np.testing.assert_array_equal(b.to_numpy().view(np.uint8),
                                          np.asarray(a.data).view(np.uint8), err_msg=str(i))


# ---------------------------------------------------------------------------
# the kernels' blocks, emulated in numpy
# ---------------------------------------------------------------------------


class _Memory:
    """A buffer of ``blen`` bytes that starts ``mis`` bytes past a word, in
    aligned 32-bit words as a kernel loads them (csrc/bytes.cuh
    ``Buffer``). A load of a word that holds no byte of the buffer counts
    as a fault."""

    def __init__(self, data: np.ndarray, mis: int):
        self.mis, self.lim = mis, mis + data.shape[0]
        self.nwords = ((self.lim - 1) >> 2) + 1 if data.shape[0] else 0
        raw = np.zeros(-(-(mis + data.shape[0] + 8) // 4) * 4, np.uint8)
        raw[mis : mis + data.shape[0]] = data
        self.words = raw.view("<u4").astype(np.int64)
        self.bad = 0

    def raw(self, q):
        """A plain load of aligned word q, which must hold a byte of the buffer."""
        if max(4 * q, self.mis) >= min(4 * q + 4, self.lim):
            self.bad += 1
            return 0
        return int(self.words[q])

    def word(self, q):
        """``Buffer::word``: bytes outside the buffer 0, no load there."""
        if q < 0 or q >= self.nwords:
            return 0
        v = self.raw(q)
        head, tail = self.mis - 4 * q, 4 * q + 4 - self.lim
        if head > 0:
            v &= (0xFFFFFFFF << (8 * head)) & 0xFFFFFFFF
        if tail > 0:
            v &= 0xFFFFFFFF >> (8 * tail)
        return v

    def inside(self, q0, q1):
        return 4 * q0 >= self.mis and 4 * q1 + 4 <= self.lim

    def window(self, a, need):
        """``Buffer::window``: the first ``need`` bytes of bytes [a, a + 4),
        the second word loaded only when a byte past the first is needed."""
        if need <= 0:
            return 0
        q, sh = a >> 2, a & 3
        lo = self.word(q)
        hi = self.word(q + 1) if sh and need > 4 - sh else 0
        return _keep(_funnel(lo, hi, sh), need)


def _funnel(lo, hi, sh):
    return lo if sh == 0 else ((lo >> (8 * sh)) | (hi << (32 - 8 * sh))) & 0xFFFFFFFF


def _keep(v, n):
    return v if n >= 4 else (0 if n <= 0 else v & ((1 << (8 * n)) - 1))


def _emulate_rows_to_planes(blob, mis, starts, stride, width, n):
    """rows_to_planes_kernel: grid (ceil(N / kR2PRows), ceil(P / kR2PWords)),
    each block's staged starts, each warp's rows (plain loads of the whole
    words before W where the band is aligned and inside the blob, the
    funnel elsewhere), the padded tile, then the planes' slices out."""
    rows_b, words_b = _constant("planes.cu", "kR2PRows"), _constant("planes.cu", "kR2PWords")
    threads = _constant("planes.cu", "kR2PThreads")
    warps, per_warp = threads // 32, _constant("planes.cu", "kR2PRowsAWarp")
    loads = _constant("planes.cu", "kR2PLoads")
    assert warps * per_warp == rows_b and 32 * loads == words_b
    mem = _Memory(blob, mis)
    p = (width + 3) // 4
    out = np.full((p, n), -1, np.int64)  # every plane word must be written once
    for bx in range(-(-n // rows_b)):
        for by in range(-(-p // words_b)):
            r0, c0 = bx * rows_b, by * words_b
            s_start = [(int(starts[r0 + t]) if starts is not None else (r0 + t) * stride)
                       if r0 + t < n else 0 for t in range(rows_b)]
            nfull = min(width // 4 - c0, words_b)
            tile = np.zeros((rows_b, words_b + 1), np.int64)
            for tid in range(threads):
                lane, warp = tid & 31, tid >> 5
                for i in range(per_warp):
                    rl = warp + warps * i
                    a = mem.mis + s_start[rl] + 4 * c0
                    q0 = a >> 2
                    fast = a & 3 == 0 and mem.inside(q0, q0 + nfull - 1)
                    for u in range(loads):
                        jj = lane + 32 * u
                        if r0 + rl >= n:
                            v = 0
                        elif fast and jj < nfull:
                            v = mem.raw(q0 + jj)
                        else:
                            v = mem.window(a + 4 * jj, width - 4 * (c0 + jj))
                        tile[rl, jj] = v
            step = threads // rows_b
            for tid in range(threads):
                rr, jj0 = tid % rows_b, tid // rows_b
                if r0 + rr < n:
                    for jj in range(jj0, words_b, step):
                        if c0 + jj < p:
                            assert out[c0 + jj, r0 + rr] == -1
                            out[c0 + jj, r0 + rr] = tile[rr, jj]
    assert mem.bad == 0 and (out >= 0).all()
    return out.astype(np.uint32)


# (rows, W, row start alignment, the blob's misalignment, uniform): two
# bands of planes (P = 70 > 64), rows not a multiple of 64, odd starts on
# a blob 1-3 bytes past a word, the tail word, the uniform stride
@pytest.mark.parametrize("n,width,align,mis,uniform", [
    (130, 278, 8, 0, False), (65, 13, 1, 3, False), (70, 1011, 4, 2, False), (3, 5, 1, 1, False),
    (66, 24, 8, 0, True), (9, 278, 8, 1, True)])
def test_emulated_rows_to_planes_matches_plain(rng, n, width, align, mis, uniform):
    if uniform:
        blob = rng.integers(0, 256, n * width, dtype=np.uint8)
        starts, stride = None, width
        want = prb.rows_to_planes_plain(torch.from_numpy(blob), width, width, n)
    else:
        blob, starts = _blob_rows(rng, n, width, align)
        stride = 0
        want = prb.rows_to_planes_plain(torch.from_numpy(blob), torch.from_numpy(starts), width)
    got = _emulate_rows_to_planes(blob, mis, starts, stride, width, n)
    np.testing.assert_array_equal(got, _u32(want))


def _emulate_extract(cols, widths, n):
    """extract_strings_kernel<IdxT>: the host's block plan, each block's
    column by a search over the first blocks, its whole rows, a thread a
    unit of up to 4 words (its row and place stepped by the block's size),
    the aligned pool words a unit uses loaded (no others), funnelled and
    masked to the length."""
    live = [k for k, w in enumerate(widths) if n and w]
    rpb, first, blocks = prb.extract_block_plan(n, [widths[k] // 4 for k in live])
    threads = _constant("strings.cu", "kExtractThreads")
    outs = [np.full((n, w // 4), -1, np.int64) for w in widths]
    mems = {k: _Memory(cols[k][0], cols[k][3]) for k in live}
    for blk in range(blocks):
        c = max(i for i, f in enumerate(first) if f <= blk)
        k = live[c]
        _, starts, lens, _ = cols[k]
        mem, l4 = mems[k], widths[k] // 4
        r0 = (blk - first[c]) * rpb[c]
        rows = min(n - r0, rpb[c])
        units = (l4 + 3) // 4
        drl, dt = divmod(threads, units)
        for tid in range(threads):
            rl, t = divmod(tid, units)
            for e in range(tid, rows * units, threads):
                assert divmod(e, units) == (rl, t)  # the kernel's stepping
                r = r0 + rl
                nw = min(4, l4 - 4 * t)
                need = int(lens[r]) - 16 * t
                a = mem.mis + int(starts[r]) + 16 * t
                q, sh = a >> 2, a & 3
                used = min(need, 4 * nw)
                wd = [mem.word(q + j) if 4 * j - sh < used else 0 for j in range(5)]
                for m in range(nw):
                    assert outs[k][r, 4 * t + m] == -1
                    outs[k][r, 4 * t + m] = _keep(_funnel(wd[m], wd[m + 1], sh), need - 4 * m)
                rl, t = rl + drl, t + dt
                if t >= units:
                    rl, t = rl + 1, t - units
    assert all(m.bad == 0 for m in mems.values())
    assert all((o >= 0).all() for o in outs)
    return [o.astype(np.uint32).view(np.uint8).reshape(n, -1) for o in outs]


@pytest.mark.parametrize("words", [2048, 8])
def test_emulated_extract_matches_plain(rng, monkeypatch, words):
    # words 8 splits the 64-byte column into one row a block and the
    # others into a few; pools start 0-3 bytes past a word; an empty pool
    monkeypatch.setattr(prb, "_EXTRACT_WORDS", words)
    n = 300
    cols = []
    for max_len, mis in [(32, 0), (7, 3), (64, 1), (0, 2), (20, 1), (44, 2)]:
        pool, starts, lens = _string_column(rng, n, max_len, 0.2, tail=int(rng.integers(0, 3)))
        cols.append((pool, starts, lens, mis))
    # 12 shorter than its column's longest strings; 12, 20 and 4 not whole
    # 16-byte units
    widths = [32, 8, 64, 4, 12, 20]
    rpb, _, _ = prb.extract_block_plan(n, [w // 4 for w in widths], words)
    got = _emulate_extract(cols, widths, n)
    want = prb.extract_strings_many_plain([torch.from_numpy(c[0]) for c in cols],
                                          [torch.from_numpy(c[1]) for c in cols],
                                          [torch.from_numpy(c[2]) for c in cols], widths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("n,row_words,words,want", [
    (300, [8, 2, 16], 2048, ([256, 1024, 128], [0, 2, 3], 6)),
    (5, [3000], 2048, ([1], [0], 5)), (0, [8], 2048, ([256], [0], 0))])
def test_extract_block_plan(n, row_words, words, want):
    assert prb.extract_block_plan(n, row_words, words) == want


def test_extract_constants_match_the_kernel():
    assert _constant("strings.cu", "kExtractByValue") == prb._EXTRACT_BY_VALUE
    # a rows_to_planes tile (plus the staged starts) needs no opt-in shared memory
    rows_b, words_b = _constant("planes.cu", "kR2PRows"), _constant("planes.cu", "kR2PWords")
    assert 4 * rows_b * (words_b + 1) + 8 * rows_b <= 48 * 1024
    assert _constant("planes.cu", "kR2PThreads") >= rows_b  # one thread stages each start
