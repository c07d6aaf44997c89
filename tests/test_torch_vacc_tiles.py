"""Port: the host side of B9's shared-memory tiling
(spark_rapids_jni_tpu_torch.ops.ragged_bytes.vacc_tile_plan and the
by-value table cap) and of B2's partial sums, as pure functions on the
CPU.

``_emulate`` follows csrc/strings.cu ``var_accumulate_tile_kernel`` tile
by tile in numpy: the plan's blocks, each matrix's source window (whole
row slabs, or, for a word range, only the words that can land in it),
its items of eight words of one row, each funnelled into the output
words it reaches, the drop outside the tile's range. It is held against ``var_accumulate_plain`` and a numpy byte
oracle, so the window arithmetic the kernel runs is checked here although
the kernel itself runs only on a card. Every output is bytes: every
comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb

CSRC = Path(rb.__file__).resolve().parent.parent / "csrc" / "strings.cu"


def _oracle(mats, shifts, maxvar):
    """Byte by byte: byte i of matrix k's row r lands at byte s + i."""
    n = mats[0].shape[0]
    out = np.zeros((n, maxvar), np.uint8)
    for m, s in zip(mats, shifts):
        for r in range(n):
            for i in range(m.shape[1]):
                if s[r] + i < maxvar:
                    out[r, s[r] + i] |= m[r, i]
    return out.view(np.uint32)


def _emulate(mats, shifts, maxvar, budget, group=8):
    """The kernel's tiles and items, in numpy, on uint32 word views of the
    matrices (``group``: kVaccGroup, the source words an item funnels)."""
    n, lo_words = mats[0].shape[0], maxvar // 4
    words32 = [np.ascontiguousarray(m).view(np.uint32) for m in mats]
    tile_rows, tile_words = rb.vacc_tile_plan(lo_words, budget)
    col_tiles = -(-lo_words // tile_words)
    blocks = -(-n // tile_rows) * col_tiles
    assert tile_rows * tile_words <= budget
    out = np.full((n, lo_words), 0xDEADBEEF, np.uint32)  # every word must be written
    for blk in range(blocks):
        r0, c0 = blk // col_tiles * tile_rows, blk % col_tiles * tile_words
        rows, cw = min(tile_rows, n - r0), min(tile_words, lo_words - c0)
        tile = np.zeros((rows, tile_words), np.uint32)
        for m, s in zip(words32, shifts):
            j0, count = 0, m.shape[1]
            if col_tiles > 1 and count:  # one row: only the words that land in the range
                lo, hi = 4 * c0 - int(s[r0]), 4 * (c0 + cw) - int(s[r0])
                j0 = 0 if lo <= 0 else lo >> 2
                j1 = 0 if hi <= 0 else min(m.shape[1], (hi + 3) >> 2)
                count = max(j1 - j0, 0)
            for rl in range(rows):
                row = m[r0 + rl, j0:j0 + count].tolist()
                for jj in range(0, count, group):  # one item
                    d0 = 4 * (j0 + jj) + int(s[r0 + rl])
                    q0, b = (d0 >> 2) - c0, (d0 & 3) * 8
                    item = row[jj:jj + group] + [0] * (group + 1 - len(row[jj:jj + group]))
                    prev = 0
                    for t, cur in enumerate(item):
                        val = cur if b == 0 else ((cur << b) & 0xFFFFFFFF) | (prev >> (32 - b))
                        if val and 0 <= q0 + t < cw:
                            tile[rl, q0 + t] |= val
                        prev = cur
        out[r0:r0 + rows, c0:c0 + cw] = tile[:, :cw]
    return out


def _inputs(rng, n, widths, shift_hi):
    mats = [rng.integers(0, 256, (n, w), dtype=np.uint8) for w in widths]
    shifts = [rng.integers(0, shift_hi, n).astype(np.int32) for _ in widths]
    return mats, shifts


# (output words, budget) -> (tile rows, tile words)
@pytest.mark.parametrize("out_words,budget,want", [
    (112, 4096, (36, 112)),  # the string path's shape
    (1, 4096, (64, 1)),
    (4096, 4096, (1, 4096)),
    (4097, 4096, (1, 4096)),
    (8192, 4096, (1, 4096)),
    (24, 4096, (64, 24)),
    (2000, 4096, (2, 2000)),
    (1000, 4096, (4, 1000)),
    (700, 4096, (4, 700)),  # 5 rows fit: cut to a multiple of 4
    (24, 8, (1, 8)),
    (24, 24, (1, 24)),
    (32, 4096, (64, 32)),
])
def test_vacc_tile_plan(out_words, budget, want):
    assert rb.vacc_tile_plan(out_words, budget) == want


@pytest.mark.parametrize("n,out_words", [(1, 1), (37, 112), (1000, 3), (3, 16_384), (9, 4099)])
@pytest.mark.parametrize("budget", [4, 64, 4096])
def test_vacc_tiles_cover_every_word_once(n, out_words, budget):
    rows, words = rb.vacc_tile_plan(out_words, budget)
    assert rows * words <= budget and (rows == 1 or words == out_words)
    assert rows < 4 or rows % 4 == 0
    col_tiles = -(-out_words // words)
    seen = np.zeros((n, out_words), np.int64)
    for blk in range(-(-n // rows) * col_tiles):  # the kernel's grid
        r0, c0 = blk // col_tiles * rows, blk % col_tiles * words
        seen[r0:r0 + rows, c0:c0 + words] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("budget", [0, 2, 6])
def test_vacc_tile_plan_rejects_bad_budgets(budget):
    with pytest.raises(ValueError, match="multiple of 4"):
        rb.vacc_tile_plan(8, budget)


def test_vacc_tile_plan_rejects_empty_outputs():
    with pytest.raises(ValueError, match="nothing to tile"):
        rb.vacc_tile_plan(0, 4096)


# (n, widths, maxvar, shifts below, tile budget): whole-row tiles, word
# ranges narrower than a matrix, shifts past the section, one row
@pytest.mark.parametrize("n,widths,maxvar,shift_hi,budget", [
    (9, (32, 16), 64, 64, 4096),
    (9, (32, 16), 64, 64, 4),
    (9, (32, 16), 64, 64, 8),
    (13, (4, 32, 8, 32), 96, 100, 12),
    (13, (4, 32, 8, 32), 96, 100, 4096),
    (1, (64,), 64, 70, 4),
    (6, (32, 32, 32), 128, 16, 20),
    (7, (0, 8), 32, 32, 4),
    (5, (128, 64), 256, 300, 12),  # rows of several items, ranges cutting items
    (3, (256,), 256, 200, 16),
])
def test_emulated_tiles_match_plain(rng, n, widths, maxvar, shift_hi, budget):
    mats, shifts = _inputs(rng, n, widths, shift_hi)
    want = rb.var_accumulate_plain([torch.from_numpy(m) for m in mats],
                                   [torch.from_numpy(s) for s in shifts], maxvar)
    got = _emulate(mats, shifts, maxvar, budget)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
    np.testing.assert_array_equal(got, _oracle(mats, shifts, maxvar))


@pytest.mark.parametrize("n,widths,maxvar,shift_hi", [
    (4, (8,), 8, 8), (5, (16, 4), 32, 40), (3, (12, 12, 12), 24, 30), (2, (4,) * 9, 16, 16)])
def test_plain_matches_the_byte_oracle(rng, n, widths, maxvar, shift_hi):
    mats, shifts = _inputs(rng, n, widths, shift_hi)
    got = rb.var_accumulate_plain([torch.from_numpy(m) for m in mats],
                                  [torch.from_numpy(s) for s in shifts], maxvar)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _oracle(mats, shifts, maxvar))


def _constant(name, source=CSRC):
    """A constexpr integer of a kernel source, a product of literals."""
    expr = re.search(rf"constexpr int(?:64_t)? {name} = ([0-9* ]+);", source.read_text()).group(1)
    return int(np.prod([int(f) for f in expr.split("*")]))


def test_by_value_cap_matches_the_kernel():
    # the wrapper passes a device table above this many matrices; the
    # kernel takes at most this many in its arguments
    assert rb._VACC_BY_VALUE == _constant("kVaccByValue")


def test_b2_partial_rows_match_the_kernel():
    # B2's wrapper sizes its [blocks, K] partial for this many blocks a SM;
    # the kernel launches at most that many
    from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

    assert hk._ONEHOT_BLOCKS_PER_SM == _constant("kOnehotBlocksPerSM", CSRC.with_name("groupby.cu"))


def test_tile_budget_fits_shared_memory_without_opt_in():
    assert 4 * rb._VACC_TILE_WORDS <= _constant("kVaccMaxSmem")
    assert rb._VACC_TILE_WORDS % 4 == 0
