"""Port: the string kernels' plain versions (B8 ``rotl_take`` /
``rotl_take32``, B9 ``var_accumulate``, B10 ``asm_epilogue``, B5
``ragged_compact``) and the helpers around them
(spark_rapids_jni_tpu_torch.ops.ragged_bytes, ops.hopper_kernels) against
the JAX package. The JAX kernels run their Pallas bodies in interpret
mode, as tests/test_ragged_bytes.py and tests/test_pallas_kernels.py run
them; the plain helpers are held against the JAX plain functions. Every
output is bytes, so every comparison is exact. On CPU tensors the port's
wrappers run the plain versions."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import ragged_bytes as jrb
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_ragged_compact

from spark_rapids_jni_tpu_torch.ops import hopper_kernels as phk
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as prb


def _t(x):
    """numpy -> CPU tensor with the same bits (u32 as int32 lanes)."""
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x.copy())


def _u32(t):
    return t.numpy().view(np.uint32)


# the JAX plain formulations, compiled once per shape instead of op by op
_jax_ragged_compact = jax.jit(jrb.ragged_compact, static_argnums=(3,))
_jax_assemble_rows = jax.jit(jrb.assemble_rows, static_argnums=(3, 4))


# ---------------------------------------------------------------------------
# B8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [8, 64, 256, 2048])
def test_rotl_take_matches_jax_kernel(rng, w):
    n = 21 if w == 2048 else 70
    x = rng.integers(0, 256, (n, w), dtype=np.uint8)
    sh = rng.integers(0, w, n).astype(np.int32)
    sh[:3] = [0, w - 1, 4 % w]  # no shift, the widest, a whole-word shift
    want = np.asarray(jrb.rotl_take(jnp.asarray(x), jnp.asarray(sh), w // 2, interpret=True))
    got = prb.rotl_take(_t(x), _t(sh), w // 2)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, w // 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [8, 64, 256, 2048])
def test_rotl_take32_matches_jax_kernel(rng, w):
    n = 21 if w == 2048 else 70
    x32 = rng.integers(0, 2**32, (n, w // 4), dtype=np.uint32)
    sh = rng.integers(0, w, n).astype(np.int32)
    want = np.asarray(jrb.rotl_take32(jnp.asarray(x32), jnp.asarray(sh), w, interpret=True))
    got = prb.rotl_take32(_t(x32), _t(sh), w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [8, 32, 128, 256])
def test_byte_rotate_left_matches_jax(rng, w):
    x = rng.integers(0, 256, (40, w), dtype=np.uint8)
    sh = rng.integers(0, w, 40)
    want = np.asarray(jrb.byte_rotate_left(jnp.asarray(x), jnp.asarray(sh, jnp.int32)))
    got = prb.byte_rotate_left(_t(x), _t(sh))
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(40):
        np.testing.assert_array_equal(got[r].numpy(), np.roll(x[r], -int(sh[r])))


@pytest.mark.parametrize("w", [8, 64, 256])
def test_byte_shift_right_matches_jax(rng, w):
    x = rng.integers(0, 256, (40, w), dtype=np.uint8)
    sh = rng.integers(0, w + 16, 40)  # amounts past W clear the row
    want = np.asarray(jrb.byte_shift_right(jnp.asarray(x), jnp.asarray(sh, jnp.int32)))
    np.testing.assert_array_equal(prb.byte_shift_right(_t(x), _t(sh)).numpy(), want)


def test_rotate_guards_the_shift_by_32(rng):
    # every sub-word shift 0: the funnel's other half would shift by 32
    x = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    sh = (rng.integers(0, 8, 16) * 4).astype(np.int64)
    got = prb.byte_rotate_left(_t(x), _t(sh)).numpy()
    for r in range(16):
        np.testing.assert_array_equal(got[r], np.roll(x[r], -int(sh[r])))
    got = prb.byte_shift_right(_t(x), _t(sh)).numpy()
    for r in range(16):
        want = np.zeros(32, np.uint8)
        want[sh[r]:] = x[r, : 32 - sh[r]]
        np.testing.assert_array_equal(got[r], want)


# ---------------------------------------------------------------------------
# B9
# ---------------------------------------------------------------------------


def _vacc_any(rng, n, widths, maxvar, shift_hi):
    """Random uint8 [n, w] matrices with every byte possibly set, and
    independent random shifts in [0, shift_hi) a matrix and a row: windows
    overlap and shifts fall as well as rise across k."""
    mats = [rng.integers(0, 256, (n, w), dtype=np.uint8) for w in widths]
    shifts = [rng.integers(0, shift_hi, n).astype(np.int32) for _ in widths]
    return mats, shifts


def _vacc_disjoint(rng, n, widths, maxvar, tail):
    """The main path's inputs: strings of one row at increasing, disjoint
    offsets, the tail-lane pseudo column at shift 0, and the last column's
    first rows shifted past the section."""
    mats, shifts = [], []
    at = np.full(n, 4 if tail else 0)
    if tail:
        mats.append(rng.integers(0, 256, (n, 4), dtype=np.uint8))
        shifts.append(np.zeros(n, np.int32))
    for w in widths:
        lens = rng.integers(0, w + 1, n)
        m = rng.integers(0, 256, (n, w), dtype=np.uint8)
        m[np.arange(w)[None, :] >= lens[:, None]] = 0
        mats.append(m)
        shifts.append(at.astype(np.int32))
        at = at + lens  # strings of one row are disjoint
    shifts[-1][:4] = maxvar + 5  # shifts past the section clear those rows
    return mats, shifts


# the main path's disjoint sections (ids as before), then the input classes
# a tiled kernel must also get right: overlapping windows, non-monotone
# shifts, one matrix, one row, a section far wider than the strings
@pytest.mark.parametrize("make,n,widths,maxvar,arg", [
    pytest.param(_vacc_disjoint, 130, (16, 32), 96, False, id="widths0-96-False"),
    pytest.param(_vacc_disjoint, 130, (4, 8, 12, 32), 64, False, id="widths1-64-False"),
    pytest.param(_vacc_disjoint, 130, (4, 32, 32), 128, True, id="widths2-128-True"),
    pytest.param(_vacc_disjoint, 130, (32,) * 6, 256, True, id="widths3-256-True"),
    pytest.param(_vacc_any, 130, (16, 32, 8), 96, 96, id="overlapping"),
    pytest.param(_vacc_any, 61, (32, 4, 32, 4), 64, 40, id="non-monotone"),
    pytest.param(_vacc_any, 1, (32, 16), 64, 64, id="one-row"),
    pytest.param(_vacc_any, 130, (32,), 128, 140, id="one-matrix"),
    pytest.param(_vacc_disjoint, 1, (8,), 16, False, id="one-row-one-matrix"),
    pytest.param(_vacc_any, 3, (32, 64, 4096), 4096, 4100, id="wide-section"),
])
def test_var_accumulate_matches_jax_kernel(rng, make, n, widths, maxvar, arg):
    mats, shifts = make(rng, n, widths, maxvar, arg)
    want = np.asarray(jrb.var_accumulate(tuple(jnp.asarray(m) for m in mats),
                                         tuple(jnp.asarray(s) for s in shifts),
                                         maxvar, interpret=True))
    got = prb.var_accumulate([_t(m) for m in mats], [_t(s) for s in shifts], maxvar)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, maxvar // 4)
    np.testing.assert_array_equal(_u32(got), want)


def test_var_accumulate_rejects_wide_matrices():
    with pytest.raises(ValueError, match="L <= 16"):
        prb.var_accumulate([torch.zeros((2, 32), dtype=torch.uint8)],
                           [torch.zeros(2, dtype=torch.int32)], 16)


# ---------------------------------------------------------------------------
# B10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [8, 64, 256])
def test_asm_epilogue_matches_jax_kernel(rng, g):
    n = 600 if g < 256 else 90
    a0, a1, c0 = (rng.integers(0, 2**32, (n, g // 4), dtype=np.uint32) for _ in range(3))
    pmod = (rng.integers(0, g // 8, n) * 8).astype(np.int32)
    delta = (rng.integers(0, g // 8 + 1, n) * 8).astype(np.int32)
    alen = (rng.integers(0, g // 8 + 1, n) * 8).astype(np.int32)
    args = (a0, a1, c0, pmod, delta, alen)
    want = np.asarray(jrb._asm_epilogue(*(jnp.asarray(v) for v in args), g, interpret=True))
    got = prb.asm_epilogue(*(_t(v) for v in args), g)
    np.testing.assert_array_equal(_u32(got), want)
    # the JAX plain version picks by byte: unaligned alen agrees with it too
    alen_b = rng.integers(0, g + 1, n).astype(np.int32)
    args = (a0, a1, c0, pmod, delta, alen_b)
    want = np.asarray(jrb._asm_epilogue(*(jnp.asarray(v) for v in args), g))
    np.testing.assert_array_equal(_u32(prb.asm_epilogue(*(_t(v) for v in args), g)), want)


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------


def _ragged_case(rng, kind):
    """(pool, base, offs, total) for one input class."""
    if kind == "padded_matrix":  # base = r * W over a padded pool
        w, n = 24, 200
        lens = rng.integers(0, w + 1, n)
        pool = rng.integers(0, 256, n * w).astype(np.uint8)
        base = np.arange(n) * w
    else:
        n, max_len, gap, null_frac = {
            "zero_length_rows": (300, 16, 5, 0.6),
            "short_rows_share_words": (1000, 3, 0, 0.0),
            "word_straddling": (120, 13, 7, 0.0),
            "one_giant_row": (1, 3001, 0, 0.0),
            "big_gaps": (300, 32, 600, 0.4),
            "max_width_rows": (20, 257, 11, 0.0),
        }[kind]
        lens = rng.integers(1 if kind == "one_giant_row" else 0, max_len + 1, n)
        if kind == "one_giant_row":
            lens[:] = max_len
        lens[rng.random(n) < null_frac] = 0  # null strings own no bytes
        gaps = rng.integers(0, gap + 1, n)
        base = np.cumsum(np.concatenate([[0], (lens + gaps)[:-1]]))
        pool = rng.integers(1, 256, int(base[-1] + lens[-1] + gaps[-1]) + 5).astype(np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)])
    return pool, base.astype(np.int64), offs.astype(np.int64), int(offs[-1])


KINDS = ["zero_length_rows", "short_rows_share_words", "word_straddling", "one_giant_row",
         "big_gaps", "max_width_rows", "padded_matrix"]


@pytest.mark.parametrize("kind", KINDS)
def test_ragged_compact_matches_jax_kernel(rng, kind):
    pool, base, offs, total = _ragged_case(rng, kind)
    want = np.asarray(pallas_ragged_compact(jnp.asarray(pool), jnp.asarray(base),
                                            jnp.asarray(offs), total, interpret=True))
    got = phk.ragged_compact(_t(pool), _t(base), _t(offs), total)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (total,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_ragged_compact_matches_jax_formulation(rng, kind):
    pool, base, offs, total = _ragged_case(rng, kind)
    want = np.asarray(_jax_ragged_compact(jnp.asarray(pool), jnp.asarray(base),
                                          jnp.asarray(offs), total))
    p32 = prb.build_pool32(_t(pool))
    got = prb.ragged_compact(_t(pool), _t(base), _t(offs), total, pool32=p32)
    np.testing.assert_array_equal(got.numpy(), want)
    # and byte by byte against the definition
    expect = np.concatenate([pool[b : b + (e - s)] for b, s, e in zip(base, offs[:-1], offs[1:])])
    np.testing.assert_array_equal(got.numpy(), expect)


def test_ragged_compact_empty(rng):
    pool, base, offs, total = _ragged_case(rng, "zero_length_rows")
    offs[:] = 0
    assert phk.ragged_compact(_t(pool), _t(base), _t(offs), 0).shape == (0,)
    with pytest.raises(ValueError, match="offs"):
        phk.ragged_compact(_t(pool), _t(base), _t(offs[:-1]), 0)


@pytest.mark.parametrize("plen", [0, 1, 5, 4096])
def test_build_pool32_matches_jax(rng, plen):
    pool = rng.integers(0, 256, plen, dtype=np.uint8)
    want = np.asarray(jrb.build_pool32(jnp.asarray(pool)))
    np.testing.assert_array_equal(_u32(prb.build_pool32(_t(pool))), want)


# ---------------------------------------------------------------------------
# composites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,width,nbytes", [(32, 64, 1000), (16, 48, 16), (4, 4, 3)])
def test_overlap_tiles_matches_jax(rng, stride, width, nbytes):
    buf = rng.integers(0, 256, nbytes, dtype=np.uint8)
    want = np.asarray(jrb.overlap_tiles(jnp.asarray(buf), stride, width))
    np.testing.assert_array_equal(prb.overlap_tiles(_t(buf), stride, width).numpy(), want)


@pytest.mark.parametrize("stride,width,nbytes", [(512, 1024, 5000), (8, 16, 100)])
def test_overlap_tiles_u32_matches_jax(rng, stride, width, nbytes):
    buf = rng.integers(0, 256, nbytes, dtype=np.uint8)
    want = np.asarray(jrb.overlap_tiles_u32(jnp.asarray(buf), stride, width))
    np.testing.assert_array_equal(_u32(prb.overlap_tiles_u32(_t(buf), stride, width)), want)


@pytest.mark.parametrize("max_len", [1, 7, 32, 100, 600, 1012])
def test_padded_extract_matches_jax(rng, max_len):
    pool = rng.integers(0, 256, 6000, dtype=np.uint8)
    starts = np.sort(rng.integers(0, 4900, 64)).astype(np.int64)
    want = np.asarray(jrb.padded_extract(jnp.asarray(pool), jnp.asarray(starts), max_len))
    got = prb.padded_extract(_t(pool), _t(starts), max_len)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy()[:, :max_len], want[:, :max_len])


def test_padded_extract_window_at_pool_end(rng):
    pool = rng.integers(0, 256, 64, dtype=np.uint8)
    got = prb.padded_extract(_t(pool), _t(np.array([60, 64], np.int64)), 8).numpy()
    np.testing.assert_array_equal(got[0, :8], np.concatenate([pool[60:], np.zeros(4, np.uint8)]))
    np.testing.assert_array_equal(got[1, :8], np.zeros(8, np.uint8))


@pytest.mark.parametrize("min_row,spread", [(8, 24), (16, 300), (136, 128), (1016, 64)])
def test_assemble_rows_matches_jax(rng, min_row, spread):
    n = 50
    sizes = (min_row + rng.integers(0, spread // 8 + 1, n) * 8).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offsets[-1])
    rp = np.zeros((n, int(sizes.max())), np.uint8)
    for r in range(n):
        rp[r, : sizes[r]] = rng.integers(1, 256, sizes[r])
    rp32 = rp.reshape(n, -1, 4).view(np.uint32)[:, :, 0]
    want = np.asarray(_jax_assemble_rows(jnp.asarray(rp32), jnp.asarray(sizes),
                                         jnp.asarray(offsets), total, min_row))
    got = prb.assemble_rows(_t(rp32), _t(sizes), _t(offsets), total, min_row)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.concatenate([rp[r, : sizes[r]] for r in range(n)]))


def test_wrappers_reject_wrong_types():
    with pytest.raises(ValueError, match="W % 4"):
        prb.rotl_take(torch.zeros((2, 6), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="out_w"):
        prb.rotl_take32(torch.zeros((2, 2), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 12)
    with pytest.raises(ValueError, match="int32"):
        z = torch.zeros((2, 2), dtype=torch.int64)
        prb.asm_epilogue(z, z, z, *(torch.zeros(2, dtype=torch.int32),) * 3, 8)
    with pytest.raises(ValueError, match="uint8 pool"):
        phk.ragged_compact(torch.zeros(4, dtype=torch.int32), torch.zeros(1, dtype=torch.int64),
                           torch.zeros(2, dtype=torch.int64), 0)


def test_cpu_tensors_launch_nothing(rng):
    before = (prb.rotl_take.launches, prb.var_accumulate.launches, prb.asm_epilogue.launches,
              phk.ragged_compact.launches)
    x = _t(rng.integers(0, 256, (9, 16), dtype=np.uint8))
    sh = _t(rng.integers(0, 16, 9).astype(np.int32))
    prb.rotl_take(x, sh, 8)
    prb.var_accumulate([x], [sh], 32)
    z = _t(rng.integers(0, 2**32, (9, 2), dtype=np.uint32))
    prb.asm_epilogue(z, z, z, sh % 8, sh, sh, 8)
    pool, base, offs, total = _ragged_case(rng, "word_straddling")
    phk.ragged_compact(_t(pool), _t(base), _t(offs), total)
    assert (prb.rotl_take.launches, prb.var_accumulate.launches, prb.asm_epilogue.launches,
            phk.ragged_compact.launches) == before
