"""Port: B3's design (``csrc/groupby.cu`` ``groupby_outer_kernel``) on the
CPU.

The kernel cannot run here, so its plan is emulated in numpy: the grid
and scratch that ``hopper_kernels.outer_plan`` sizes, the rows each block
strides over (a thread's kUnroll rows a grid stride apart), the per-block
histograms stored as the [G, K] float64 and u32 partials, and the fixed
order in which each block sums its columns down them; above kSharedKeys
keys, one float64 and one u64 scratch that every row adds into. The
emulation is held against ``groupby_sum_outer_plain`` and the JAX
package's ``pallas_groupby_sum_outer`` (its Pallas body in interpret
mode, as the package's own tests run it): counts exact, float32 sums
within rtol 2e-6 / atol 1e-3, the reference's bound
(tests/test_pallas_kernels.py), since the kernel adds in another order.
The constants the emulation shares with the kernel are read from the
source.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_groupby_sum_outer

from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk

RTOL, ATOL = 2e-6, 1e-3
SOURCE = Path(hk.__file__).resolve().parent.parent / "csrc" / "groupby.cu"
H100_SMS = 132


def _constant(name):
    """An integer ``constexpr`` of csrc/groupby.cu (literals and ``<<``)."""
    expr = re.search(rf"constexpr int(?:64_t)? {name} = ([^;]+);", SOURCE.read_text()).group(1)
    tree = ast.parse(expr, mode="eval").body
    if isinstance(tree, ast.BinOp) and isinstance(tree.op, ast.LShift):
        return ast.literal_eval(tree.left) << ast.literal_eval(tree.right)
    return ast.literal_eval(tree)


@pytest.fixture
def rng():
    return np.random.default_rng(20261017)


@pytest.mark.parametrize("name,value", [
    ("kOuterThreads", hk._OUTER_THREADS), ("kOuterBlocksPerSM", hk._OUTER_BLOCKS_PER_SM),
    ("kSharedKeys", hk._OUTER_SHARED_KEYS), ("kPartialBytes", hk._OUTER_PARTIAL_BYTES),
    ("kOuterKeys", hk.MAX_KEYS)])
def test_wrapper_constants_match_the_kernel(name, value):
    assert _constant(name) == value


def test_the_histogram_fits_a_block():
    # a double and a u32 a key at kSharedKeys, within the H100's 227 KB a
    # block, kOuterBlocksPerSM blocks on its 228 KB a SM (1 KB of it
    # reserved a block); the column pass's lanes (16 B a thread) reuse the
    # histogram's bytes, which are at least that many from 1,366 keys on
    smem = _constant("kSharedKeys") * 12
    assert smem <= 227 * 1024
    assert _constant("kOuterBlocksPerSM") * (smem + 1024) <= 228 * 1024
    assert _constant("kOuterThreads") * 16 <= 227 * 1024
    assert re.search(r"std::max<size_t>\(\(size_t\)K \* kBytesPerKey, \(size_t\)kOuterThreads \* 16\)",
                     SOURCE.read_text())


@pytest.mark.parametrize("n,num_keys,want", [
    (1, 1, (1, 12)), (1024, 4096, (1, 12 * 4096)), (1025, 4096, (2, 2 * 12 * 4096)),
    (1 << 20, 4096, (132, 132 * 12 * 4096)), ((1 << 24) - 1, 8192, (132, 132 * 12 * 8192)),
    (1, 8193, (9, 16 * 8193)), (200_000, 65536, (132, 16 * 65536)), (5, 65536, (64, 16 * 65536))])
def test_outer_plan(n, num_keys, want):
    blocks, nbytes = hk.outer_plan(n, num_keys, H100_SMS)
    assert (blocks, nbytes) == want
    if num_keys <= hk._OUTER_SHARED_KEYS:
        assert nbytes <= hk._OUTER_PARTIAL_BYTES  # the partials stay well inside the 50 MB L2


def emulate_outer(keys: np.ndarray, vals: np.ndarray, num_keys: int, sms: int = H100_SMS):
    """The kernel's plan in numpy: (sums float32, counts int64). The
    co-resident grid is taken as kOuterBlocksPerSM a SM, so the launch
    takes the plan's blocks."""
    n = keys.shape[0]
    if n == 0:  # the wrapper launches nothing
        return np.zeros(num_keys, np.float32), np.zeros(num_keys, np.int64)
    threads = _constant("kOuterThreads")
    grid, nbytes = hk.outer_plan(n, num_keys, sms)
    grid = min(grid, sms * _constant("kOuterBlocksPerSM"))
    k = keys.astype(np.int64)  # compared at the key's own width: no wrap
    keep = (k >= 0) & (k < num_keys)
    v = vals.astype(np.float32).astype(np.float64)
    if num_keys > _constant("kSharedKeys"):
        assert nbytes == 16 * num_keys  # a [K] float64 and a [K] u64 scratch
        sums = np.bincount(k[keep], weights=v[keep], minlength=num_keys)
        counts = np.bincount(k[keep], minlength=num_keys)
        return sums.astype(np.float32), counts.astype(np.int64)
    assert nbytes == grid * num_keys * 12
    # row i lies in the grid stride's slot i % (grid * threads): thread
    # (i % stride) of the grid, in block (i % stride) // threads
    block = (np.arange(n) % (grid * threads)) // threads
    cell = block[keep] * num_keys + k[keep]
    psum = np.bincount(cell, weights=v[keep], minlength=grid * num_keys).reshape(grid, num_keys)
    pcnt = np.bincount(cell, minlength=grid * num_keys).reshape(grid, num_keys).astype(np.uint32)
    sums = np.zeros(num_keys, np.float64)
    counts = np.zeros(num_keys, np.uint64)
    cpb = -(-num_keys // grid)  # columns a block
    if cpb >= threads:  # a thread a column, down all rows in order
        for b in range(grid):
            sums += psum[b]
            counts += pcnt[b]
    else:  # lanes threads a column: lane l sums rows l, l + lanes, ...; then the lanes in order
        lanes = threads // cpb
        for lane in range(lanes):
            t = np.zeros(num_keys, np.float64)
            m = np.zeros(num_keys, np.uint64)
            for b in range(lane, grid, lanes):
                t += psum[b]
                m += pcnt[b]
            sums += t
            counts += m
    return sums.astype(np.float32), counts.astype(np.int64)


def _hold(keys, vals, num_keys):
    es, ec = emulate_outer(keys, vals, num_keys)
    ps, pc = hk.groupby_sum_outer_plain(torch.from_numpy(keys), torch.from_numpy(vals), num_keys)
    js, jc = pallas_groupby_sum_outer(jnp.asarray(keys.astype(np.int64)), jnp.asarray(vals),
                                      num_keys, interpret=True)
    np.testing.assert_array_equal(ec, pc.numpy())
    np.testing.assert_array_equal(ec, np.asarray(jc))
    np.testing.assert_allclose(es, ps.numpy(), rtol=RTOL, atol=ATOL, equal_nan=True)
    np.testing.assert_allclose(es, np.asarray(js), rtol=RTOL, atol=ATOL, equal_nan=True)
    return es, ec


@pytest.mark.parametrize("num_keys", [1, 7, 130, 4096, 8192, 8193, 65536])
@pytest.mark.parametrize("n", [0, 1, 511, 513, 200_000])
def test_emulated_plan_matches_plain_and_jax(rng, n, num_keys):
    keys = rng.integers(-5, num_keys + 5, n)
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    _, counts = _hold(keys, vals, num_keys)
    assert int(counts.sum()) == int(((keys >= 0) & (keys < num_keys)).sum())


@pytest.mark.parametrize("num_keys", [7, 4096, 65536])
@pytest.mark.parametrize("np_dt", [np.int32, np.int64])
def test_emulated_plan_drops_keys_outside_the_domain(rng, num_keys, np_dt):
    info = np.iinfo(np_dt)
    keys = rng.integers(info.min, info.max, 20_000, dtype=np_dt)  # nearly all out of domain
    keys[::97] = rng.integers(0, num_keys, keys[::97].shape[0])
    if np_dt == np.int64:
        keys[1::53] = 2**32 + rng.integers(0, num_keys, keys[1::53].shape[0])  # wrap into it at 32 bits
    vals = rng.standard_normal(20_000).astype(np.float32)
    _hold(keys, vals, num_keys)
    none = np.full(1000, num_keys, np_dt)  # every key out of domain
    es, ec = _hold(none, vals[:1000], num_keys)
    assert not ec.any() and not es.any()


@pytest.mark.parametrize("num_keys", [16, 8193])
def test_emulated_plan_keeps_nan_and_inf(rng, num_keys):
    keys = rng.integers(0, num_keys, 5000)
    vals = rng.standard_normal(5000).astype(np.float32)
    keys[:6] = [1, 1, 2, 3, 4, 5]
    vals[:6] = [np.nan, 1.0, np.inf, -np.inf, np.inf, np.nan]
    keys[6:] = np.where(np.isin(keys[6:], [1, 2, 3, 4, 5]), 0, keys[6:])
    vals[6] = -np.inf
    keys[6] = 4  # +inf and -inf in one bin
    es, _ = emulate_outer(keys, vals, num_keys)
    ps, _ = hk.groupby_sum_outer_plain(torch.from_numpy(keys), torch.from_numpy(vals), num_keys)
    assert np.isnan(es[[1, 4, 5]]).all() and es[2] == np.inf and es[3] == -np.inf
    np.testing.assert_allclose(es, ps.numpy(), rtol=RTOL, atol=ATOL, equal_nan=True)
