"""Port: B4's design (``csrc/join.cu`` ``probe_fenced_kernel``) on the CPU.

The kernel cannot run here, so its plan is emulated in numpy and held
against the plain probe (``hopper_kernels.probe_paged_plain``) and the
JAX package's ``pallas_probe_paged`` (its Pallas body in interpret mode,
as the package's own tests run it). All exact.

- The fences ``build_paged_table`` derives: every S-th slot,
  ``slots[::S]``, and each bucket's first fence, with S
  (``fence_stride``) chosen so that a segment is at least a sector and
  the fences and the buckets' metadata fit a block's shared memory for
  every table within the page cap.
- The probe: for each row the kernel's binary search over its bucket's
  fences for the first one >= u, the one segment of S slots before it
  that holds the lower bound, and, only where that fence equals u, a
  second search for the first fence > u and the upper bound's segment
  (runs that cross a segment or a page, the skewed chain of 16 pages).
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
from spark_rapids_jni_tpu.ops.pallas_kernels import build_paged_table as jbuild
from spark_rapids_jni_tpu.ops.pallas_kernels import pallas_probe_paged

from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import paged_join as pj

import torch_paged_cases as cases

SOURCE = Path(pj.__file__).resolve().parent.parent / "csrc" / "join.cu"


def _constant(name):
    """An integer ``constexpr`` of csrc/join.cu."""
    expr = re.search(rf"constexpr int(?:64_t)? {name} = ([^;]+);", SOURCE.read_text()).group(1)
    return int(ast.literal_eval(expr))


@pytest.fixture
def rng():
    return np.random.default_rng(20261017)


def _tkeys(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


def _shared_bytes(table) -> int:
    """A probe block's shared memory for ``table``: 12 B a bucket (count,
    first page, first rank, first fence) and the fences."""
    return 12 * table.num_buckets + table.fences.numel() * table.fences.element_size()


# -- the fences -------------------------------------------------------------------


@pytest.mark.parametrize("n_pages,word_bytes,want", [
    (1, 4, 8), (1024, 4, 8), (2048, 4, 8), (1, 8, 4), (512, 8, 4), (513, 8, 8), (1024, 8, 8),
    (1025, 8, 16), (2048, 8, 16)])
def test_fence_stride(n_pages, word_bytes, want):
    s = pj.fence_stride(n_pages, word_bytes)
    assert s == want
    # a segment is at least a sector, whole 16-byte vectors within a page
    assert s * word_bytes >= 32 and pj.PAGE % s == 0
    assert n_pages * pj.PAGE // s * word_bytes <= pj.MAX_FENCE_BYTES


def test_fence_stride_past_the_page_cap():
    with pytest.raises(ValueError, match="fences"):
        pj.fence_stride(2 * pj.MAX_PAGES, 8)


def test_every_table_of_the_page_cap_fits_shared_memory():
    # the largest: 2,048 buckets and pages of int64 words; at the last
    # stride its fences (128 KB) and 12 B a bucket fit the kernel's opt-in
    fences = pj.MAX_PAGES * pj.PAGE // pj._FENCE_STRIDES[-1] * 8
    assert fences == 131_072 <= pj.MAX_FENCE_BYTES
    assert 12 * pj.MAX_PAGES + pj.MAX_FENCE_BYTES <= 227 * 1024  # an H100 block's opt-in


@pytest.mark.parametrize("np_dt", [np.int8, np.int32, np.int64])
@pytest.mark.parametrize("nulls", [False, True])
def test_fences_are_every_sth_slot_of_each_bucket(rng, np_dt, nulls):
    keys, _ = cases.boundary_build(rng, np_dt)
    valid = torch.from_numpy(rng.random(keys.shape[0]) < 0.8) if nulls else None
    t = pj.build_paged_table(_tkeys(keys), valid)
    s = t.fence_stride
    assert s == pj.fence_stride(t.n_pages, t.slots.element_size())
    assert t.fences.dtype == t.slots.dtype and t.fences.is_contiguous()
    assert torch.equal(t.fences, t.slots[::s])
    assert t.fences.numel() * t.fences.element_size() % 16 == 0
    page_first, _, _ = pj.unpack_meta(t.meta)
    assert t.fence_first.dtype == torch.int32
    assert torch.equal(t.fence_first.to(torch.int64), page_first * (pj.PAGE // s))
    for b in range(t.num_buckets):
        c, pf, f0 = int(t.counts[b]), int(page_first[b]), int(t.fence_first[b])
        want = t.slots[pf * pj.PAGE: pf * pj.PAGE + c][::s]
        assert torch.equal(t.fences[f0: f0 + want.numel()], want), b


def test_kernel_constants_match_the_wrapper():
    assert _constant("kPageSlots") == pj.PAGE
    assert _constant("kProbeThreads") % 32 == 0
    # the launch takes the strides fence_stride gives, and refuses others:
    # 8 for 4-byte words, 4, 8 or 16 for 8-byte words
    assert re.search(r"word_bytes == 4 \? stride == 8 : stride == 4 \|\| stride == 8 \|\| "
                     r"stride == 16;", SOURCE.read_text())
    assert pj._FENCE_STRIDES == (4, 8, 16)
    pages = range(1, pj.MAX_PAGES + 1)
    assert {pj.fence_stride(p, 4) for p in pages} == {8}
    assert {pj.fence_stride(p, 8) for p in pages} == {4, 8, 16}
    # a bucket's count (at most 128 a page) fits the 20 bits its shared
    # word gives it up to the kernel's page limit, which covers the cap
    assert pj.MAX_PAGES <= _constant("kMaxPages") and _constant("kMaxPages") * pj.PAGE < 2**20


# -- the probe, emulated ----------------------------------------------------------


def _fence_search(f, first, a, z, u, less):
    """The kernel's ``fence_search`` for every row at once: the first
    index in [a, z) whose fence is >= u (less) or > u."""
    a, z = a.copy(), z.copy()
    while True:
        act = a < z
        if not act.any():
            return a
        mid = (a + z) >> 1
        fm = f[np.minimum(first + mid, f.shape[0] - 1)]
        go = (fm < u) if less else (fm <= u)
        a = np.where(act & go, mid + 1, a)
        z = np.where(act & ~go, mid, z)


def _count_segment(slots, base, seg, c, u, s, less):
    """#(words [0, c) of segment ``seg`` < u) (less) or <= u, per row
    (``base``: the row's bucket's slot 0)."""
    q = np.arange(s)
    idx = np.clip((base + seg * s)[:, None] + q, 0, slots.shape[0] - 1)
    w = slots[idx]
    hit = (w < u[:, None]) if less else (w <= u[:, None])
    return ((q < c[:, None]) & hit).sum(1)


def emulate_probe(keys: torch.Tensor, valid, table) -> tuple:
    """The kernel's plan in numpy: (lo, eq, rows that loaded a second
    segment). Words compare in their int64 compare form, whose signed
    order is the order words' unsigned order."""
    s = table.fence_stride
    u = pj.compare_form(pj.order_words(keys)).numpy()
    bucket = pj.bucket_of(pj.order_words(keys), table.num_buckets).numpy()
    page_first, _, start = (x.numpy() for x in pj.unpack_meta(table.meta))
    fences = pj.compare_form(table.fences).numpy()
    slots = pj.compare_form(table.slots).numpy()
    cnt = table.counts.numpy().astype(np.int64)[bucket]
    if valid is not None:
        cnt = np.where(valid.numpy(), cnt, 0)  # a null row visits no slots
    first = table.fence_first.numpy().astype(np.int64)[bucket]
    base = page_first[bucket] * pj.PAGE
    nfb = (cnt + s - 1) // s
    zero = np.zeros_like(nfb)
    j = _fence_search(fences, first, zero, nfb, u, True)
    # past j only where fence j equals u
    at_j = (j < nfb) & (fences[np.minimum(first + j, fences.shape[0] - 1)] == u)
    k = np.where(at_j, _fence_search(fences, first, j + 1, nfb, u, False), j)
    low, high = j - 1, k - 1
    lseg = np.maximum(low, 0)
    below = np.where(low >= 0, lseg * s + _count_segment(slots, base, lseg, cnt - lseg * s, u, s,
                                                         True), 0)
    upto_same = lseg * s + _count_segment(slots, base, lseg, cnt - lseg * s, u, s, False)
    hseg = np.maximum(high, 0)
    upto_next = hseg * s + _count_segment(slots, base, hseg, cnt - hseg * s, u, s, False)
    upto = np.where(high > low, upto_next, np.where(low >= 0, upto_same, 0))
    lo = (start[bucket] + below).astype(np.int32)
    return lo, (upto - below).astype(np.int32), int((high > low).sum())


def _hold(lk: np.ndarray, lv, table, jax_rk=None, jax_rv=None):
    """The emulation against the plain probe (every row) and, when the
    build keys are given, against the JAX reference (every row)."""
    keys = _tkeys(lk)
    valid = None if lv is None else torch.from_numpy(lv)
    lo, eq, second = emulate_probe(keys, valid, table)
    plo, peq = hk.probe_paged_plain(keys, valid, table)
    np.testing.assert_array_equal(lo, plo.numpy())
    np.testing.assert_array_equal(eq, peq.numpy())
    if jax_rk is not None:
        jt = jbuild(jnp.asarray(jax_rk), None if jax_rv is None else jnp.asarray(jax_rv))
        jlo, jeq = pallas_probe_paged(jnp.asarray(lk), None if lv is None else jnp.asarray(lv),
                                      jt, interpret=True)
        np.testing.assert_array_equal(lo, np.asarray(jlo))
        np.testing.assert_array_equal(eq, np.asarray(jeq))
    return eq, second


@pytest.mark.parametrize("case", ["random", "null_heavy", "skew"])
@pytest.mark.parametrize("np_dt", [np.int8, np.int32, np.int64])
def test_emulated_probe_matches_plain_and_jax(rng, case, np_dt):
    lk, lv, rk, rv = cases.probe_case(rng, case, np_dt)
    table = pj.build_paged_table(_tkeys(rk), torch.from_numpy(rv))
    assert table is not None
    eq, second = _hold(lk, lv, table, rk, rv)
    assert int(eq.sum()) > 0
    if case == "skew":
        # 2,000 equal keys, a chain of 16 pages: the run's upper bound lies
        # 250 fences on, in a second segment
        assert table.c_max >= 16 and second > 0
    eq2, _ = _hold(lk, None, table)
    assert int(eq2.sum()) >= int(eq.sum())


@pytest.mark.parametrize("np_dt", [np.int8, np.int16, np.int32, np.int64])
def test_emulated_probe_at_segment_and_page_boundaries(rng, np_dt):
    keys, full = cases.boundary_build(rng, np_dt)
    table = pj.build_paged_table(_tkeys(keys))
    # a bucket holding a whole number of segments, and runs past a page
    assert int(table.counts[full]) % table.fence_stride == 0
    assert table.c_max >= 2
    lk, lv = cases.boundary_probes(rng, np_dt, keys, table)
    eq, second = _hold(lk, lv, table, keys)
    assert second > 0  # probes equal to a fence whose run goes on past it
    # every key of the 32-key bucket matches; a key above them all has its
    # lower bound at the bucket's end
    mine = keys[pj.bucket_of(pj.order_words(_tkeys(keys)), table.num_buckets).numpy() == full]
    top = np.asarray([mine.max()], np_dt)
    lo, eq, _ = emulate_probe(_tkeys(top), None, table)
    start = int(pj.unpack_meta(table.meta)[2][full])
    assert int(lo[0] + eq[0]) == start + 32


def test_emulated_probe_on_the_largest_table(rng):
    table, keys = cases.largest_table(rng)
    assert table.fence_stride == 16 and _shared_bytes(table) == 12 * 2048 + 131_072
    lk = np.concatenate([keys, keys[::7] + 1, rng.integers(-2**62, 2**62, 20_000)])
    lv = rng.random(lk.shape[0]) < 0.9
    eq, _ = _hold(lk, lv, table)
    assert int(eq.sum()) > 0
