"""Probe cases for B4 (``hopper_kernels.probe_paged``) shared by the CPU
tests (``test_torch_probe_fences.py``) and the card tests
(``test_torch_cuda.py``). Imports neither jax nor the JAX package, so
the card tests can use it without the repository's conftest.

Each function returns numpy inputs, or a port table on the CPU, from a
seeded ``numpy.random.Generator``."""

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.ops import paged_join as pj

# equal-key runs that end just before, at and just past a segment (8 or
# 16 slots) and a page (128), and runs over several pages
RUNS = (1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 127, 128, 129, 200, 256, 300)


def probe_case(rng, case, np_dt):
    """The random, null_heavy and skew cases: (probe keys, probe
    validity, build keys, build validity). random: 40,000 build rows from
    a pool of 3,000 keys, 250,000 probes (200,000 from the pool); null
    heavy: 5,000 build rows, 70% nulls on both sides; skew: 2,000 equal
    build keys (a chain of 16 pages), 650 probes."""
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
    rv = rng.random(rk.shape[0]) < (0.3 if heavy else 0.95)
    lv = rng.random(lk.shape[0]) < (0.3 if heavy else 0.9)
    return lk, lv, rk, rv


def _num_buckets(n: int) -> int:
    b = 16
    while b * 64 < n and b < 2048:
        b *= 2
    return b


def _bucket_np(keys: np.ndarray, num_buckets: int) -> np.ndarray:
    return pj.bucket_of(pj.order_words(torch.from_numpy(keys)), num_buckets).numpy()


def boundary_build(rng, np_dt):
    """Build keys (no nulls) whose equal-key runs have the lengths of
    ``RUNS``, plus singletons, plus one bucket that holds exactly 32 keys
    (a whole number of segments at either stride) and nothing else.
    Returns the keys and that bucket."""
    info = np.iinfo(np_dt)
    narrow = info.bits <= 16
    domain = np.arange(info.min, info.max + 1) if narrow else None
    values = (rng.choice(domain, len(RUNS), replace=False) if narrow
              else rng.integers(info.min, info.max, len(RUNS), endpoint=True)).astype(np_dt)
    n_singles = 0 if info.bits <= 8 else 1500
    n = sum(RUNS) + n_singles + 32
    nb = _num_buckets(n)  # the build's bucket count for n rows
    full = min(set(range(nb)) - set(_bucket_np(values, nb).tolist()))
    cand = (domain if narrow else rng.integers(info.min, info.max, 1 << 16, endpoint=True))
    cand = np.unique(cand.astype(np_dt))
    in_full = cand[_bucket_np(cand, nb) == full]
    # 32 keys in that bucket: distinct where the domain has them
    mine = rng.choice(in_full, 32, replace=in_full.shape[0] < 32)
    singles = np.zeros(0, np_dt)
    while singles.shape[0] < n_singles:
        more = rng.integers(info.min, info.max, n_singles, dtype=np_dt, endpoint=True)
        singles = np.concatenate([singles, more[_bucket_np(more, nb) != full]])[:n_singles]
    keys = np.concatenate([np.repeat(values, RUNS), singles, mine])
    return rng.permutation(keys), full


def boundary_probes(rng, np_dt, build_keys, table):
    """Probe keys for ``boundary_build``'s table: every build key, every
    fence's key, each of them plus and minus one, and random keys;
    validity 90% valid."""
    info = np.iinfo(np_dt)
    _, _, start = pj.unpack_meta(table.meta)
    counts = table.counts.to(torch.int64)
    ranks = [int(start[b]) + j for b in range(table.num_buckets)
             for j in range(0, int(counts[b]), table.fence_stride)]
    fence_keys = build_keys[table.r_order.numpy()[ranks]]
    base = np.concatenate([build_keys, fence_keys]).astype(np.int64)
    near = np.clip(np.concatenate([base - 1, base + 1]), info.min, info.max)
    lk = np.concatenate([base, near, rng.integers(info.min, info.max, 2000, endpoint=True)])
    lk = rng.permutation(lk.astype(np_dt))
    return lk, rng.random(lk.shape[0]) < 0.9


def largest_table(rng):
    """The table at the probe's shared-memory limit, built by hand in the
    format ``build_paged_table`` gives: 2,048 buckets of one full page
    each (the page cap), int64 order words, with its fences at the stride
    ``fence_stride`` picks (16: 128 KB). Returns the table (CPU tensors)
    and its build keys."""
    nb = 2048
    keys = np.unique(rng.integers(-2**62, 2**62, 400_000))
    bucket = _bucket_np(keys, nb)
    order = np.lexsort((keys, bucket))  # (bucket, key) order, as the build sorts
    keys, bucket = keys[order], bucket[order]
    first = np.searchsorted(bucket, np.arange(nb))
    rank = np.arange(keys.shape[0]) - first[bucket]
    keep = rank < pj.PAGE
    keys, bucket, rank = keys[keep], bucket[keep], rank[keep]
    cnt = np.bincount(bucket, minlength=nb)
    assert (cnt == pj.PAGE).all()
    u = pj.order_words(torch.from_numpy(keys))
    slots = torch.zeros(nb * pj.PAGE, dtype=torch.int64)
    slots[torch.from_numpy(bucket * pj.PAGE + rank)] = u
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    meta = torch.from_numpy((np.arange(nb) << 44) | (1 << 24) | starts)
    stride = pj.fence_stride(nb, 8)
    fence_first = (torch.arange(nb) * (pj.PAGE // stride)).to(torch.int32)
    table = pj.PagedHashTable(slots, torch.from_numpy(cnt.astype(np.int32)), meta,
                              torch.arange(keys.shape[0], dtype=torch.int32), nb, nb, 8, 1,
                              keys.shape[0], slots[::stride].contiguous(), fence_first, stride)
    return table, keys
