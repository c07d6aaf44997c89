"""Ports of the JAX package's ``ops/pallas_kernels.py`` kernels.

- ``partition_map`` (B1), murmur3_32(key, seed 42) pmod P of one 4- or
  8-byte integer key column, the counterpart of ``pallas_partition_map``:
  the kernel in ``csrc/partition.cu`` on a CUDA tensor,
  ``partition_map_plain`` on a CPU tensor. It also takes the column's
  validity (a null row keeps the seed, as ``hash_partition_map`` has it).
- ``probe_paged`` (B4), the paged hash-join probe, the counterpart of
  ``pallas_probe_paged``: per probe row, ``(lo, eq)`` over the table that
  ``paged_join.build_paged_table`` builds. The kernel in ``csrc/join.cu``
  searches the row's bucket's fences in shared memory and counts one
  segment of its slots on a CUDA tensor; ``probe_paged_plain`` compares
  the bucket's pages slot by slot, as the reference does, on a CPU
  tensor.
- ``groupby_sum_bounded`` (B2), the one-hot bounded GROUP BY SUM over
  at most 4096 keys, the counterpart of ``pallas_groupby_sum_bounded``
  (the ``pallas_`` prefix dropped, as for the others): the kernel in
  ``csrc/groupby.cu`` on a CUDA tensor, ``groupby_sum_bounded_plain`` on
  a CPU tensor. Not to be confused with ``ops.aggregate.groupby_sum_bounded``,
  the GROUP BY SUM + COUNT entry point of the aggregate tier, which
  routes float32 values to B3 as the reference's does.
- ``groupby_sum_outer`` (B3), bounded-domain GROUP BY SUM + COUNT, the
  counterpart of ``pallas_groupby_sum_outer``: the hand-written kernel in
  ``csrc/groupby.cu`` on a CUDA tensor, ``groupby_sum_outer_plain`` on a
  CPU tensor. The reference's one-hot bf16-limb matrix product existed
  only because the TPU has no scatter; the kernel computes the same
  function with shared-memory atomics instead, in one cooperative launch
  (``outer_plan`` sizes its grid and scratch).
- ``ragged_compact`` (B5), the dense ragged gather of the string decode,
  the counterpart of ``pallas_ragged_compact``: the kernel in
  ``csrc/strings.cu`` on a CUDA tensor, ``ragged_compact_plain`` (the
  reference's scatter/cummax formulation, ``ragged_bytes.ragged_compact``)
  on a CPU tensor. A CUDA kernel has no VMEM windows to probe, so the
  reference's window caps and its keep-XLA ``None`` do not apply.
  ``ragged_compact_many`` runs the same kernel over every string column
  of a decode in one launch, and can add each row's start to its slot
  offset in the kernel; ``ragged_compact`` is its table of one column.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from .murmur import SEED, murmur3_words, pmod
from .paged_join import (PAGE, PagedHashTable, bucket_of, compare_form, key_words, order_words,
                         unpack_meta)
from .ragged_bytes import build_pool32
from .ragged_bytes import ragged_compact as ragged_compact_plain
from .uword import split_u64, u32_to_i64
from ..utils.dispatch import note_tier

__all__ = [
    "MAX_KEYS",
    "MAX_ONEHOT_KEYS",
    "groupby_sum_bounded",
    "groupby_sum_bounded_plain",
    "partition_map",
    "partition_map_plain",
    "probe_paged",
    "probe_paged_plain",
    "groupby_sum_outer",
    "groupby_sum_outer_plain",
    "outer_plan",
    "compact_block_plan",
    "ragged_compact",
    "ragged_compact_many",
    "ragged_compact_plain",
]

# threads a block and blocks per SM for B1's one-thread-per-row kernel:
# a grid-stride loop over rows
_ROW_THREADS = 256
_ROW_BLOCKS_PER_SM = 16


def _row_grid(n: int, dev: torch.device) -> int:
    sms = _build.sm_count(dev.index)
    return max(1, min((n + _ROW_THREADS - 1) // _ROW_THREADS, sms * _ROW_BLOCKS_PER_SM))


def _check_valid(valid: Optional[torch.Tensor], keys: torch.Tensor) -> Optional[torch.Tensor]:
    if valid is None:
        return None
    if valid.shape != keys.shape or valid.device != keys.device:
        raise ValueError("validity must be a [N] mask on the keys' device")
    return valid if valid.dtype == torch.bool else valid.to(torch.bool)


def _check_partition(keys: torch.Tensor, num_partitions: int) -> None:
    if keys.dtype not in (torch.int32, torch.int64) or keys.dim() != 1:
        raise ValueError(f"partition_map supports 1-D 4/8-byte integer keys, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if not 1 <= num_partitions < 2**31:
        raise ValueError(f"num_partitions must be in [1, 2^31), got {num_partitions}")


def partition_map_plain(keys: torch.Tensor, num_partitions: int,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of B1: [N] int32 pmod(murmur3_32(key, 42), P), an
    int64 key hashed as its low then its high word; a null row keeps the
    seed 42."""
    _check_partition(keys, num_partitions)
    valid = _check_valid(valid, keys)
    if keys.dtype == torch.int64:
        words = [u32_to_i64(w) for w in split_u64(keys)]
    else:
        words = [u32_to_i64(keys)]
    h = murmur3_words(words, SEED)
    if valid is not None:
        h = torch.where(valid, h, SEED)
    return pmod(h, num_partitions)


def partition_map(keys: torch.Tensor, num_partitions: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1: [N] int32 partition ids, bit-exact with ``hash_partition_map``
    on one INT32/INT64 column. Kernel on CUDA tensors, plain version on
    CPU tensors; other key types raise ValueError."""
    _check_partition(keys, num_partitions)
    valid = _check_valid(valid, keys)
    if keys.device.type == "cpu":
        return partition_map_plain(keys, num_partitions, valid)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n:
        keys = keys.contiguous()
        vptr = None if valid is None else valid.contiguous().data_ptr()
        rc = _build.library("partition").partition_map_launch(
            keys.data_ptr(), keys.element_size(), vptr, out.data_ptr(), n, num_partitions,
            _row_grid(n, keys.device), _build.raw_stream(keys.device),
        )
        _build.check(rc, "partition_map")
        with _PARTITION_COUNT_LOCK:  # the exchange's ranks partition in threads
            partition_map.launches += 1
    return out


partition_map.launches = 0
_PARTITION_COUNT_LOCK = threading.Lock()


def _check_probe(keys: torch.Tensor, table: PagedHashTable) -> None:
    if keys.dim() != 1:
        raise ValueError(f"probe keys must be 1-D, got {tuple(keys.shape)}")
    if (8 if keys.element_size() == 8 else 4) != table.nlimb:
        raise ValueError("probe key width does not match the build table")
    if table.meta.device != keys.device:
        raise ValueError("probe keys and the table must lie on one device")


# probe rows compared at once by the plain version ([rows, 128] slots)
_PLAIN_PROBE_ROWS = 1 << 16


def probe_paged_plain(keys: torch.Tensor, valid: Optional[torch.Tensor],
                      table: PagedHashTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B4, the reference's algorithm without its limbs:
    each probe row gathers its bucket's chain pages one step at a time and
    counts the occupied slots below and equal to its order word. Returns
    ``(lo, eq)`` int32; a null row visits no pages (``lo`` is its
    bucket's first rank, ``eq`` 0)."""
    _check_probe(keys, table)
    valid = _check_valid(valid, keys)
    u = order_words(keys)
    bucket = bucket_of(u, table.num_buckets).clamp(0, table.num_buckets - 1)
    page_first, _, start = unpack_meta(table.meta[bucket])
    cnt = table.counts[bucket].to(torch.int64)
    if valid is not None:
        cnt = torch.where(valid, cnt, 0)
    key = compare_form(u)
    pages = compare_form(table.slots).view(table.n_pages, PAGE)
    lane = torch.arange(PAGE, device=keys.device)
    lt = torch.zeros_like(key)
    eq = torch.zeros_like(key)
    for r0 in range(0, key.shape[0], _PLAIN_PROBE_ROWS):
        rows = slice(r0, r0 + _PLAIN_PROBE_ROWS)
        k, pf, c = key[rows, None], page_first[rows], cnt[rows, None]
        for step in range(table.c_max):
            live = (step * PAGE + lane)[None, :] < c
            s = pages[(pf + step).clamp(max=table.n_pages - 1)]
            lt[rows] += ((s < k) & live).sum(1)
            eq[rows] += ((s == k) & live).sum(1)
    return (start + lt).to(torch.int32), eq.to(torch.int32)


def probe_paged(keys: torch.Tensor, valid: Optional[torch.Tensor],
                table: PagedHashTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: stream probe keys through the page table. Returns ``(lo, eq)``
    int32 [N]: probe row i matches build rows
    ``r_order[lo[i] : lo[i] + eq[i]]`` (equal keys in build-row order).
    Kernel on CUDA tensors, plain version on CPU tensors. The kernel
    searches the table's fences, so a table on the card must carry them
    (``build_paged_table`` adds them, contiguous and aligned as the
    kernel reads them); one without raises ValueError, and one the launch
    refuses (a misaligned or oversized table) raises RuntimeError."""
    _check_probe(keys, table)
    valid = _check_valid(valid, keys)
    if keys.device.type == "cpu":
        return probe_paged_plain(keys, valid, table)
    if table.fences is None:
        raise ValueError("the table carries no fences for the probe kernel: build it with "
                         "paged_join.build_paged_table")
    n = keys.shape[0]
    dev = keys.device
    lo = torch.empty((n,), dtype=torch.int32, device=dev)
    eq = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        words, flip = key_words(keys)
        if not words.is_contiguous():
            words = words.contiguous()
        vptr = None if valid is None else valid.contiguous().data_ptr()
        t = table
        rc = _build.library("join").probe_paged_launch(
            words.data_ptr(), words.element_size(), int(flip), vptr, t.slots.data_ptr(),
            t.fences.data_ptr(), t.fences.numel(), t.fence_stride, t.fence_first.data_ptr(),
            t.counts.data_ptr(), t.meta.data_ptr(), t.num_buckets, t.n_pages, n,
            lo.data_ptr(), eq.data_ptr(), _build.raw_stream(dev),
        )
        _build.check(rc, "probe_paged")
        probe_paged.launches += 1
    return lo, eq


probe_paged.launches = 0

MAX_KEYS = 65536

# B3's launch (csrc/groupby.cu): threads a block (kOuterThreads), most blocks a
# SM (kOuterBlocksPerSM), the largest domain that takes the per-block
# shared histograms (kSharedKeys) and the cap on their [blocks, K]
# partials (kPartialBytes)
_OUTER_THREADS = 1024
_OUTER_BLOCKS_PER_SM = 1
_OUTER_SHARED_KEYS = 8192
_OUTER_PARTIAL_BYTES = 16 << 20


def outer_plan(n: int, num_keys: int, sms: int) -> Tuple[int, int]:
    """B3's launch for ``n`` >= 1 rows over ``num_keys`` keys on a card of
    ``sms`` SMs: (the most blocks, scratch bytes). Up to
    ``_OUTER_SHARED_KEYS`` keys the scratch is the blocks' [blocks, K]
    float64 and u32 partials, so the blocks are capped by
    ``_OUTER_PARTIAL_BYTES`` and by a block for each ``_OUTER_THREADS``
    rows; above it, a [K] float64 and a [K] u64 scratch. The kernel takes
    at most the co-resident grid of these."""
    blocks = sms * _OUTER_BLOCKS_PER_SM
    if num_keys > _OUTER_SHARED_KEYS:
        rows = max(n, num_keys)
        return max(1, min(blocks, -(-rows // _OUTER_THREADS))), 16 * num_keys
    blocks = min(blocks, _OUTER_PARTIAL_BYTES // (12 * num_keys), -(-n // _OUTER_THREADS))
    blocks = max(1, blocks)
    return blocks, 12 * blocks * num_keys


def _check(keys: torch.Tensor, vals: torch.Tensor, num_keys: int) -> None:
    if num_keys > MAX_KEYS:
        raise ValueError(f"groupby_sum_outer supports num_keys <= {MAX_KEYS}, got {num_keys}")
    if num_keys < 1:
        raise ValueError(f"num_keys must be positive, got {num_keys}")
    if keys.dim() != 1 or vals.dim() != 1 or keys.shape[0] != vals.shape[0]:
        raise ValueError("keys and vals must be 1-D tensors of equal length")
    if keys.device != vals.device:
        raise ValueError("keys and vals must lie on one device")


def groupby_sum_outer_plain(
    keys: torch.Tensor, vals: torch.Tensor, num_keys: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B3: (sums[num_keys] float32, counts[num_keys] int64).
    Keys outside [0, num_keys) are dropped, compared as int64 so a key
    >= 2^32 drops instead of wrapping. Sums accumulate in float64 and
    round once to float32, as the kernel does."""
    _check(keys, vals, num_keys)
    keys = keys.to(torch.int64)
    keep = (keys >= 0) & (keys < num_keys)
    k = keys[keep]
    v = vals[keep].to(torch.float64)
    sums = torch.zeros(num_keys, dtype=torch.float64, device=keys.device).index_add_(0, k, v)
    counts = torch.bincount(k, minlength=num_keys)
    return sums.to(torch.float32), counts


def groupby_sum_outer(
    keys: torch.Tensor, vals: torch.Tensor, num_keys: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: GROUP BY SUM + COUNT over [0, num_keys), num_keys <= 65536.
    Returns (sums float32, counts int64); out-of-domain keys are dropped.
    Kernel on CUDA tensors, plain version on CPU tensors. With INT32/INT64
    keys and float32 values a call enqueues one kernel and nothing else:
    its outputs and its scratch come from ``torch.empty``."""
    _check(keys, vals, num_keys)
    dev = keys.device
    if dev.type == "cpu":
        return groupby_sum_outer_plain(keys, vals, num_keys)
    n = keys.shape[0]
    if not n:
        return (torch.zeros(num_keys, dtype=torch.float32, device=dev),
                torch.zeros(num_keys, dtype=torch.int64, device=dev))
    if keys.dtype != torch.int32 and keys.dtype != torch.int64:
        keys = keys.to(torch.int64)
    if vals.dtype != torch.float32:
        vals = vals.to(torch.float32)
    if not keys.is_contiguous():
        keys = keys.contiguous()
    if not vals.is_contiguous():
        vals = vals.contiguous()
    blocks, scratch_bytes = outer_plan(n, num_keys, _build.sm_count(dev.index))
    sums = torch.empty(num_keys, dtype=torch.float32, device=dev)
    counts = torch.empty(num_keys, dtype=torch.int64, device=dev)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    rc = _build.library("groupby").groupby_sum_outer_launch(
        keys.data_ptr(), keys.element_size(), vals.data_ptr(), scratch.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), n, num_keys, blocks, _build.raw_stream(dev),
    )
    _build.check(rc, "groupby_sum_outer")
    groupby_sum_outer.launches += 1
    return sums, counts


groupby_sum_outer.launches = 0


MAX_ONEHOT_KEYS = 4096


def _check_onehot(keys: torch.Tensor, vals: torch.Tensor, num_keys: int) -> None:
    if num_keys > MAX_ONEHOT_KEYS:
        raise ValueError(f"groupby_sum_bounded supports num_keys <= {MAX_ONEHOT_KEYS}, "
                         f"got {num_keys}")
    if num_keys < 0:
        raise ValueError(f"num_keys must not be negative, got {num_keys}")
    if keys.dim() != 1 or vals.dim() != 1 or keys.shape[0] != vals.shape[0]:
        raise ValueError("keys and vals must be 1-D tensors of equal length")
    if keys.is_floating_point() or keys.dtype == torch.bool:
        raise ValueError(f"keys must be integers, got {keys.dtype}")
    if keys.device != vals.device:
        raise ValueError("keys and vals must lie on one device")


def groupby_sum_bounded_plain(keys: torch.Tensor, vals: torch.Tensor,
                              num_keys: int) -> torch.Tensor:
    """Plain version of B2: float32 [num_keys] sums. The domain check runs
    on the key's own width, so an int64 key >= 2^32 drops; values are cast
    to float32, then summed in float64 and rounded once, as the kernel
    does."""
    _check_onehot(keys, vals, num_keys)
    keep = (keys >= 0) & (keys < num_keys)
    v = vals[keep].to(torch.float32).to(torch.float64)
    sums = torch.zeros(num_keys, dtype=torch.float64, device=keys.device)
    return sums.index_add_(0, keys[keep].to(torch.int64), v).to(torch.float32)


# B2's most blocks a SM (kOnehotBlocksPerSM in csrc/groupby.cu): the rows
# of its [blocks, K] float64 partial sums
_ONEHOT_BLOCKS_PER_SM = 2


def groupby_sum_bounded(keys: torch.Tensor, vals: torch.Tensor, num_keys: int) -> torch.Tensor:
    """B2: GROUP BY SUM over [0, num_keys), num_keys <= 4096 (ValueError
    above), float32 [num_keys]; out-of-domain keys are dropped, an empty
    input gives zeros. Kernel on CUDA tensors, plain version on CPU
    tensors. With INT32/INT64 keys and float32 values a call enqueues one
    kernel and nothing else: its output and its per-block float64 partial
    sums come from ``torch.empty``."""
    _check_onehot(keys, vals, num_keys)
    dev = keys.device
    if dev.type == "cpu":
        return groupby_sum_bounded_plain(keys, vals, num_keys)
    n = keys.shape[0]
    if not n or not num_keys:
        return torch.zeros(num_keys, dtype=torch.float32, device=dev)
    if keys.dtype != torch.int32 and keys.dtype != torch.int64:
        keys = keys.to(torch.int64)  # widening keeps every value
    if vals.dtype != torch.float32:
        vals = vals.to(torch.float32)
    if not keys.is_contiguous():
        keys = keys.contiguous()
    if not vals.is_contiguous():
        vals = vals.contiguous()
    blocks = _build.sm_count(dev.index) * _ONEHOT_BLOCKS_PER_SM
    out = torch.empty(num_keys, dtype=torch.float32, device=dev)
    partial = torch.empty((blocks, num_keys), dtype=torch.float64, device=dev)
    rc = _build.library("groupby").groupby_sum_bounded_launch(
        keys.data_ptr(), keys.element_size(), vals.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, num_keys, blocks, _build.raw_stream(dev),
    )
    _build.check(rc, "groupby_sum_bounded")
    groupby_sum_bounded.launches += 1
    return out


groupby_sum_bounded.launches = 0


# B5's grid: output words a block owns (kCompactWords in csrc/strings.cu);
# up to _COMPACT_BY_VALUE columns travel in the kernel's arguments
# (kCompactByValue), more in a device table
_COMPACT_WORDS = 2048
_COMPACT_BY_VALUE = 32


def compact_block_plan(totals: Sequence[int], words: int = _COMPACT_WORDS) -> Tuple[List[int], int]:
    """B5's grid over string columns of ``totals`` bytes: each column's
    first block and the launch's block count. A column owns
    ceil(ceil(total / 4) / words) blocks, in order; an empty one none."""
    first, blocks = [], 0
    for t in totals:
        first.append(blocks)
        blocks += ((int(t) + 3) // 4 + words - 1) // words
    return first, blocks


def _check_compact(pool: torch.Tensor, columns, row_starts: Optional[torch.Tensor] = None) -> None:
    if pool.dim() != 1 or pool.dtype != torch.uint8:
        raise ValueError(f"ragged_compact expects a 1-D uint8 pool, got {tuple(pool.shape)} {pool.dtype}")
    dev = pool.device
    for base, offs, _ in columns:
        if offs.shape != (base.shape[0] + 1,) or base.device != dev or offs.device != dev:
            raise ValueError("ragged_compact needs base [N] and offs [N+1] on the pool's device")
        if row_starts is not None and row_starts.shape != base.shape:
            raise ValueError("row_starts must be [N] on the pool's device")
    if row_starts is not None and row_starts.device != dev:
        raise ValueError("row_starts must be [N] on the pool's device")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor, without a dispatch when it
    already is one (a launch over 16 columns calls this 48 times)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _compact_launch(pool: torch.Tensor, cols, counter) -> List[torch.Tensor]:
    """One B5 launch over ``cols``, each ``(base64, off32, offs, total)``
    (``base64`` int64 [N] or None, ``off32`` int32 [N] u32 bits or None;
    row r's bytes start at their sum). The outputs are slices of one
    uint8 buffer, each column 16-byte aligned. ``counter`` is the wrapper
    whose ``.launches`` moves."""
    dev = pool.device
    totals = [int(c[3]) if c[2].shape[0] > 1 else 0 for c in cols]
    starts, nbytes = [], 0
    for t in totals:
        starts.append(nbytes)
        nbytes += (t + 15) // 16 * 16
    buf = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    outs = [buf[b : b + t] for b, t in zip(starts, totals)]
    live = [k for k, t in enumerate(totals) if t]
    if not live:
        return outs
    otype = torch.int32 if all(cols[k][2].dtype == torch.int32 for k in live) else torch.int64
    first, blocks = compact_block_plan([totals[k] for k in live])
    pool = _as(pool, torch.uint8)
    keep, entries = [pool], []
    addr = buf.data_ptr()
    for k, fb in zip(live, first):
        base64, off32, offs, t = cols[k]
        base64 = None if base64 is None else _as(base64, torch.int64)
        off32 = None if off32 is None else _as(off32, torch.int32)
        offs = _as(offs, otype)
        keep += (base64, off32, offs)
        entries += (0 if base64 is None else base64.data_ptr(),
                    0 if off32 is None else off32.data_ptr(), offs.data_ptr(), addr + starts[k],
                    offs.shape[0] - 1, t, fb)
    host = (ctypes.c_int64 * len(entries))(*entries)
    table = None
    if len(live) > _COMPACT_BY_VALUE:
        table = torch.tensor(entries, dtype=torch.int64).to(dev)
    rc = _build.library("strings").ragged_compact_launch(
        ctypes.addressof(host), None if table is None else table.data_ptr(), len(live),
        otype.itemsize, pool.data_ptr(), pool.shape[0], blocks, _build.raw_stream(dev))
    _build.check(rc, "ragged_compact")
    counter.launches += 1
    return outs


def ragged_compact(
    pool: torch.Tensor,
    base: torch.Tensor,
    offs: torch.Tensor,
    total: int,
    pool32: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B5: out[offs[r] + j] = pool[base[r] + j] for j < offs[r+1] -
    offs[r]; uint8 [total]. ``offs`` [N+1] dense from 0, ``base`` [N],
    as ``ragged_bytes.ragged_compact`` documents. Kernel on CUDA tensors
    (it reads the byte pool itself and ignores ``pool32``), plain version
    on CPU tensors (``pool32``: its word view, shared across columns).
    The reference's eager tier dispatcher (``ragged_compact_tiered``)
    notes its tier here: ``dispatch.tier.cuda`` or ``dispatch.tier.torch``."""
    _check_compact(pool, [(base, offs, total)])
    if pool.device.type == "cpu":
        note_tier("torch", "ragged_compact")
        return ragged_compact_plain(pool, base, offs, total, pool32=pool32)
    note_tier("cuda", "ragged_compact")
    return _compact_launch(pool, [(base, None, offs, total)], ragged_compact)[0]


ragged_compact.launches = 0


def ragged_compact_many(
    pool: torch.Tensor,
    columns: Sequence[Tuple[torch.Tensor, torch.Tensor, int]],
    row_starts: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """B5 over several string columns of one pool, one launch: for each
    ``(base, offs, total)`` the uint8 [total] ``ragged_compact(pool, base,
    offs, total)``. With ``row_starts`` ([N] int64), each ``base`` is an
    [N] int32 of u32 slot offsets and row r's bytes start at
    ``row_starts[r] + base[r]`` (the decode's row start plus the slot's
    offset, added in the kernel). Kernel on CUDA tensors, the plain
    version column by column on CPU tensors."""
    _check_compact(pool, columns, row_starts)
    if pool.device.type == "cpu":
        pool32 = build_pool32(pool) if any(int(t) for _, _, t in columns) else None
        out = []
        for base, offs, total in columns:
            if row_starts is not None:
                base = row_starts.to(torch.int64) + u32_to_i64(base)
            out.append(ragged_compact_plain(pool, base, offs, total, pool32=pool32))
        return out
    if row_starts is None:
        cols = [(base, None, offs, total) for base, offs, total in columns]
    else:
        cols = [(row_starts, base, offs, total) for base, offs, total in columns]
    return _compact_launch(pool, cols, ragged_compact_many)


ragged_compact_many.launches = 0
