"""Ports of the JAX package's ``ops/pallas_kernels.py`` kernels.

- ``partition_map`` (B1), murmur3_32(key, seed 42) pmod P of one 4- or
  8-byte integer key column, the counterpart of ``pallas_partition_map``:
  the kernel in ``csrc/partition.cu`` on a CUDA tensor,
  ``partition_map_plain`` on a CPU tensor. It also takes the column's
  validity (a null row keeps the seed, as ``hash_partition_map`` has it).
- ``probe_paged`` (B4), the paged hash-join probe, the counterpart of
  ``pallas_probe_paged``: per probe row, ``(lo, eq)`` over the table that
  ``paged_join.build_paged_table`` builds. The kernel in ``csrc/join.cu``
  binary-searches the row's bucket on a CUDA tensor; ``probe_paged_plain``
  compares the bucket's pages slot by slot, as the reference does, on a
  CPU tensor.
- ``groupby_sum_outer`` (B3), bounded-domain GROUP BY SUM + COUNT, the
  counterpart of ``pallas_groupby_sum_outer``: the hand-written kernel in
  ``csrc/groupby.cu`` on a CUDA tensor, ``groupby_sum_outer_plain`` on a
  CPU tensor. The reference's one-hot bf16-limb matrix product existed
  only because the TPU has no scatter; the kernel computes the same
  function with shared-memory atomics instead.
- ``ragged_compact`` (B5), the dense ragged gather of the string decode,
  the counterpart of ``pallas_ragged_compact``: the kernel in
  ``csrc/strings.cu`` on a CUDA tensor, ``ragged_compact_plain`` (the
  reference's scatter/cummax formulation, ``ragged_bytes.ragged_compact``)
  on a CPU tensor. A CUDA kernel has no VMEM windows to probe, so the
  reference's window caps and its keep-XLA ``None`` do not apply.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .murmur import SEED, murmur3_words, pmod
from .paged_join import (PAGE, PagedHashTable, bucket_of, compare_form, key_words, order_words,
                         unpack_meta)
from .ragged_bytes import ragged_compact as ragged_compact_plain
from .uword import split_u64, u32_to_i64

__all__ = [
    "MAX_KEYS",
    "partition_map",
    "partition_map_plain",
    "probe_paged",
    "probe_paged_plain",
    "groupby_sum_outer",
    "groupby_sum_outer_plain",
    "ragged_compact",
    "ragged_compact_plain",
]

# threads a block and blocks per SM for the one-thread-per-row kernels
# (B1, B4): a grid-stride loop over rows
_ROW_THREADS = 256
_ROW_BLOCKS_PER_SM = 16


def _row_grid(n: int, dev: torch.device) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min((n + _ROW_THREADS - 1) // _ROW_THREADS, sms * _ROW_BLOCKS_PER_SM))


def _check_valid(valid: Optional[torch.Tensor], keys: torch.Tensor) -> Optional[torch.Tensor]:
    if valid is None:
        return None
    if valid.shape != keys.shape or valid.device != keys.device:
        raise ValueError("validity must be a [N] mask on the keys' device")
    return valid.to(torch.bool)


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
            _row_grid(n, keys.device), torch.cuda.current_stream(keys.device).cuda_stream,
        )
        _build.check(rc, "partition_map")
        partition_map.launches += 1
    return out


partition_map.launches = 0


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
    Kernel on CUDA tensors, plain version on CPU tensors."""
    _check_probe(keys, table)
    valid = _check_valid(valid, keys)
    if keys.device.type == "cpu":
        return probe_paged_plain(keys, valid, table)
    n = keys.shape[0]
    dev = keys.device
    lo = torch.empty((n,), dtype=torch.int32, device=dev)
    eq = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        words, flip = key_words(keys)
        words = words.contiguous()
        vptr = None if valid is None else valid.contiguous().data_ptr()
        rc = _build.library("join").probe_paged_launch(
            words.data_ptr(), words.element_size(), int(flip), vptr, table.slots.data_ptr(),
            table.counts.data_ptr(), table.meta.data_ptr(), table.num_buckets, n,
            lo.data_ptr(), eq.data_ptr(), _row_grid(n, dev), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(rc, "probe_paged")
        probe_paged.launches += 1
    return lo, eq


probe_paged.launches = 0

MAX_KEYS = 65536

# blocks per SM for the kernel's grid-stride row loop: enough to hide
# atomic latency, few enough that the per-block histogram flush stays
# small beside the row pass
_BLOCKS_PER_SM = 2


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
    Kernel on CUDA tensors, plain version on CPU tensors."""
    _check(keys, vals, num_keys)
    if keys.device.type == "cpu":
        return groupby_sum_outer_plain(keys, vals, num_keys)
    dev = keys.device
    keys = keys.to(torch.int64).contiguous()
    vals = vals.to(torch.float32).contiguous()
    sums = torch.zeros(num_keys, dtype=torch.float64, device=dev)
    counts = torch.zeros(num_keys, dtype=torch.int64, device=dev)
    n = keys.shape[0]
    if n:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lib = _build.library("groupby")
        rc = lib.groupby_sum_outer_launch(
            keys.data_ptr(), vals.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            n, num_keys, sms * _BLOCKS_PER_SM, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(rc, "groupby_sum_outer")
        groupby_sum_outer.launches += 1
    return sums.to(torch.float32), counts


groupby_sum_outer.launches = 0


# blocks per SM for the ragged compaction's grid-stride word loop
_COMPACT_BLOCKS_PER_SM = 16


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
    on CPU tensors (``pool32``: its word view, shared across columns)."""
    if pool.dim() != 1 or pool.dtype != torch.uint8:
        raise ValueError(f"ragged_compact expects a 1-D uint8 pool, got {tuple(pool.shape)} {pool.dtype}")
    n = base.shape[0]
    if offs.shape != (n + 1,) or base.device != pool.device or offs.device != pool.device:
        raise ValueError("ragged_compact needs base [N] and offs [N+1] on the pool's device")
    if pool.device.type == "cpu":
        return ragged_compact_plain(pool, base, offs, total, pool32=pool32)
    total = int(total)
    nwords = (total + 3) // 4
    out = torch.empty((nwords,), dtype=torch.int32, device=pool.device)
    if n and total:
        pool = pool.contiguous()
        base = base.to(torch.int64).contiguous()
        offs = offs.to(torch.int64).contiguous()
        sms = torch.cuda.get_device_properties(pool.device).multi_processor_count
        rc = _build.library("strings").ragged_compact_launch(
            pool.data_ptr(), pool.shape[0], base.data_ptr(), offs.data_ptr(), n, total,
            out.data_ptr(), nwords, sms * _COMPACT_BLOCKS_PER_SM,
            torch.cuda.current_stream(pool.device).cuda_stream,
        )
        _build.check(rc, "ragged_compact")
        ragged_compact.launches += 1
    return out.view(torch.uint8)[:total]


ragged_compact.launches = 0
