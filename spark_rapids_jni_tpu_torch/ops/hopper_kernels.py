"""Ports of the JAX package's ``ops/pallas_kernels.py`` kernels.

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
from .ragged_bytes import ragged_compact as ragged_compact_plain

__all__ = [
    "MAX_KEYS",
    "groupby_sum_outer",
    "groupby_sum_outer_plain",
    "ragged_compact",
    "ragged_compact_plain",
]

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
