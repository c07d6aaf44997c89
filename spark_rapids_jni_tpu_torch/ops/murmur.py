"""Murmur3_32 mixing, the one copy the port keeps.

The JAX package has two copies of these functions (``ops/hashing.py`` and
``ops/pallas_kernels.py``); here the Spark row hash (``ops/hashing.py``),
the partitioner's plain version (``hopper_kernels.partition_map_plain``)
and the paged join table's bucket function (``ops/paged_join.py``) all use
this module. Values are u32 held in int64 lanes, each in [0, 2^32)
(``uword.mul_u32`` / ``rotl_u32``); ``csrc/murmur.cuh`` is the same
arithmetic for the kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .uword import MASK32, mul_u32, rotl_u32

__all__ = ["SEED", "mix_k", "mix_h", "fmix", "murmur3_words", "pmod"]

SEED = 42  # Spark's Murmur3Hash default seed

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def mix_k(k: torch.Tensor) -> torch.Tensor:
    k = mul_u32(k, _C1)
    k = rotl_u32(k, 15)
    return mul_u32(k, _C2)


def mix_h(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    h = h ^ mix_k(k)
    h = rotl_u32(h, 13)
    return (mul_u32(h, 5) + 0xE6546B64) & MASK32


def fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur3_words(words: Sequence[torch.Tensor], seed) -> torch.Tensor:
    """Murmur3_32 of each row's 4-byte blocks ``words`` (u32 in int64
    lanes) from ``seed`` (an int or [N] u32 values in int64): the block
    mixes, the length (4 bytes a block) and the finalizer."""
    h = seed
    for w in words:
        h = mix_h(h, w)
    h = h ^ (4 * len(words))
    return fmix(h)


def pmod(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Spark's partition of a row: the u32 hash (int64 lanes) read as
    int32, reduced to [0, num_partitions) as int32."""
    signed = h - ((h >> 31) << 32)
    return torch.remainder(signed, num_partitions).to(torch.int32)
