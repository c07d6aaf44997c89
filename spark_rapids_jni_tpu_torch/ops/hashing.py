"""Spark-compatible Murmur3 hashing (port of the JAX package's
``ops/hashing.py``).

Spark's Murmur3Hash hashes each column value with the running hash as
its seed (default 42): 4-byte and narrower values as one block, 8-byte
values as two, DECIMAL128 as four, strings per 4-byte chunk with the
reference's tail handling. A null leaves the running hash unchanged.

Hashes are u32 values. The port returns them as int32 lanes holding the
same bits (``.view(torch.uint32)`` or numpy ``.view(np.uint32)`` reads
them unsigned) and computes on int64 lanes through ``ops/murmur.py``.
``hash_partition_map`` of one INT32 or INT64 column with the default seed
runs kernel B1 (``hopper_kernels.partition_map``) on a CUDA tensor; every
other shape keeps this formulation, as the reference keeps XLA.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar import Column, Table
from ..columnar.dtype import TypeId
from .hopper_kernels import partition_map
from .murmur import SEED, fmix, mix_h, mix_k, murmur3_words, pmod
from .uword import MASK32, split_u64, to_signed_bits, u32_to_i64

__all__ = ["murmur3_table", "murmur3_raw", "hash_partition_map"]

_UNSIGNED_MASK = {TypeId.UINT16: 0xFFFF, TypeId.UINT32: MASK32}


def _float32_as_int32(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``astype(int32)`` of float32 values: truncation
    toward zero, saturating at the int32 range, NaN to 0 (XLA's convert)."""
    x = x.to(torch.float64)
    x = torch.where(torch.isnan(x), 0.0, x.clamp(-(2.0**31), 2.0**31 - 1))
    return x.to(torch.int64)


def _one_word(data: torch.Tensor, type_id=None) -> torch.Tensor:
    """A 4-byte-or-narrower value as one u32 block (int64 lane): signed
    values sign-extend to 32 bits, unsigned ones zero-extend, float32
    converts its value as the reference does."""
    if data.dtype == torch.float32:
        w = _float32_as_int32(data)
    else:
        w = data.to(torch.int64)
        if type_id in _UNSIGNED_MASK:
            w = w & _UNSIGNED_MASK[type_id]
    return w & MASK32


def _fixed_words(col: Column) -> List[torch.Tensor]:
    d = col.dtype
    if d.id == TypeId.DECIMAL128:
        return [u32_to_i64(col.data[:, k]) for k in range(4)]
    if d.size_bytes == 8:
        return [u32_to_i64(w) for w in split_u64(col.data)]
    if d.size_bytes <= 4:
        return [_one_word(col.data, d.id)]
    raise ValueError(f"cannot hash dtype {d!r}")


def _hash_string(col: Column, h: torch.Tensor) -> torch.Tensor:
    offs = col.offsets.to(torch.int64)
    lens = offs[1:] - offs[:-1]
    pad4 = (max(col.max_char_len, 1) + 3) // 4 * 4
    pos = torch.arange(pad4, dtype=torch.int64, device=offs.device)[None, :]
    nchars = max(int(col.chars.shape[0]), 1)
    chars = col.chars if col.chars.shape[0] else col.chars.new_zeros(1)
    idx = (offs[:-1, None] + pos).clamp(0, nchars - 1)
    chars = torch.where(pos < lens[:, None], chars[idx].to(torch.int64), 0)  # [N, pad4]

    nblocks = lens // 4
    for b in range(pad4 // 4):
        k = (chars[:, 4 * b] | (chars[:, 4 * b + 1] << 8) | (chars[:, 4 * b + 2] << 16)
             | (chars[:, 4 * b + 3] << 24))
        h = torch.where(b < nblocks, mix_h(h, k), h)

    # tail: the last 1-3 bytes, mixed k1-style without the h-mix
    tail_start = nblocks * 4
    tail_len = lens - tail_start
    k1 = torch.zeros_like(lens)
    for t in (2, 1, 0):
        byte = torch.gather(chars, 1, (tail_start + t).clamp(0, pad4 - 1)[:, None])[:, 0]
        k1 = torch.where(tail_len > t, ((k1 << 8) & MASK32) | byte, k1)
    h = torch.where(tail_len > 0, h ^ mix_k(k1), h)
    return fmix(h ^ lens)


def _murmur3_u32(table_or_cols, seed: int) -> torch.Tensor:
    """[N] row hashes as u32 values in int64 lanes."""
    cols: Sequence[Column] = (
        table_or_cols.columns if isinstance(table_or_cols, Table) else list(table_or_cols)
    )
    h = torch.full((len(cols[0]),), seed & MASK32, dtype=torch.int64, device=cols[0].device)
    for col in cols:
        if col.dtype.id == TypeId.STRING:
            nh = _hash_string(col, h)
        else:
            nh = murmur3_words(_fixed_words(col), h)
        # a null leaves the running hash unchanged (Spark semantics)
        if col.validity is not None:
            nh = torch.where(col.validity, nh, h)
        h = nh
    return h


def murmur3_table(table_or_cols, seed: int = SEED) -> torch.Tensor:
    """[N] row hashes (u32 bits in int32); the columns chain with the hash
    so far as the next seed (Spark Murmur3Hash semantics)."""
    return to_signed_bits(_murmur3_u32(table_or_cols, seed), 32)


def murmur3_raw(data: torch.Tensor, seed=SEED) -> torch.Tensor:
    """[N] murmur3 (u32 bits in int32) over a raw integer tensor: the same
    result as ``murmur3_table`` on a column of that width (values of 4
    bytes or fewer hash as one block, extended by their torch type's
    signedness; 8-byte values as two). ``seed`` is an int or [N] running
    hashes (u32 bits in int32), for Spark-style chaining."""
    if isinstance(seed, torch.Tensor):
        seed = u32_to_i64(seed)
    else:
        seed = seed & MASK32
    if data.element_size() == 8:
        words = [u32_to_i64(w) for w in split_u64(data.view(torch.int64))]
    elif data.element_size() <= 4:
        words = [_one_word(data)]
    else:
        raise ValueError(f"cannot hash raw dtype {data.dtype}")
    return to_signed_bits(murmur3_words(words, seed), 32)


def hash_partition_map(table_or_cols, num_partitions: int, seed: int = SEED) -> torch.Tensor:
    """[N] int32 partition of each row: pmod(murmur3, num_partitions). One
    INT32 or INT64 column with the default seed runs B1 (on a CUDA
    tensor; its plain version on a CPU tensor)."""
    cols = table_or_cols.columns if isinstance(table_or_cols, Table) else list(table_or_cols)
    if (len(cols) == 1 and seed == SEED
            and cols[0].dtype.id in (TypeId.INT32, TypeId.INT64)):
        return partition_map(cols[0].data, num_partitions, cols[0].validity)
    return pmod(_murmur3_u32(cols, seed), num_partitions)
