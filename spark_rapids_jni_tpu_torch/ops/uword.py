"""Unsigned-word helpers over signed torch storage.

The JAX package computes on uint32/uint64 throughout. Torch on the CPU
has no ``<<``, ``>>``, ``+``, ``%`` or ``index_add_`` for its unsigned
wide types, so the port carries a 32-bit word in an int32 lane and a
64-bit word in an int64 lane, holding the same bits. These helpers give
the unsigned operations on those lanes; each is exact (no reliance on
how a narrowing cast treats out-of-range values) and runs unchanged on
CPU and CUDA tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "MASK32",
    "SIGN64",
    "u64_bits",
    "ucmp64",
    "shr_u64",
    "to_signed_bits",
    "u32_to_i64",
    "shr_u32",
    "shl_u32",
    "split_u64",
    "join_u64",
    "i64_as_i32_pairs",
    "i32_pairs_as_i64",
    "mul_u32",
    "rotl_u32",
]

MASK32 = 0xFFFFFFFF
SIGN64 = -(1 << 63)
_INT64_MAX = (1 << 63) - 1

_SIGNED = {8: torch.int8, 16: torch.int16, 32: torch.int32}


def to_signed_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Low ``bits`` bits of an integer tensor as the signed torch type of
    that width (int8/int16/int32): the two's-complement value is formed
    exactly before the cast, so the cast never sees an out-of-range value."""
    half = 1 << (bits - 1)
    wide = x.to(torch.int64)
    return (((wide + half) & ((1 << bits) - 1)) - half).to(_SIGNED[bits])


def u32_to_i64(x32: torch.Tensor) -> torch.Tensor:
    """int32 lane holding u32 bits -> its unsigned value in int64."""
    return x32.to(torch.int64) & MASK32


def shr_u32(x32: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of u32 words held in int32 (torch's ``>>`` is
    arithmetic on signed types: mask the sign copies off after it).
    ``k`` is an int or an integer tensor broadcastable to ``x32``, in [0, 32)."""
    if isinstance(k, int):
        if k == 0:
            return x32
        return (x32 >> k) & ((1 << (32 - k)) - 1)
    return to_signed_bits(u32_to_i64(x32) >> k.to(torch.int64), 32)


def shl_u32(x32: torch.Tensor, k) -> torch.Tensor:
    """Left shift of u32 words held in int32, wrapping at 32 bits.
    ``k`` is an int or an integer tensor, in [0, 32)."""
    if not isinstance(k, int):
        k = k.to(torch.int64)
    return to_signed_bits((u32_to_i64(x32) << k) & MASK32, 32)


def u64_bits(v: int) -> int:
    """A Python int in [0, 2^64) as the int64 value holding its bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def ucmp64(op, a, b) -> torch.Tensor:
    """The unsigned compare ``op`` (``operator.lt``, ``ge``, ...) of u64
    words held in int64 lanes: flipping the sign bit of both sides maps
    the unsigned order onto the signed one."""
    return op(a ^ SIGN64, b ^ SIGN64)


def shr_u64(x: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of u64 words held in int64 lanes, ``k`` in
    [0, 63] (an int or an int64 tensor): the arithmetic shift with the
    sign copies masked off (2^(64-k) - 1 is INT64_MAX >> (k - 1))."""
    if isinstance(k, int):
        return x if k == 0 else (x >> k) & (_INT64_MAX >> (k - 1))
    mask = torch.where(k == 0, -1, _INT64_MAX >> (k - 1).clamp(min=0))
    return (x >> k) & mask


def split_u64(x64: torch.Tensor):
    """64-bit words held in int64 -> (lo, hi) u32 halves held in int32."""
    pairs = i64_as_i32_pairs(x64)
    return pairs[..., 0], pairs[..., 1]


def join_u64(lo32: torch.Tensor, hi32: torch.Tensor) -> torch.Tensor:
    """(lo, hi) u32 halves held in int32 -> the 64-bit word held in int64."""
    return torch.stack([lo32.to(torch.int32), hi32.to(torch.int32)], dim=-1).view(torch.int64)[..., 0]


def i64_as_i32_pairs(x64: torch.Tensor) -> torch.Tensor:
    """Bit reinterpretation [..., N] int64 -> [..., N, 2] int32 (little
    endian: [..., 0] is the low word). A view where ``x64`` is contiguous
    and not empty (an empty tensor may carry stride 0, which ``view``
    refuses)."""
    x64 = x64.contiguous()
    if x64.numel() == 0:
        return x64.new_empty((*x64.shape, 2), dtype=torch.int32)
    return x64.view(torch.int32).view(*x64.shape, 2)


def i32_pairs_as_i64(x32: torch.Tensor) -> torch.Tensor:
    """Bit reinterpretation [..., N, 2] int32 -> [..., N] int64."""
    x32 = x32.contiguous()
    return x32.view(torch.int64).view(x32.shape[:-1])


# The murmur3 arithmetic below works on u32 values held in int64 lanes,
# each in [0, 2^32): there a signed compare, ``>>`` and ``^`` are already
# the unsigned ones, and only the multiply and the rotate need care.


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for u32 values in int64 lanes (``b`` a tensor of the
    same kind or an int in [0, 2^32)). A plain int64 product of two 32-bit
    values reaches 2^64 and overflows the signed lane (it would wrap, and
    its low 32 bits would still be right, but signed overflow is not a
    defined result); this splits ``b`` into 16-bit halves instead, so no
    intermediate exceeds 2^49."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK32


def rotl_u32(x: torch.Tensor, r: int) -> torch.Tensor:
    """32-bit rotate left by ``r`` in [1, 32) of u32 values in int64
    lanes (``x << r`` stays below 2^63)."""
    return ((x << r) & MASK32) | (x >> (32 - r))
