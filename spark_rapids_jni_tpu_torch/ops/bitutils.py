"""Order keys for sorting and comparing fixed-width columns (port of the
JAX package's ``ops/bitutils.total_order_key``; the rest of that module
is not ported yet).

The reference maps each column to an unsigned integer whose unsigned
order is the value order. Torch has no unsigned 32/64-bit compare or
sort on the CPU, so the port maps each column to an int64 lane whose
SIGNED order is the reference key's unsigned order: a key of 32 bits or
fewer is zero-extended into the lane, a 64-bit key has its sign bit
flipped. Equal reference keys give equal lanes, so a stable sort over
the lanes orders rows exactly as a stable sort over the reference keys.
"""

from __future__ import annotations

import torch

from ..columnar.dtype import DType, TypeId
from .uword import MASK32, u32_to_i64

__all__ = ["total_order_key", "SIGN64"]

SIGN64 = -(1 << 63)
_INT64_MAX = (1 << 63) - 1

# types the reference orders as two's-complement integers of their width
_SIGNED_ORDER = frozenset({
    TypeId.TIMESTAMP_DAYS, TypeId.TIMESTAMP_SECONDS, TypeId.TIMESTAMP_MILLISECONDS,
    TypeId.TIMESTAMP_MICROSECONDS, TypeId.TIMESTAMP_NANOSECONDS, TypeId.DURATION_DAYS,
    TypeId.DURATION_SECONDS, TypeId.DURATION_MILLISECONDS, TypeId.DURATION_MICROSECONDS,
    TypeId.DURATION_NANOSECONDS, TypeId.DECIMAL32, TypeId.DECIMAL64,
})


def total_order_key(data: torch.Tensor, d: DType) -> torch.Tensor:
    """Monotone int64 sort key of a fixed-width column's storage (exact).

    FLOAT64 (IEEE bits in int64) and FLOAT32 use the IEEE total-order
    transform on their bits, so -0.0 sorts before +0.0 and NaNs by their
    bits at the ends; signed integers, timestamps, durations and
    DECIMAL32/64 order as two's complement; unsigned integers and BOOL8
    as unsigned."""
    if d.id == TypeId.FLOAT64:
        bits = data.view(torch.int64)
        return torch.where(bits < 0, bits ^ _INT64_MAX, bits)
    if d.id == TypeId.FLOAT32:
        bits = data.view(torch.int32)
        u = u32_to_i64(bits)
        return torch.where(bits < 0, u ^ MASK32, u | (1 << 31))
    width = 8 * d.size_bytes
    if d.is_signed or d.id in _SIGNED_ORDER:
        if width == 64:
            return data.to(torch.int64)
        return data.to(torch.int64) + (1 << (width - 1))
    if width == 64:
        return data.view(torch.int64) ^ SIGN64
    return data.to(torch.int64) & ((1 << width) - 1)
