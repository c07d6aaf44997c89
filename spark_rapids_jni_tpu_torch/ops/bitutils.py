"""FLOAT64 bits <-> arithmetic values, and order keys for sorting and
comparing fixed-width columns (port of the JAX package's
``ops/bitutils``: ``float_view``, ``float_store``, ``backend_has_f64``
and ``total_order_key``; ``to_le_bytes`` and ``ragged_positions`` are not
ported yet).

FLOAT64 columns hold IEEE-754 bits in int64 lanes (``columnar/dtype.py``).
The reference converts those bits through float32 on backends without a
float64 datapath; the port computes real float64 on the CPU and on the
card alike, so it always takes the reference's ``backend_has_f64()``
branch: ``float_view`` reinterprets the bits, ``float_store`` reinterprets
back, and a float32 value widens to float64 exactly by a cast.

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
from .uword import MASK32, SIGN64, u32_to_i64

__all__ = ["total_order_key", "SIGN64", "float_view", "float_store", "backend_has_f64"]

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


def backend_has_f64() -> bool:
    """True: torch computes real float64 on the CPU and on the card."""
    return True


def float_view(data: torch.Tensor, d: DType) -> torch.Tensor:
    """Column storage -> floating values for arithmetic: FLOAT64 bits
    reinterpreted as float64 (exact), FLOAT32 as it is."""
    if d.id == TypeId.FLOAT64:
        return data.view(torch.float64)
    if d.id == TypeId.FLOAT32:
        return data
    raise ValueError(f"float_view on non-floating dtype {d!r}")


def float_store(values: torch.Tensor, d: DType) -> torch.Tensor:
    """Floating values -> column storage: FLOAT64 as int64 IEEE bits (a
    float32 value widens exactly), FLOAT32 as float32."""
    if d.id == TypeId.FLOAT64:
        return values.to(torch.float64).view(torch.int64)
    if d.id == TypeId.FLOAT32:
        return values.to(torch.float32)
    raise ValueError(f"float_store on non-floating dtype {d!r}")
