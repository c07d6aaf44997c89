"""Spark/cudf-shaped logical types over PyTorch storage.

A copy of the JAX package's type surface (``TypeId``, ``DType`` and the
singletons), kept here so the port never imports that package. What
differs is the physical mapping onto torch dtypes:

- signed integers, float32 and uint8 map 1:1,
- UINT16/UINT32/UINT64 are stored in the signed torch type of the same
  width, holding the same bits (torch has no arithmetic for wide
  unsigned types; ``ops/uword.py`` gives the logical shifts and masks),
- FLOAT64 is stored as IEEE-754 bits in an int64 lane, so JCUDF row
  blobs and parity checks compare bits,
- BOOL8 is one byte (uint8, non-zero == true),
- DECIMAL128 is ``[N, 4]`` little-endian 32-bit limbs in int32 lanes.

``np_dtype`` is the numpy storage dtype the JAX package uses for the
same column (``uint64`` bits for FLOAT64), which is what
``Column.to_numpy`` returns, so the two packages compare array for array.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """Logical type ids, aligned with the surface used by the reference JNI."""

    EMPTY = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOL8 = 11
    TIMESTAMP_DAYS = 12
    TIMESTAMP_SECONDS = 13
    TIMESTAMP_MILLISECONDS = 14
    TIMESTAMP_MICROSECONDS = 15
    TIMESTAMP_NANOSECONDS = 16
    DURATION_DAYS = 17
    DURATION_SECONDS = 18
    DURATION_MILLISECONDS = 19
    DURATION_MICROSECONDS = 20
    DURATION_NANOSECONDS = 21
    STRING = 23
    LIST = 24
    DECIMAL32 = 26
    DECIMAL64 = 27
    DECIMAL128 = 28
    STRUCT = 29


# Physical element width in bytes inside a JCUDF row / Arrow buffer.
_SIZES = {
    TypeId.INT8: 1,
    TypeId.INT16: 2,
    TypeId.INT32: 4,
    TypeId.INT64: 8,
    TypeId.UINT8: 1,
    TypeId.UINT16: 2,
    TypeId.UINT32: 4,
    TypeId.UINT64: 8,
    TypeId.FLOAT32: 4,
    TypeId.FLOAT64: 8,
    TypeId.BOOL8: 1,
    TypeId.TIMESTAMP_DAYS: 4,
    TypeId.TIMESTAMP_SECONDS: 8,
    TypeId.TIMESTAMP_MILLISECONDS: 8,
    TypeId.TIMESTAMP_MICROSECONDS: 8,
    TypeId.TIMESTAMP_NANOSECONDS: 8,
    TypeId.DURATION_DAYS: 4,
    TypeId.DURATION_SECONDS: 8,
    TypeId.DURATION_MILLISECONDS: 8,
    TypeId.DURATION_MICROSECONDS: 8,
    TypeId.DURATION_NANOSECONDS: 8,
    TypeId.DECIMAL32: 4,
    TypeId.DECIMAL64: 8,
    TypeId.DECIMAL128: 16,
}

# numpy storage dtype of each fixed-width logical type (the JAX
# package's storage, so arrays compare 1:1 across the two packages).
_NP = {
    TypeId.INT8: np.int8,
    TypeId.INT16: np.int16,
    TypeId.INT32: np.int32,
    TypeId.INT64: np.int64,
    TypeId.UINT8: np.uint8,
    TypeId.UINT16: np.uint16,
    TypeId.UINT32: np.uint32,
    TypeId.UINT64: np.uint64,
    TypeId.FLOAT32: np.float32,
    TypeId.FLOAT64: np.uint64,  # IEEE-754 bits
    TypeId.BOOL8: np.uint8,
    TypeId.TIMESTAMP_DAYS: np.int32,
    TypeId.TIMESTAMP_SECONDS: np.int64,
    TypeId.TIMESTAMP_MILLISECONDS: np.int64,
    TypeId.TIMESTAMP_MICROSECONDS: np.int64,
    TypeId.TIMESTAMP_NANOSECONDS: np.int64,
    TypeId.DURATION_DAYS: np.int32,
    TypeId.DURATION_SECONDS: np.int64,
    TypeId.DURATION_MILLISECONDS: np.int64,
    TypeId.DURATION_MICROSECONDS: np.int64,
    TypeId.DURATION_NANOSECONDS: np.int64,
    TypeId.DECIMAL32: np.int32,
    TypeId.DECIMAL64: np.int64,
    TypeId.DECIMAL128: np.uint32,  # [N, 4] limbs
}

# torch storage for each numpy storage dtype: unsigned widths above 8
# bits live in the signed type of the same width (same bits).
_TORCH_OF_NP = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.int16,
    np.dtype(np.uint32): torch.int32,
    np.dtype(np.uint64): torch.int64,
    np.dtype(np.float32): torch.float32,
}

# numpy view type matching each torch storage dtype bit for bit
_NP_OF_TORCH = {
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.uint8: np.uint8,
    torch.float32: np.float32,
}

_INTEGRAL = frozenset(
    {
        TypeId.INT8,
        TypeId.INT16,
        TypeId.INT32,
        TypeId.INT64,
        TypeId.UINT8,
        TypeId.UINT16,
        TypeId.UINT32,
        TypeId.UINT64,
    }
)

_DECIMAL = frozenset({TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128})


def torch_of_np(np_dt) -> torch.dtype:
    """torch storage dtype for a numpy storage dtype (same width and bits)."""
    return _TORCH_OF_NP[np.dtype(np_dt)]


def np_view_of_torch(t_dt: torch.dtype):
    """numpy dtype with the same width as a torch storage dtype."""
    return _NP_OF_TORCH[t_dt]


@dataclasses.dataclass(frozen=True)
class DType:
    """A logical type: id + cudf-convention scale (decimals only).

    cudf scale is the negation of SQL scale: value = unscaled * 10**scale,
    so a SQL DECIMAL(p, 2) has cudf scale -2.
    """

    id: TypeId
    scale: int = 0

    def __post_init__(self):
        if self.scale != 0 and self.id not in _DECIMAL:
            raise ValueError(f"scale only valid for decimal types, got {self.id!r}")

    @property
    def size_bytes(self) -> int:
        if self.id not in _SIZES:
            raise ValueError(f"{self.id!r} has no fixed width")
        return _SIZES[self.id]

    @property
    def is_fixed_width(self) -> bool:
        return self.id in _SIZES

    @property
    def is_compound(self) -> bool:
        return self.id in (TypeId.STRING, TypeId.LIST, TypeId.STRUCT)

    @property
    def is_integral(self) -> bool:
        return self.id in _INTEGRAL

    @property
    def is_decimal(self) -> bool:
        return self.id in _DECIMAL

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_signed(self) -> bool:
        return self.id in _INTEGRAL and not TypeId(self.id).name.startswith("U")

    @property
    def np_dtype(self) -> np.dtype:
        if self.id not in _NP:
            raise ValueError(f"{self.id!r} has no single storage dtype")
        return np.dtype(_NP[self.id])

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_of_np(self.np_dtype)

    @property
    def precision_cap(self) -> int:
        """Max decimal digits representable (cudf convention)."""
        return {TypeId.DECIMAL32: 9, TypeId.DECIMAL64: 18, TypeId.DECIMAL128: 38}[self.id]

    def __repr__(self):
        if self.id in _DECIMAL:
            return f"DType({self.id.name}, scale={self.scale})"
        return f"DType({self.id.name})"


# Convenience singletons, mirroring ai.rapids.cudf.DType statics.
INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
UINT8 = DType(TypeId.UINT8)
UINT16 = DType(TypeId.UINT16)
UINT32 = DType(TypeId.UINT32)
UINT64 = DType(TypeId.UINT64)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
BOOL8 = DType(TypeId.BOOL8)
STRING = DType(TypeId.STRING)
LIST = DType(TypeId.LIST)
STRUCT = DType(TypeId.STRUCT)
TIMESTAMP_DAYS = DType(TypeId.TIMESTAMP_DAYS)
TIMESTAMP_SECONDS = DType(TypeId.TIMESTAMP_SECONDS)
TIMESTAMP_MILLISECONDS = DType(TypeId.TIMESTAMP_MILLISECONDS)
TIMESTAMP_MICROSECONDS = DType(TypeId.TIMESTAMP_MICROSECONDS)
TIMESTAMP_NANOSECONDS = DType(TypeId.TIMESTAMP_NANOSECONDS)
DURATION_DAYS = DType(TypeId.DURATION_DAYS)
DURATION_SECONDS = DType(TypeId.DURATION_SECONDS)
DURATION_MILLISECONDS = DType(TypeId.DURATION_MILLISECONDS)
DURATION_MICROSECONDS = DType(TypeId.DURATION_MICROSECONDS)
DURATION_NANOSECONDS = DType(TypeId.DURATION_NANOSECONDS)


def decimal32(scale: int) -> DType:
    return DType(TypeId.DECIMAL32, scale)


def decimal64(scale: int) -> DType:
    return DType(TypeId.DECIMAL64, scale)


def decimal128(scale: int) -> DType:
    return DType(TypeId.DECIMAL128, scale)
