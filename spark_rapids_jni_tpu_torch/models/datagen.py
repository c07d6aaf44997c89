"""Deterministic random table generation, the benchmark datagen tier (port
of the JAX package's ``models/datagen.py``).

Seeded per-type distribution profiles (UNIFORM / NORMAL / GEOMETRIC),
default value ranges per type, string length distributions, null
probability, and ``cycle_dtypes`` to build wide tables from a short type
list, after the reference's nvbench input generator
(``generate_input.hpp``). Values are drawn on the host with numpy, draw
for draw as the JAX package draws them (validity before values), so the
same seed gives the same table bits in both packages; the columns then
land on ``device`` (None means the card).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar.column import _host_to_tensor, resolve_device
from ..columnar.dtype import DType, TypeId

__all__ = [
    "Distribution",
    "Profile",
    "create_random_column",
    "create_random_table",
    "cycle_dtypes",
]


class Distribution(enum.Enum):
    UNIFORM = "uniform"
    NORMAL = "normal"
    GEOMETRIC = "geometric"


@dataclasses.dataclass
class Profile:
    """Per-column generation profile (generate_input.hpp distribution_params)."""

    distribution: Distribution = Distribution.UNIFORM
    lower: Optional[float] = None
    upper: Optional[float] = None
    null_probability: float = 0.0
    # string-only knobs
    min_length: int = 0
    max_length: int = 32


# Default ranges per type id, narrowed so sums stay exactly representable
# in the test oracles (the reference's table).
_DEFAULT_RANGE = {
    TypeId.INT8: (-100, 100),
    TypeId.INT16: (-10_000, 10_000),
    TypeId.INT32: (-1_000_000, 1_000_000),
    TypeId.INT64: (-1_000_000_000, 1_000_000_000),
    TypeId.UINT8: (0, 200),
    TypeId.UINT16: (0, 20_000),
    TypeId.UINT32: (0, 2_000_000),
    TypeId.UINT64: (0, 2_000_000_000),
    TypeId.FLOAT32: (-1000.0, 1000.0),
    TypeId.FLOAT64: (-1000.0, 1000.0),
    TypeId.BOOL8: (0, 1),
    TypeId.TIMESTAMP_DAYS: (0, 20_000),
    TypeId.DECIMAL32: (-(10**8), 10**8),
    TypeId.DECIMAL64: (-(10**15), 10**15),
    # float64 draw limits precision; stay within exactly-representable ints
    TypeId.DECIMAL128: (-(2**52), 2**52),
}


def _draw(rng: np.random.Generator, n: int, lo: float, hi: float, dist: Distribution) -> np.ndarray:
    if dist is Distribution.UNIFORM:
        return rng.uniform(lo, hi, n)
    if dist is Distribution.NORMAL:
        mid, spread = (lo + hi) / 2.0, max((hi - lo) / 6.0, 1e-9)
        return np.clip(rng.normal(mid, spread, n), lo, hi)
    if dist is Distribution.GEOMETRIC:
        span = max(hi - lo, 1e-9)
        g = rng.geometric(p=min(4.0 / span, 0.5), size=n).astype(np.float64)
        return np.clip(lo + g, lo, hi)
    raise ValueError(dist)


def create_random_column(d: DType, num_rows: int, rng: np.random.Generator,
                         profile: Optional[Profile] = None, device=None) -> Column:
    """One column drawn from ``rng`` (validity first, then values);
    ``device=None`` means the card."""
    dev = resolve_device(device)
    p = profile or Profile()
    tid = d.id

    validity = None
    if p.null_probability > 0:
        validity = torch.from_numpy(rng.random(num_rows) >= p.null_probability).to(dev)

    if tid == TypeId.STRING:
        lens = rng.integers(p.min_length, p.max_length + 1, num_rows).astype(np.int32)
        offsets = np.zeros(num_rows + 1, np.int32)
        np.cumsum(lens, out=offsets[1:])
        chars = rng.integers(97, 123, int(offsets[-1])).astype(np.uint8)  # a-z
        return Column.strings_from_parts(offsets, chars, validity, device=dev)

    lo, hi = (p.lower, p.upper)
    if lo is None or hi is None:
        dlo, dhi = _DEFAULT_RANGE[tid]
        lo = dlo if lo is None else lo
        hi = dhi if hi is None else hi

    raw = _draw(rng, num_rows, lo, hi, p.distribution)
    if tid == TypeId.FLOAT64:
        host = raw.astype(np.float64).view(np.uint64)
    elif tid == TypeId.FLOAT32:
        host = raw.astype(np.float32)
    elif tid == TypeId.DECIMAL128:
        ints = np.rint(raw).astype(np.int64)
        host = np.zeros((num_rows, 4), np.uint32)
        v = ints.astype(np.uint64)
        host[:, 0] = (v & 0xFFFFFFFF).astype(np.uint32)
        host[:, 1] = (v >> 32).astype(np.uint32)
        sign = (ints < 0).astype(np.uint32) * 0xFFFFFFFF
        host[:, 2] = sign
        host[:, 3] = sign
    else:
        host = np.rint(raw).astype(np.int64).astype(d.np_dtype)
    return Column(d, data=_host_to_tensor(host, d.torch_dtype, dev), validity=validity)


def cycle_dtypes(dtypes: Sequence[DType], num_cols: int) -> list:
    """Wide tables cycle a type list, as the reference's benchmarks do
    (row_conversion.cpp:31-40)."""
    return [dtypes[i % len(dtypes)] for i in range(num_cols)]


def create_random_table(
    dtypes: Sequence[DType],
    num_rows: int,
    seed: int = 42,
    profiles: Optional[Dict[int, Profile]] = None,
    names: Optional[Sequence[str]] = None,
    device=None,
) -> Table:
    """Deterministic random table: the same (dtypes, num_rows, seed) gives
    the same bits on every host and run, and the JAX package's bits;
    ``device=None`` means the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cols = [create_random_column(d, num_rows, rng, (profiles or {}).get(i), device=dev)
            for i, d in enumerate(dtypes)]
    return Table(cols, names)
