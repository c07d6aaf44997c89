"""Per-column statistics sketches (port of the JAX package's
``plan/stats/sketches.py``; the columns are read on the host from one
device-to-host copy of each column's first ``max_rows`` rows).

One :class:`ColumnSketch` per fixed-width column: row count, null
fraction, min/max, an HLL-style distinct-count estimate (2**b
registers, splitmix64-mixed hashes), and an equi-depth histogram
(``SRJTORCH_STATS_HISTOGRAM_BINS`` bins over the non-null values). All of
it is computed host-side with numpy in one pass over (at most
``SRJTORCH_STATS_MAX_ROWS``) rows — sketches are compile-time inputs, not
device work.

``selectivity(pred, resolve)`` walks a plan predicate
(:mod:`plan.exprs`) and turns comparisons against literals into
fractions using the sketches ``resolve(column_name)`` hands back:

- ``col == lit``  -> (1 - null_fraction) / ndv  (capped by histogram
  membership: a literal outside [min, max] estimates ~0)
- range ops      -> histogram bin mass, partial bins counted in full
  on the selected side so the estimate upper-bounds the truth within
  one bin of resolution
- ``isnull``     -> null_fraction (or its complement)
- AND/OR/NOT    -> product / inclusion-exclusion / complement under
  the usual independence assumption
- anything else  -> ``DEFAULT_SELECTIVITY`` per unknown conjunct

Estimates are advisory: they feed ``est_rows`` and the CBO search,
never semantics. The verifier only requires they stay internally
consistent (PLAN007 monotonicity), which selectivities in [0, 1]
guarantee.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np

from ...columnar.dtype import TypeId
from .. import exprs as ex

__all__ = [
    "ColumnSketch", "TableStats", "sketch_column", "collect_table",
    "selectivity", "hll_estimate", "DEFAULT_SELECTIVITY",
]

DEFAULT_SELECTIVITY = 0.5

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over a uint64 array."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _clz_tail(w: np.ndarray, width: int) -> np.ndarray:
    """Leading-zero count of each uint64 in ``w`` restricted to its
    top ``width`` bits, exactly (6-step binary search, no float
    round-trip — float log2 misranks values near powers of two)."""
    w = w.astype(np.uint64, copy=True)
    n = np.zeros(w.shape, dtype=np.int64)
    shift = 32
    top = np.uint64(64)
    while shift >= 1:
        s = np.uint64(shift)
        mask = (w >> (top - s)) == np.uint64(0)
        n = np.where(mask, n + shift, n)
        w = np.where(mask, w << s, w)
        shift //= 2
    return np.minimum(n, width)


def hll_estimate(registers: np.ndarray) -> float:
    """Standard HyperLogLog estimate with the small-range linear-
    counting correction (the only regime our table sizes hit hard)."""
    m = registers.shape[0]
    if m >= 128:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    elif m >= 64:
        alpha = 0.709
    elif m >= 32:
        alpha = 0.697
    else:
        alpha = 0.673
    est = alpha * m * m / float(np.sum(np.power(2.0, -registers.astype(np.float64))))
    zeros = int(np.sum(registers == 0))
    if est <= 2.5 * m and zeros > 0:
        est = m * math.log(m / zeros)
    return max(est, 1.0)


@dataclasses.dataclass(frozen=True)
class ColumnSketch:
    """One column's compile-time statistics (values in the column's
    LOGICAL domain — decimals stay unscaled, FLOAT64 bit-lanes are
    decoded before sketching)."""

    rows: int
    nulls: int
    min_val: Optional[float]
    max_val: Optional[float]
    ndv: float
    #: equi-depth bin edges over the non-null values, len == bins + 1
    #: (empty when there are no non-null values)
    edges: Tuple[float, ...]
    #: EXACT all-values-distinct witness (np.unique over the full scan)
    #: — False whenever the column was sampled, because a sample cannot
    #: prove global uniqueness. The build-side/strategy rules key off
    #: this: dense payload maps reject duplicate build keys at runtime,
    #: so an approximate "probably unique" is not good enough
    unique: bool = False

    @property
    def null_fraction(self) -> float:
        return self.nulls / self.rows if self.rows else 0.0

    @property
    def non_null(self) -> int:
        return self.rows - self.nulls

    # -- selectivity primitives (fractions of ALL rows) -------------------

    def sel_is_null(self, want_null: bool) -> float:
        return self.null_fraction if want_null else 1.0 - self.null_fraction

    def sel_eq(self, v: float) -> float:
        if self.non_null == 0:
            return 0.0
        if self.min_val is not None and (v < self.min_val or v > self.max_val):
            return 0.0
        return (1.0 - self.null_fraction) / max(self.ndv, 1.0)

    def _frac_below(self, v: float, inclusive: bool) -> float:
        """Fraction of NON-NULL values < v (<= v when inclusive),
        estimated from the equi-depth histogram; partial bins count in
        full, so the answer upper-bounds the truth within one bin."""
        if not self.edges or self.non_null == 0:
            return DEFAULT_SELECTIVITY
        edges = np.asarray(self.edges, dtype=np.float64)
        nbins = len(edges) - 1
        if v < edges[0]:
            return 0.0
        if v > edges[-1] or (inclusive and v == edges[-1]):
            return 1.0
        side = "right" if inclusive else "left"
        # bins fully below v plus the partial bin v falls in, counted
        # in full (equi-depth: each bin holds 1/nbins of the mass)
        pos = int(np.searchsorted(edges, v, side=side))
        return min(1.0, pos / nbins)

    def sel_cmp(self, op: str, v: float) -> float:
        """Fraction of ALL rows satisfying ``col <op> v`` (NULLs never
        satisfy a comparison)."""
        nn = 1.0 - self.null_fraction
        if self.non_null == 0:
            return 0.0
        if op == "eq":
            return self.sel_eq(v)
        if op == "ne":
            return max(0.0, nn - self.sel_eq(v))
        if op == "lt":
            f = self._frac_below(v, inclusive=False)
        elif op == "le":
            f = self._frac_below(v, inclusive=True)
        elif op == "ge":
            f = 1.0 - self._frac_below(v, inclusive=False)
        elif op == "gt":
            f = 1.0 - self._frac_below(v, inclusive=True)
        else:
            return DEFAULT_SELECTIVITY
        return min(max(f, 0.0), 1.0) * nn


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Row count + per-column sketches for one bound table."""

    rows: int
    columns: "dict[str, ColumnSketch]"

    def sketch(self, name: str) -> Optional[ColumnSketch]:
        return self.columns.get(name)

    @property
    def memory_bytes(self) -> int:
        """Resident size of the sketch set (the PACKAGING budget row)."""
        per = sum(8 * (len(s.edges) + 6) for s in self.columns.values())
        return per + 64 * max(1, len(self.columns))


_SKETCHABLE = frozenset({
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
    TypeId.FLOAT32, TypeId.FLOAT64,
    TypeId.DECIMAL32, TypeId.DECIMAL64,
})


def _host_values(col, max_rows: int):
    """``(values, validity, rows)``: the column's first ``max_rows``
    values as a host float64 array in the logical domain, their validity
    (None when the column has none) and the column's full row count; or
    None when the column isn't sketchable (strings, DECIMAL128, nested).
    One device-to-host copy of the head per buffer, whatever the number
    of sketches taken from it."""
    if col.dtype.id not in _SKETCHABLE or col.data is None:
        return None
    if col.data.ndim != 1:
        return None
    rows = int(col.data.shape[0])
    head = col.data[:max_rows].cpu().numpy().view(col.dtype.np_dtype)
    if col.dtype.id == TypeId.FLOAT64:
        head = head.view(np.float64)
    valid = (None if col.validity is None
             else col.validity[:max_rows].cpu().numpy())
    return head.astype(np.float64, copy=False), valid, rows


def sketch_column(col, *, bins: int = 16, hll_bits: int = 9,
                  max_rows: int = 1 << 18) -> Optional[ColumnSketch]:
    """Sketch one column, or None for unsketchable types. ``max_rows``
    caps the scan (head sample) so stats collection stays O(bounded)
    whatever the table size."""
    got = _host_values(col, max_rows)
    if got is None:
        return None
    vals, valid, rows = got
    scale = rows / max_rows if rows > max_rows else 1.0
    if valid is not None:
        nn_vals = vals[valid]
    else:
        nn_vals = vals
    sampled = vals.shape[0]
    nulls = int(round((sampled - nn_vals.shape[0]) * scale))
    if nn_vals.shape[0] == 0:
        return ColumnSketch(rows=rows, nulls=rows, min_val=None,
                            max_val=None, ndv=0.0, edges=())
    # distinct count: HLL over mixed value bits
    m = 1 << hll_bits
    h = _mix64(nn_vals.view(np.uint64))
    idx = (h >> np.uint64(64 - hll_bits)).astype(np.int64)
    tail_width = 64 - hll_bits
    rho = _clz_tail(h << np.uint64(hll_bits), tail_width) + 1
    registers = np.zeros(m, dtype=np.int64)
    np.maximum.at(registers, idx, rho)
    ndv = min(hll_estimate(registers), float(nn_vals.shape[0])) * scale
    # equi-depth histogram
    srt = np.sort(nn_vals)
    qs = np.linspace(0.0, 1.0, bins + 1)
    edges = tuple(float(x) for x in np.quantile(srt, qs))
    unique = bool(scale == 1.0 and nulls == 0
                  and (srt.shape[0] < 2 or bool(np.all(srt[1:] != srt[:-1]))))
    return ColumnSketch(
        rows=rows,
        nulls=nulls,
        min_val=float(srt[0]),
        max_val=float(srt[-1]),
        ndv=max(1.0, ndv),
        edges=edges,
        unique=unique,
    )


def collect_table(table, *, bins: int = 16, hll_bits: int = 9,
                  max_rows: int = 1 << 18) -> TableStats:
    """Sketch every sketchable column of ``table``."""
    cols = {}
    for name, col in zip(table.names, table.columns):
        s = sketch_column(col, bins=bins, hll_bits=hll_bits,
                          max_rows=max_rows)
        if s is not None:
            cols[name] = s
    return TableStats(rows=table.num_rows, columns=cols)


# ---------------------------------------------------------------------------
# predicate selectivity
# ---------------------------------------------------------------------------

_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")

Resolver = Callable[[str], Optional[ColumnSketch]]


def _col_lit(e) -> Optional[Tuple[str, object, str]]:
    """Match ``col <op> lit`` either way round -> (col, value,
    normalized op), else None."""
    if not isinstance(e, ex._PBin) or e.op not in _CMP_OPS:
        return None
    flipped = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
               "eq": "eq", "ne": "ne"}
    a, b = e.a, e.b
    ca, cb = ex.is_col(a), ex.is_col(b)
    if ca is not None and isinstance(b, ex._PLit):
        return ca, b.value, e.op
    if cb is not None and isinstance(a, ex._PLit):
        return cb, a.value, flipped[e.op]
    return None


def _lit_float(v) -> Optional[float]:
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    return None


def selectivity(pred, resolve: Resolver) -> float:
    """Estimated fraction of rows a predicate keeps, in [0, 1]."""
    s = _selectivity(pred, resolve)
    return min(max(s, 0.0), 1.0)


def _selectivity(e, resolve: Resolver) -> float:
    if isinstance(e, ex._PBin):
        if e.op == "and":
            return _selectivity(e.a, resolve) * _selectivity(e.b, resolve)
        if e.op == "or":
            sa = _selectivity(e.a, resolve)
            sb = _selectivity(e.b, resolve)
            return sa + sb - sa * sb
        m = _col_lit(e)
        if m is not None:
            name, raw, op = m
            sk = resolve(name)
            v = _lit_float(raw)
            if sk is not None and v is not None:
                return sk.sel_cmp(op, v)
            return DEFAULT_SELECTIVITY
        if e.op in _CMP_OPS:
            # col-vs-col comparison: eq via the larger ndv, else default
            ca, cb = ex.is_col(e.a), ex.is_col(e.b)
            if e.op == "eq" and ca is not None and cb is not None:
                sa, sb = resolve(ca), resolve(cb)
                if sa is not None and sb is not None:
                    return 1.0 / max(sa.ndv, sb.ndv, 1.0)
            return DEFAULT_SELECTIVITY
        return DEFAULT_SELECTIVITY
    if isinstance(e, ex._PNot):
        return 1.0 - _selectivity(e.a, resolve)
    if isinstance(e, ex._PIsNull):
        c = ex.is_col(e.a)
        if c is not None:
            sk = resolve(c)
            if sk is not None:
                return sk.sel_is_null(e.want_null)
        return 0.1 if e.want_null else 0.9
    if isinstance(e, ex._PLit):
        if e.value is True:
            return 1.0
        if e.value is False or e.value is None:
            return 0.0
        return DEFAULT_SELECTIVITY
    return DEFAULT_SELECTIVITY
