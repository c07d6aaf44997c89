"""Spark ETL -> XGBoost DMatrix bridge (port of the JAX package's
``models/xgboost_bridge.py``; BASELINE.json configs[4]).

The reference stack feeds XGBoost4J-Spark from GPU ColumnarBatches
without a host round trip. This bridge builds the same thing on the
device:

- **dense**: features land as one [N, F] float32 tensor (tree_method=hist
  consumes a quantized matrix, and Criteo-style ETL output is dense after
  imputation);
- **quantile sketch**: per-feature cut points from one sort per feature
  (``quantile_cuts``);
- **binning**: per-feature ``searchsorted`` to int32 bin ids
  (``quantize``), the quantized matrix the hist algorithm trains on.

Nulls become NaN (XGBoost's missing marker) before the sketch and the
binning; a NaN gets the reserved missing bin, ``cuts.shape[1] + 1``.

Bit identity with the reference:

- ``quantile_cuts`` keeps the reference's float32 order of operations:
  ``qs`` is the float64 ``i / max_bins`` cast to float32, then
  ``pos = qs * max(valid - 1, 0)``, ``lo = floor(pos)``,
  ``frac = pos - lo``, ``d = b - a`` and ``a + d * frac``. The
  reference's compiled program contracts that last multiply-add into
  one fused multiply-add (one rounding), so the port computes it fused
  too, exactly, in float64 (``_fma_f32``), on the CPU and on the card
  alike. The sort orders -0.0 and +0.0 as equal and keeps their input
  order, as the reference's stable sort does (its comparator
  canonicalizes zeros and NaNs); NaNs sort last and only the valid
  prefix is read. An all-NaN feature gets ``+inf`` cuts.
- ``quantize``: the reference counts the cuts strictly below a value
  (``v > c``) over a broadcast [N, F, B-1] (40 GB at 4M x 39 x 255). A
  count of the elements below a value does not depend on their order, so
  the port sorts each feature's cuts (a NaN cut counts for no value, as
  ``+inf`` does) and counts with ``torch.searchsorted(..., right=False)``:
  a value equal to a cut lands below it, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar.dtype import TypeId
from ..ops import bitutils
from ..utils.dispatch import op_boundary

__all__ = ["DeviceDMatrix", "to_dmatrix", "quantile_cuts", "quantize"]


@dataclasses.dataclass
class DeviceDMatrix:
    """Device-resident training matrix.

    features: [N, F] float32 (NaN == missing)
    labels:   [N] float32 or None
    weights:  [N] float32 or None
    cuts:     [F, max_bins-1] float32 cut points or None
    binned:   [N, F] int32 bin ids (missing -> cuts.shape[1] + 1) or None
    """

    features: torch.Tensor
    feature_names: List[str]
    labels: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None
    cuts: Optional[torch.Tensor] = None
    binned: Optional[torch.Tensor] = None

    @property
    def num_rows(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])


def _unsigned_as_f32(data: torch.Tensor, width: int) -> torch.Tensor:
    """An unsigned column held in signed lanes, converted with one
    rounding as the reference's unsigned ``astype(float32)``."""
    if width < 64:
        return (data.to(torch.int64) & ((1 << width) - 1)).to(torch.float32)
    # values >= 2^63: halve with the low bit kept sticky, convert, double
    # (exact: the doubling only moves the exponent)
    high = data < 0
    half = (data >> 1) & 0x7FFFFFFFFFFFFFFF | (data & 1)
    return torch.where(high, half.to(torch.float32) * 2.0, data.to(torch.float32))


_UNSIGNED_WIDTH = {TypeId.UINT16: 16, TypeId.UINT32: 32, TypeId.UINT64: 64}


def _column_as_f32(col: Column) -> torch.Tensor:
    d = col.dtype
    if d.id == TypeId.STRING or d.id == TypeId.LIST:
        raise ValueError("encode string/list features before building a DMatrix")
    if d.id == TypeId.DECIMAL128:
        raise ValueError("cast DECIMAL128 features to float before building a DMatrix")
    if d.is_floating:
        vals = bitutils.float_view(col.data, d).to(torch.float32)
    elif d.id in _UNSIGNED_WIDTH:
        vals = _unsigned_as_f32(col.data, _UNSIGNED_WIDTH[d.id])
    else:
        vals = col.data.to(torch.float32)
    if col.validity is not None:
        vals = torch.where(col.validity, vals, torch.full_like(vals, float("nan")))
    return vals


@op_boundary("to_dmatrix")
def to_dmatrix(
    table: Table,
    feature_cols: Sequence[str],
    label_col: Optional[str] = None,
    weight_col: Optional[str] = None,
    max_bins: Optional[int] = None,
) -> DeviceDMatrix:
    """Build a device DMatrix from a Table; optionally sketch and quantize
    in the same call."""
    feats = torch.stack([_column_as_f32(table.column(c)) for c in feature_cols], dim=1)
    labels = None if label_col is None else _column_as_f32(table.column(label_col))
    weights = None if weight_col is None else _column_as_f32(table.column(weight_col))
    dm = DeviceDMatrix(feats, list(feature_cols), labels, weights)
    if max_bins is not None:
        dm.cuts = quantile_cuts(feats, max_bins)
        dm.binned = quantize(feats, dm.cuts)
    return dm


def _sorted_by_feature(features_t: torch.Tensor) -> torch.Tensor:
    """[F, N] -> each row sorted ascending, NaNs last, -0.0 and +0.0 equal
    and in input order (the reference's stable sort comparator)."""
    key = torch.where(features_t == 0, torch.zeros_like(features_t), features_t)
    key = torch.where(torch.isnan(features_t), torch.full_like(key, float("nan")), key)
    order = torch.argsort(key, dim=1, stable=True)
    return torch.gather(features_t, 1, order)


def _fma_f32(a: torch.Tensor, d: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """float32 ``a + d * f`` with one rounding (a fused multiply-add).
    ``d * f`` is exact in float64 (24 + 24 significand bits); the float64
    sum's own rounding error ``e`` comes from TwoSum, and a sum that lands
    exactly on a float32 rounding midpoint while ``e != 0`` is nudged one
    float64 ulp toward ``e`` (round to odd), so the final rounding to
    float32 is the single correct one. Non-finite operands give the fused
    operation's own inf / NaN."""
    a64, p = a.to(torch.float64), d.to(torch.float64) * f.to(torch.float64)
    s = a64 + p
    bb = s - a64
    e = (a64 - (s - bb)) + (p - bb)
    bits = s.view(torch.int64)
    midpoint = (bits & ((1 << 29) - 1)) == (1 << 28)  # float32 keeps 24 of 53 bits
    toward = torch.where((e > 0) == (s > 0), bits + 1, bits - 1)
    nudge = midpoint & (e != 0) & torch.isfinite(s)
    return torch.where(nudge, toward, bits).view(torch.float64).to(torch.float32)


def quantile_cuts(features: torch.Tensor, max_bins: int) -> torch.Tensor:
    """[F, max_bins-1] per-feature quantile cut points (the hist sketch)."""
    if max_bins < 2:
        raise ValueError("max_bins must be >= 2")
    n, f = features.shape
    dev = features.device
    qs = torch.from_numpy((np.arange(1, max_bins) / max_bins).astype(np.float32)).to(dev)
    if n == 0:
        return torch.full((f, max_bins - 1), float("inf"), dtype=torch.float32, device=dev)
    xt = features.t().contiguous()  # [F, N]
    srt = _sorted_by_feature(xt)
    valid = (~torch.isnan(xt)).sum(dim=1)  # [F] int64
    vm1 = torch.clamp(valid - 1, min=0)
    pos = qs[:, None] * vm1[None, :]  # [B-1, F] float32
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.minimum(lo.to(torch.int64) + 1, vm1[None, :])
    frac = pos - lo.to(torch.float32)
    a = torch.gather(srt, 1, lo.t().to(torch.int64))  # [F, B-1]
    b = torch.gather(srt, 1, hi.t())
    cuts = _fma_f32(a, b - a, frac.t())
    # all-NaN feature: no valid rows -> +inf cuts (everything is missing)
    return torch.where(valid[:, None] > 0, cuts, torch.full_like(cuts, float("inf")))


def quantize(features: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """[N, F] int32 bin ids: the number of cuts strictly below the value;
    a missing value -> ``cuts.shape[1] + 1``."""
    missing_bin = cuts.shape[1] + 1
    counted = torch.where(torch.isnan(cuts), torch.full_like(cuts, float("inf")), cuts)
    counted = torch.sort(counted, dim=1).values.contiguous()
    xt = features.t().contiguous()  # [F, N]
    ids = torch.searchsorted(counted, xt, right=False, out_int32=True)
    ids = torch.where(torch.isnan(xt), torch.full_like(ids, missing_bin), ids)
    return ids.t().contiguous()
