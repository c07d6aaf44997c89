"""The hash-aggregate tier (port of the JAX package's ``ops/aggregate.py``,
cudf groupby): the bounded-domain GROUP BY SUM and the general sort-based
GROUP BY.

``groupby_aggregate`` sorts the rows by their keys (``ops/sort``), marks
group boundaries where a key differs from its neighbour (nulls compare
equal, SQL GROUP BY semantics), syncs the group count to the host once
and reduces each value column per segment. Aggregations: sum, count,
count_all, min, max, mean, nunique, and var/std (sample) and
var_pop/stddev_pop (population). FLOAT64 SUM and MEAN are exact through
``ops/f64acc`` (the nearest-even float64 of the exact sum, the same bits
as the reference's); min/max compare total-order keys, exact for floats
too; integer sums are two's-complement int64; FLOAT32 sums accumulate
in float32, in another order than the reference's (its tests' bound,
rtol 2e-6 / atol 1e-3, holds them).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import TypeId
from . import bitutils, f64acc
from .copying import gather
from .hopper_kernels import MAX_KEYS, groupby_sum_outer
from .sort import _string_prefix_keys, sorted_order
from .uword import MASK32, to_signed_bits
from ..utils.dispatch import op_boundary

__all__ = ["groupby_aggregate", "groupby_sum_bounded"]


def _keys_equal_neighbor(col: Column, order: torch.Tensor) -> torch.Tensor:
    """[N-1] bool: sorted row i equals row i-1 in this key (nulls equal).
    STRING rows compare their lengths and 16-byte prefix keys only, as
    the reference does (the sort key's resolution)."""
    v = col.valid_mask()[order]
    same_valid = v[1:] == v[:-1]
    if col.dtype.id == TypeId.STRING:
        lens = (col.offsets[1:] - col.offsets[:-1])[order]
        k1, k2 = (k[order] for k in _string_prefix_keys(col))
        same = (lens[1:] == lens[:-1]) & (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1])
    elif col.dtype.id == TypeId.DECIMAL128:
        d = col.data[order]
        same = (d[1:] == d[:-1]).all(dim=1)
    else:
        d = col.data[order]
        same = d[1:] == d[:-1]
    both_null = ~v[1:] & ~v[:-1]
    return same_valid & (same | both_null)


def _segment_ids(keys: Table, order: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Dense segment id (int32) of each sorted row and the segment count."""
    n = keys.num_rows
    dev = order.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev), 0
    eq = torch.ones((n - 1,), dtype=torch.bool, device=dev)
    for col in keys.columns:
        eq = eq & _keys_equal_neighbor(col, order)
    starts = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), ~eq])
    seg = (torch.cumsum(starts, 0) - 1).to(torch.int32)
    return seg, int(seg[-1]) + 1  # host sync: the group count


def groupby_sum_bounded(
    keys: torch.Tensor,
    vals: torch.Tensor,
    num_keys: int,
    f64_bits: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GROUP BY SUM for a bounded integer key domain [0, num_keys):
    returns (sums[num_keys], counts[num_keys] int64); keys outside the
    domain are dropped.

    float32 ``vals`` with ``num_keys <= 65536`` and fewer than 2^24 rows
    (the reference's gate for its kernel, kept so both packages dispatch
    alike) go to B3 (``hopper_kernels.groupby_sum_outer``). Other values
    sum in one index_add_: integers in two's-complement int64, floats in
    their own type. Integer ``vals`` widen as their torch type says, so
    a UINT16/UINT32 column (held in the signed storage of its width)
    is passed as ``data.view(torch.uint16)`` / ``view(torch.uint32)`` to
    widen by zero extension as the reference's unsigned types do.
    ``f64_bits=True`` takes FLOAT64 values as their int64 IEEE-bit storage
    and returns EXACT sums as int64 bits (``ops/f64acc``): an explicit
    flag, since a real INT64 column keeps integer semantics."""
    if f64_bits:
        if vals.dtype != torch.int64:
            raise ValueError("f64_bits vals must be int64 IEEE-bit storage")
        seg = _bounded_segments(keys, num_keys)
        sums = f64acc.segment_sum_f64bits(vals, seg, num_keys + 1)[:num_keys]
        counts = f64acc.segment_rows(torch.ones_like(seg), seg, num_keys + 1)[:num_keys]
        return sums, counts
    if vals.dtype == torch.float32 and num_keys <= MAX_KEYS and keys.shape[0] < (1 << 24):
        return groupby_sum_outer(keys, vals, num_keys)
    seg = _bounded_segments(keys, num_keys)
    if not vals.is_floating_point():
        vals = vals.to(torch.int64)
    sums = torch.zeros(num_keys + 1, dtype=vals.dtype, device=vals.device)
    sums.index_add_(0, seg, vals)
    counts = torch.bincount(seg, minlength=num_keys + 1)
    return sums[:num_keys], counts[:num_keys]


def _bounded_segments(keys: torch.Tensor, num_keys: int) -> torch.Tensor:
    """int64 segment ids: the key where it lies in [0, num_keys) (checked
    at the key's own width), else the trash segment num_keys."""
    return torch.where((keys >= 0) & (keys < num_keys), keys, num_keys).to(torch.int64)


def _int_values(data: torch.Tensor, d) -> torch.Tensor:
    """Integer column storage -> int64 values (UINT16/UINT32 zero-extended
    from their signed storage; UINT64 keeps its bits, as the reference's
    int64 cast does)."""
    if d.id in (TypeId.UINT16, TypeId.UINT32):
        return data.to(torch.int64) & ((1 << (8 * d.size_bytes)) - 1)
    return data.to(torch.int64)


def _float64_values(data: torch.Tensor, d) -> torch.Tensor:
    """Numeric column storage -> float64 values, as the reference's cast
    (UINT64 converted as unsigned, nearest-even)."""
    if d.id == TypeId.FLOAT64:
        return bitutils.float_view(data, d)
    if d.id == TypeId.UINT64:
        return f64acc.u64_to_f64bits(data).view(torch.float64)
    if d.id == TypeId.FLOAT32:
        return data.to(torch.float64)
    return _int_values(data, d).to(torch.float64)


def _seg_sum_float(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    return torch.zeros(num, dtype=x.dtype, device=x.device).index_add_(0, seg.to(torch.int64), x)


def _agg_column(col: Column, order, seg, num, how: str) -> Column:
    d = col.dtype
    sorted_valid = col.valid_mask()[order]
    if how == "count_all":
        return Column(dt.INT64, data=f64acc.segment_rows(torch.ones_like(seg, dtype=torch.int64),
                                                         seg, num))
    if how == "count":
        return Column(dt.INT64, data=f64acc.segment_rows(sorted_valid.to(torch.int64), seg, num))
    if how in _VAR_STD_HOWS:
        # numeric inputs only (Spark's var_samp/stddev_samp and
        # var_pop/stddev_pop analysis rule)
        if not (d.is_integral or d.is_floating):
            raise ValueError(f"{how} requires a numeric (integral or floating) column, got {d!r}")
        return _var_std_column(col, order, seg, num, how, sorted_valid)

    any_valid = f64acc.segment_rows(sorted_valid.to(torch.int64), seg, num) > 0

    if how in ("min", "max") and d.is_fixed_width and d.id != TypeId.DECIMAL128:
        # exact through total-order keys, floats included
        key = bitutils.total_order_key(col.data, d)[order]
        fill = _order_fill(d, how)
        key = torch.where(sorted_valid, key, fill)
        best = torch.full((num,), fill, dtype=torch.int64, device=key.device).scatter_reduce_(
            0, seg.to(torch.int64), key, "amin" if how == "min" else "amax")
        return Column(d, data=_from_total_order(best, d), validity=any_valid)

    if how in ("sum", "mean"):
        if d.id == TypeId.FLOAT64:
            # exact: windowed integer accumulation over the IEEE bits
            bits = col.data[order]
            if how == "sum":
                out = f64acc.segment_sum_f64bits(bits, seg, num, valid=sorted_valid)
            else:
                out, _ = f64acc.segment_mean_f64bits(bits, seg, num, valid=sorted_valid)
            return Column(dt.FLOAT64, data=out, validity=any_valid)
        if d.is_floating:  # FLOAT32: accumulates in float32
            vals = torch.where(sorted_valid, col.data[order], 0.0)
            s = _seg_sum_float(vals, seg, num)
            if how == "mean":
                cnt = _seg_sum_float(sorted_valid.to(vals.dtype), seg, num)
                s = s / cnt.clamp(min=1)
                return Column(dt.FLOAT64, data=bitutils.float_store(s, dt.FLOAT64),
                              validity=any_valid)
            return Column(dt.FLOAT32, data=s, validity=any_valid)
        if d.id == TypeId.DECIMAL128:
            # limb-wise int64 partial sums + carry renormalize: two's
            # complement limbs summed mod 2^128 (wraps past 128 bits)
            limbs = torch.where(sorted_valid[:, None], col.data[order], 0).to(torch.int64) & MASK32
            parts = f64acc.segment_rows(limbs, seg, num)
            out, carry = [], torch.zeros((num,), dtype=torch.int64, device=limbs.device)
            for k in range(4):
                t = parts[:, k] + carry
                out.append(to_signed_bits(t & MASK32, 32))
                carry = t >> 32
            return Column(d, data=torch.stack(out, dim=1), validity=any_valid)
        if how == "mean":
            vals = torch.where(sorted_valid, _float64_values(col.data, d)[order], 0.0)
            s = _seg_sum_float(vals, seg, num)
            cnt = _seg_sum_float(sorted_valid.to(torch.float64), seg, num)
            return Column(dt.FLOAT64, data=bitutils.float_store(s / cnt.clamp(min=1), dt.FLOAT64),
                          validity=any_valid)
        # integral sum -> int64 (Spark sum semantics)
        vals = torch.where(sorted_valid, _int_values(col.data, d)[order], 0)
        return Column(dt.INT64, data=f64acc.segment_rows(vals, seg, num), validity=any_valid)

    raise ValueError(f"unsupported aggregation {how!r} on {d!r}")


_VAR_STD_HOWS = ("var", "std", "var_pop", "stddev_pop")


def _var_std_column(col: Column, order, seg, num, how: str, sorted_valid) -> Column:
    """Sample variance / stddev (Spark var_samp / stddev_samp: DOUBLE out,
    NULL below two valid rows) and the population variants var_pop /
    stddev_pop (the same M2 over n, NULL only with no valid rows). Stable
    two-pass M2: group means first, then the sum of squared deviations,
    in real float64; the [G]-scale divide runs on the host, as in the
    reference (the group count already synced)."""
    x = _float64_values(col.data, col.dtype)
    xs = torch.where(sorted_valid, x[order], 0.0)
    cnt_dev = f64acc.segment_rows(sorted_valid.to(torch.int64), seg, num)
    mean = _seg_sum_float(xs, seg, num) / cnt_dev.clamp(min=1)
    dx = torch.where(sorted_valid, xs - mean[seg.to(torch.int64)], 0.0)
    m2 = _seg_sum_float(dx * dx, seg, num).cpu().numpy()
    cnt = cnt_dev.cpu().numpy().astype(np.float64)
    pop = how in ("var_pop", "stddev_pop")
    ok = cnt >= (1 if pop else 2)
    var = np.maximum(m2 / np.maximum(cnt - (0 if pop else 1), 1.0), 0.0)
    out = np.sqrt(var) if how in ("std", "stddev_pop") else var
    dev = xs.device
    return Column(dt.FLOAT64,
                  data=torch.from_numpy(np.where(ok, out, 0.0).view(np.int64).copy()).to(dev),
                  validity=torch.from_numpy(ok).to(dev))


def _order_fill(d, how: str) -> int:
    """The reference's fill key (all ones for min, 0 for max, at the key's
    width) in the port's int64 order lanes, where a 64-bit key's sign bit
    is flipped and a narrower key is zero-extended."""
    if d.size_bytes == 8:
        return bitutils.SIGN64 ^ -1 if how == "min" else bitutils.SIGN64
    return (1 << (8 * d.size_bytes)) - 1 if how == "min" else 0


def _from_total_order(key: torch.Tensor, d) -> torch.Tensor:
    """Inverse of ``bitutils.total_order_key``: int64 order lanes -> the
    column's storage."""
    if d.id == TypeId.FLOAT64:
        return torch.where(key < 0, key ^ ((1 << 63) - 1), key)
    if d.id == TypeId.FLOAT32:
        u = torch.where(key >= (1 << 31), key ^ (1 << 31), key ^ MASK32)
        return to_signed_bits(u, 32).view(torch.float32)
    width = 8 * d.size_bytes
    if d.is_signed or d.id in bitutils._SIGNED_ORDER:
        if width == 64:
            return key
        return (key - (1 << (width - 1))).to(d.torch_dtype)
    if width == 64:
        return key ^ bitutils.SIGN64
    if d.torch_dtype == torch.uint8:
        return key.to(torch.uint8)
    return to_signed_bits(key, width)


@op_boundary("groupby_aggregate")
def groupby_aggregate(keys: Table, values: Table, aggs: Sequence[Tuple[str, str]]) -> Table:
    """GROUP BY ``keys``, computing ``aggs`` = [(value column name, how),
    ...]. Returns a Table of the unique keys followed by one column per
    aggregation named ``{col}_{how}``, rows in key order."""
    n = keys.num_rows
    order = sorted_order(keys)
    seg, num = _segment_ids(keys, order)
    dev = order.device
    first = torch.searchsorted(seg.to(torch.int64), torch.arange(num, dtype=torch.int64, device=dev),
                               side="left")
    out_keys = gather(keys, order[first] if n else torch.zeros((0,), dtype=torch.int32, device=dev))
    out_cols: List[Column] = list(out_keys.columns)
    out_names: List[str] = list(out_keys.names)
    for col_name, how in aggs:
        col = values.column(col_name)
        if how == "nunique":
            out_cols.append(_nunique_column(keys, col, num))
        else:
            out_cols.append(_agg_column(col, order, seg, num, how))
        out_names.append(f"{col_name}_{how}")
    return Table(out_cols, out_names)


def _nunique_column(keys: Table, col: Column, num: int) -> Column:
    """COUNT(DISTINCT col) per group, nulls excluded: re-sort by (keys...,
    col) so equal values are adjacent within a group; a valid value is new
    when it differs from its predecessor, or that is another group or
    null."""
    both = Table(list(keys.columns) + [col], list(keys.names) + ["__v"])
    order2 = sorted_order(both)
    seg2, num2 = _segment_ids(keys, order2)
    if num2 != num:
        raise AssertionError("group count mismatch between sort orders")
    if keys.num_rows == 0:
        return Column(dt.INT64, data=torch.zeros((0,), dtype=torch.int64, device=order2.device))
    valid = col.valid_mask()[order2]
    same_val = _keys_equal_neighbor(col, order2)
    same_group = seg2[1:] == seg2[:-1]
    is_new = torch.cat([valid[:1], valid[1:] & ~(same_group & same_val & valid[:-1])])
    return Column(dt.INT64, data=f64acc.segment_rows(is_new.to(torch.int64), seg2, num))
