"""Table-level distributed relational ops, the tier Spark's plugin calls
(port of the JAX package's ``parallel/table_ops.py``): the raw-array
operators of ``distributed.py`` and ``join_distributed.py`` lifted to
``columnar.Table`` in and out.

- **Strings ride the exchange as dictionary codes.** The exchange moves
  fixed-width lanes; a STRING column encodes to INT32 codes against a
  batch-global dictionary (one ``np.unique`` over the padded byte
  matrix, on the host), the codes exchange like any integer lane, and
  receivers decode with one ragged gather on the device.
- **Composite keys join exactly.** Routing chains murmur3 across the key
  lanes (``distributed._hash_dest_multi``; one INT32 or INT64 lane runs
  B1). A shard's sorted-run join runs on a 64-bit chained hash of the key
  tuple and verifies every candidate pair on the raw lanes, so a hash
  collision costs an output slot, never a wrong row.
- **Skew-aware capacity default**: ``max(4 * per_shard / P, 64)``
  capped at ``per_shard`` a destination, with the overflow flag as the
  resize signal (the group-by escalates once, the join up to
  ``max_retries`` times, when their capacities were defaulted).
- Nulls follow Spark: null keys form one group (the validity lane joins
  the key tuple), aggregates skip null values, joins never match null
  keys.

FLOAT64 columns aggregate exactly: their IEEE bits ride the exchange
untouched and a shard runs ``ops/f64acc``'s exact accumulator, so
distributed SUM, MEAN, MIN and MAX are bit-identical to the single-chip
path. Group keys sort as the reference's storage sorts them (signed
integers signed, unsigned and FLOAT64 bits unsigned, FLOAT32 by IEEE
total order).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.column import upload
from ..columnar.dtype import TypeId
from ..ops import bitutils
from ..ops.aggregate import _from_total_order, _order_fill, groupby_aggregate
from ..ops.copying import concatenate, slice_table
from ..ops.f64acc import (div_f64bits_by_int, mean_i64_div, segment_mean_f64bits,
                          segment_sum_f64bits)
from ..ops.hashing import murmur3_raw
from ..ops.uword import SIGN64, join_u64
from ..utils import memory
from ..utils.errors import FatalDeviceError
from . import distributed
from . import mesh as mesh_mod
from .distributed import _lexsort_present_first, _scatter_keys, _segments
from .join_distributed import shard_join_pairs
from .shuffle import _exchange_shards
from ..utils.dispatch import op_boundary

__all__ = [
    "dict_encode",
    "dict_decode",
    "default_capacity",
    "exchange_table",
    "distributed_groupby_table",
    "distributed_join_table",
]


def default_capacity(per_shard: int, n_parts: int) -> int:
    """Skew-aware per-destination bucket capacity."""
    return min(per_shard, max(4 * ((per_shard + n_parts - 1) // n_parts), 64))


def _pad_lanes(lanes: List[torch.Tensor], n: int, n_parts: int, device: torch.device):
    """Every lane padded to a row count the mesh divides; returns (padded
    lanes, present lane). Padding rows carry present=False and take no
    part in any group, match or output."""
    pad = (-n) % n_parts
    present = torch.cat([torch.ones((n,), dtype=torch.bool, device=device),
                         torch.zeros((pad,), dtype=torch.bool, device=device)])
    if pad == 0:
        return list(lanes), present
    return [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) for a in lanes], present


# -- the string dictionary codec ---------------------------------------------------


class StringDictionary:
    """Batch-global sorted dictionary: built on the host (``np.unique``),
    its parts on the device for the decode gather."""

    def __init__(self, lens: np.ndarray, chars: np.ndarray, device: torch.device):
        self.lens_h = lens
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        self.offs = upload(offs, device)
        self.lens = upload(lens.astype(np.int32), device)
        self.chars = upload(chars, device)

    def __len__(self) -> int:
        return len(self.lens_h)


def dict_encode(col: Column) -> Tuple[Column, StringDictionary]:
    """STRING column -> (INT32 code column, dictionary). Codes of null rows
    are 0, the validity kept. One ``np.unique`` over the padded byte
    matrix (the length as a tiebreaker lane), no per-row Python."""
    if col.dtype.id != TypeId.STRING:
        raise ValueError("dict_encode takes a STRING column")
    dev = col.device
    offs = col.offsets.cpu().numpy()
    chars = col.chars.cpu().numpy()
    n = len(offs) - 1
    lens = (offs[1:] - offs[:-1]).astype(np.int32)
    width = max(int(lens.max()) if n else 1, 1)
    padded = np.zeros((n, width + 4), np.uint8)  # +4: the length tiebreaker lane
    idx = offs[:-1, None] + np.arange(width)[None, :]
    inb = np.arange(width)[None, :] < lens[:, None]
    if chars.shape[0]:
        padded[:, :width] = np.where(inb, chars[np.clip(idx, 0, chars.shape[0] - 1)], 0)
    padded[:, width:] = lens[:, None].view(np.uint8).reshape(n, 4) if n else 0
    keyed = padded.view([("bytes", np.uint8, width + 4)]).reshape(n)
    uniq, inverse = np.unique(keyed, return_inverse=True)
    codes = inverse.reshape(-1).astype(np.int32)

    u = uniq["bytes"].reshape(len(uniq), width + 4)
    u_lens = u[:, width:].copy().view(np.int32).reshape(-1)
    take = np.arange(width)[None, :] < u_lens[:, None]
    d = StringDictionary(u_lens, u[:, :width][take], dev)
    return Column(dt.INT32, data=upload(codes, dev), validity=col.validity), d


def dict_decode(codes: torch.Tensor, dictionary: StringDictionary, validity=None) -> Column:
    """INT32 codes -> STRING column through one ragged gather."""
    codes = codes.clamp(0, max(len(dictionary) - 1, 0))
    lens = (dictionary.lens[codes] if len(dictionary)
            else torch.zeros(codes.shape, dtype=torch.int32, device=codes.device))
    offs, row_of, pos, total = bitutils.ragged_positions(lens)
    if total == 0:
        chars = torch.zeros((0,), dtype=torch.uint8, device=codes.device)
    else:
        chars = dictionary.chars[dictionary.offs[codes[row_of]] + pos]
    return Column(dt.STRING, validity=validity, offsets=offs, chars=chars)


# -- Table <-> lanes (what rides the exchange) --------------------------------------


def _col_lanes(col: Column):
    """Column -> (data lane, validity lane or None, meta to rebuild it)."""
    tid = col.dtype.id
    if tid == TypeId.STRING:
        codes, d = dict_encode(col)
        return codes.data, col.validity, ("string", d)
    if tid in (TypeId.LIST, TypeId.STRUCT):
        raise ValueError("nested columns: exchange leaf lanes individually")
    return col.data, col.validity, ("fixed", col.dtype)


def _rebuild(meta, data, validity) -> Column:
    kind, aux = meta
    if kind == "string":
        return dict_decode(data, aux, validity=validity)
    return Column(aux, data=data, validity=validity)


def _sort_lane(lane: torch.Tensor, d) -> torch.Tensor:
    """A key lane in the order the reference's storage sorts in: FLOAT64
    as its unsigned bits, other fixed types by ``total_order_key``
    (signed and unsigned integers, FLOAT32's IEEE total order); ``d`` None
    (codes, validity) as it is."""
    if d is None:
        return lane
    if d.id == TypeId.FLOAT64:
        return lane ^ SIGN64
    return bitutils.total_order_key(lane, d)


def _shard_rows_all(lanes, mesh, axis: str):
    return [mesh_mod.shard_rows(a, mesh, axis) for a in lanes]


def _fits(row_bytes: int, n_parts: int, capacity: int, device) -> bool:
    """Whether an exchange's buffers at ``capacity`` fit the device budget."""
    return (memory.exchange_bytes_estimate(row_bytes, n_parts, int(capacity))
            <= memory.device_memory_budget(device))


@op_boundary("exchange_table")
def exchange_table(
    table: Table,
    key_cols: Sequence[str],
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
) -> Tuple[Table, bool]:
    """Hash-repartition a row-sharded Table (strings included) over the
    mesh; returns the received rows as a compacted global Table (shard by
    shard) and the overflow flag. Rows of equal key tuples land on one
    shard."""
    n_parts = mesh.shape[axis]
    home = mesh.home(axis)
    n = table.num_rows

    lanes: List[torch.Tensor] = []
    metas, has_v, lane_pos = [], [], []
    for c in table.columns:
        data, validity, meta = _col_lanes(c)
        lane_pos.append(len(lanes))
        lanes.append(data)
        metas.append(meta)
        has_v.append(validity is not None)
        if validity is not None:
            lanes.append(validity)

    lanes, present = _pad_lanes(lanes, n, n_parts, table.columns[0].device)
    per_shard = present.shape[0] // n_parts
    if capacity is None:
        capacity = default_capacity(per_shard, n_parts)
    # refuse buffers past the device budget before the exchange runs
    # (retryable: the caller splits or the task re-runs)
    row_bytes = 8 * len(lanes)  # every lane <= 8 B
    if not _fits(row_bytes, n_parts, capacity, home):
        raise memory.MemoryBudgetExceeded(
            f"exchange at capacity {capacity} needs "
            f"~{memory.exchange_bytes_estimate(row_bytes, n_parts, int(capacity))} device "
            f"bytes (budget {memory.device_memory_budget(home)}); split the batch or lower "
            f"the capacity"
        )

    # keys come from the payload lanes at these positions; a null key's
    # data is masked to 0 so that every null key hashes alike, and its
    # validity joins the hash chain so that null keys co-locate
    key_pos = []
    for k in key_cols:
        ki = table.names.index(k)
        key_pos.append((lane_pos[ki], lane_pos[ki] + 1 if has_v[ki] else None))

    pres_sh = mesh_mod.shard_rows(present, mesh, axis)
    lane_sh = _shard_rows_all(lanes, mesh, axis)
    dests = []
    for s in range(n_parts):
        ks = []
        for dpos, vpos in key_pos:
            data = lane_sh[dpos][s]
            if vpos is not None:
                validity = lane_sh[vpos][s]
                ks.append(torch.where(validity, data, torch.zeros((), dtype=data.dtype,
                                                                  device=data.device)))
                ks.append(validity.to(torch.int32))
            else:
                ks.append(data)
        dests.append(distributed._hash_dest_multi(ks, n_parts))
    (pres_r, *received), masks, ovf = _exchange_shards(
        [pres_sh] + lane_sh, dests, n_parts, int(capacity))
    keep = mesh_mod.cat([m & p for m, p in zip(masks, pres_r)], home)  # occupied AND real
    overflow = bool(torch.stack([o.to(home) for o in ovf]).any())

    # compact the received slots (the host boundary of the eager op tier)
    sel = torch.nonzero(keep).flatten()
    cols = []
    it = iter(received)
    for meta, nullable in zip(metas, has_v):
        data = mesh_mod.cat(next(it), home)[sel]
        validity = mesh_mod.cat(next(it), home)[sel] if nullable else None
        cols.append(_rebuild(meta, data, validity))
    return Table(cols, names=list(table.names)), overflow


# -- distributed group-by on Tables --------------------------------------------------

_AGG_HOWS = ("sum", "count", "min", "max", "mean")


def _widen(v: torch.Tensor, d) -> torch.Tensor:
    """An integer lane as int64 by its column type: unsigned values
    zero-extend (UINT64's bits stay as they are), signed ones sign-extend."""
    if d.size_bytes < 8 and not d.is_signed and v.dtype != torch.uint8:
        return v.to(torch.int64) & ((1 << (8 * d.size_bytes)) - 1)
    return v.to(torch.int64)


def _segment_extreme(x: torch.Tensor, seg: torch.Tensor, num: int, how: str, fill):
    """Per-segment min or max of ``x`` (masked rows already at ``fill``);
    an empty segment reads ``fill``, the reduction's identity."""
    out = torch.full((num,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, "amin" if how == "min" else "amax", include_self=True)


def _shard_groupby_aggs(key_arrays, val_arrays, hows, present, val_present, capacity: int,
                        key_types, val_types):
    """Static-shape multi-aggregate group-by of one shard. Returns
    (key lanes [capacity], aggregates, their validity, group_valid,
    overflow). An aggregate over a group whose values are all null is
    null (Spark), through its validity; count is 0 and valid."""
    order = _lexsort_present_first(
        [_sort_lane(k, d) for k, d in zip(key_arrays, key_types)], present)
    ks = [k[order] for k in key_arrays]
    ps = present[order]
    seg, num_groups, overflow = _segments(ks, ps, capacity)
    nseg = capacity + 1

    aggs, agg_valid = [], []
    for v, how, vp, d in zip(val_arrays, hows, val_present, val_types):
        # FLOAT64 comes from the column type, never from the lane's torch
        # type, which a genuine INT64 / UINT64 column shares
        vs = v[order]
        vps = (ps & vp[order]) if vp is not None else ps
        cnt = torch.zeros((nseg,), dtype=torch.int64, device=vs.device).index_add_(
            0, seg, vps.to(torch.int64))[:capacity]
        if how in ("sum", "mean"):
            if d.id == TypeId.FLOAT64:
                if how == "sum":
                    aggs.append(segment_sum_f64bits(vs, seg, nseg, valid=vps)[:capacity])
                else:
                    aggs.append(segment_mean_f64bits(vs, seg, nseg, valid=vps)[0][:capacity])
            else:
                x = torch.where(vps, vs, torch.zeros((), dtype=vs.dtype, device=vs.device))
                if not x.is_floating_point():
                    x = _widen(x, d)  # UINT64 keeps its bits: the sum is mod 2^64
                s = x.new_zeros((nseg,)).index_add_(0, seg, x)[:capacity]
                if how == "sum":
                    aggs.append(s)
                elif not s.is_floating_point():
                    aggs.append(mean_i64_div(s, cnt, unsigned=d.id == TypeId.UINT64))
                else:
                    aggs.append(s / cnt.clamp(min=1).to(s.dtype))
            agg_valid.append(cnt > 0)
        elif how == "count":
            aggs.append(cnt)
            agg_valid.append(torch.ones((capacity,), dtype=torch.bool, device=cnt.device))
        elif how in ("min", "max"):
            if d.id == TypeId.FLOAT32:
                fill = float("inf") if how == "min" else float("-inf")
                x = torch.where(vps, vs, torch.tensor(fill, dtype=vs.dtype, device=vs.device))
                aggs.append(_segment_extreme(x, seg, nseg, how, fill)[:capacity])
            else:
                # exact order on the stored bits: total-order keys, the
                # reference's fill at the key's width, back to storage
                fill = _order_fill(d, how)
                key = bitutils.total_order_key(vs, d)
                x = torch.where(vps, key, fill)
                r = _segment_extreme(x, seg, nseg, how, fill)[:capacity]
                aggs.append(_from_total_order(r, d))
            agg_valid.append(cnt > 0)
        else:
            raise ValueError(f"unknown agg {how!r} (supported: {_AGG_HOWS})")

    group_valid = torch.arange(capacity, device=ps.device) < num_groups
    return _scatter_keys(ks, seg, capacity), aggs, agg_valid, group_valid, overflow


@op_boundary("distributed_groupby_table")
def distributed_groupby_table(
    table: Table,
    key_cols: Sequence[str],
    aggs: Sequence[Tuple[str, str, str]],  # (value column, how, output name)
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    group_capacity: Optional[int] = None,
) -> Tuple[Table, bool]:
    """GROUP BY ``key_cols`` with several aggregates across the mesh: a
    Table in, a compacted Table out (the keys, then one column an
    aggregate). STRING keys group by dictionary code and decode on the way
    out. Defaulted capacities re-run once at the capacity that cannot
    overflow; a capacity past the device budget splits the batch."""
    for _v, how, _o in aggs:
        if how not in _AGG_HOWS:
            raise ValueError(f"unknown agg {how!r}")
    n_parts = mesh.shape[axis]
    home = mesh.home(axis)
    per_shard = (table.num_rows + n_parts - 1) // n_parts
    auto = capacity is None and group_capacity is None
    if capacity is None:
        capacity = default_capacity(max(per_shard, 1), n_parts)
    if group_capacity is None:
        group_capacity = min(capacity * n_parts, max(per_shard, 64))
    # the budget guards the first dispatch too: a batch whose default
    # capacity already passes it must split
    row_bytes = _exchange_row_bytes(table, key_cols, aggs)
    if auto and not _fits(row_bytes, n_parts, capacity, home):
        return _groupby_split_retry(table, key_cols, aggs, mesh, axis)
    out = _groupby_once(table, key_cols, aggs, mesh, axis, int(capacity), int(group_capacity))
    if out[1] and auto:
        capacity = max(per_shard, 1)
        # a skewed key must not grow the buckets past the budget: split
        # instead, merging partials
        if not _fits(row_bytes, n_parts, capacity, home):
            return _groupby_split_retry(table, key_cols, aggs, mesh, axis)
        out = _groupby_once(table, key_cols, aggs, mesh, axis, capacity, capacity * n_parts)
    return out


def _exchange_row_bytes(table: Table, key_cols: Sequence[str], aggs) -> int:
    """Bytes an exchanged row of the group-by: 8 B a lane at most, two
    lanes (data and a possible validity) a key and an aggregate value."""
    return 16 * (len(key_cols) + len(aggs))


_MERGE_HOW = {"sum": "sum", "count": "sum", "count_all": "sum", "min": "min", "max": "max"}


def _groupby_split_retry(
    table: Table,
    key_cols: Sequence[str],
    aggs: Sequence[Tuple[str, str, str]],
    mesh,
    axis: str,
) -> Tuple[Table, bool]:
    """Split the batch in half by rows, run each half (under the same
    budget, recursively) and merge the partial results on one device.
    ``mean`` runs as sum and count in the partials and divides at the end;
    the other aggregates merge as they are."""
    memory._note_split()
    n = table.num_rows
    if n < 2:
        # halving stops at one row: retrying is unproductive, so this is
        # fatal (it ends the recursion instead of burning retries)
        raise FatalDeviceError("cannot split a single-row batch further")
    inner_aggs: List[Tuple[str, str, str]] = []
    for vname, how, oname in aggs:
        if how == "mean":
            inner_aggs.append((vname, "sum", f"{oname}__s"))
            inner_aggs.append((vname, "count", f"{oname}__c"))
        else:
            inner_aggs.append((vname, how, oname))

    p = mesh.shape[axis]
    mid = min(max((n // 2 + p - 1) // p * p, 1), n - 1)
    parts = []
    for lo, hi in ((0, mid), (mid, n)):
        out, ovf = distributed_groupby_table(slice_table(table, lo, hi), key_cols, inner_aggs,
                                             mesh, axis=axis)
        if ovf:
            # a half that still overflows cannot give the caller's schema
            # from here: surface the retryable pressure
            raise memory.MemoryBudgetExceeded(
                "groupby split-retry: half-batch still overflows its capacity"
            )
        parts.append(out)

    merged_in = concatenate(parts)
    keys_t = Table([merged_in.column(k) for k in key_cols], list(key_cols))
    val_names = [o for _v, _h, o in inner_aggs]
    vals_t = Table([merged_in.column(o) for o in val_names], val_names)
    merged = groupby_aggregate(keys_t, vals_t, [(o, _MERGE_HOW[h]) for (_v, h, o) in inner_aggs])

    out_cols = [merged.column(k) for k in key_cols]
    out_names = list(key_cols)
    for vname, how, oname in aggs:
        if how == "mean":
            s = merged.column(f"{oname}__s_sum")
            c = merged.column(f"{oname}__c_sum")
            valid = c.data > 0
            if s.validity is not None:
                valid = valid & s.validity
            cnt = c.data.clamp(min=1)
            if s.dtype.id == TypeId.FLOAT64:
                # exact: the merged partial-sum bits over the count
                out_cols.append(Column(dt.FLOAT64, data=div_f64bits_by_int(s.data, cnt),
                                       validity=valid))
            elif not s.data.is_floating_point():
                # as the reference: the merged integer sum read as int64
                out_cols.append(Column(dt.FLOAT64, data=mean_i64_div(s.data.to(torch.int64), cnt),
                                       validity=valid))
            else:
                # FLOAT32 partials divide in their own float lane
                m = s.data / cnt.to(s.data.dtype)
                out_cols.append(Column(dt.FLOAT64, data=bitutils.float_store(m, dt.FLOAT64),
                                       validity=valid))
        else:
            out_cols.append(merged.column(f"{oname}_{_MERGE_HOW[how]}"))
        out_names.append(oname)
    return Table(out_cols, out_names), False


def _groupby_once(
    table: Table,
    key_cols: Sequence[str],
    aggs: Sequence[Tuple[str, str, str]],
    mesh,
    axis: str,
    capacity: int,
    group_capacity: int,
) -> Tuple[Table, bool]:
    n_parts = mesh.shape[axis]
    home = mesh.home(axis)
    cap_g = int(group_capacity)

    # key lanes: the data (a null's masked to 0) and, for a nullable key,
    # its validity as an extra INT32 lane, so that null keys form their
    # own group and route to one shard
    key_metas, key_lanes, key_types, key_nullable = [], [], [], []
    for kname in key_cols:
        col = table.column(kname)
        data, validity, meta = _col_lanes(col)
        key_metas.append(meta)
        key_nullable.append(validity is not None)
        key_types.append(col.dtype if meta[0] == "fixed" else None)
        if validity is not None:
            key_lanes.append(torch.where(validity, data, torch.zeros((), dtype=data.dtype,
                                                                     device=data.device)))
            key_lanes.append(validity.to(torch.int32))
            key_types.append(None)
        else:
            key_lanes.append(data)

    val_lanes, val_valid, hows, val_types = [], [], [], []
    for vname, how, _oname in aggs:
        col = table.column(vname)
        if col.dtype.id == TypeId.STRING:
            raise ValueError("aggregating STRING columns is not supported")
        val_lanes.append(col.data)
        val_valid.append(col.validity)
        hows.append(how)
        val_types.append(col.dtype)
    n_keys, n_vals = len(key_lanes), len(val_lanes)
    valid_lanes = [v for v in val_valid if v is not None]
    all_lanes, present = _pad_lanes(key_lanes + val_lanes + valid_lanes, table.num_rows,
                                    n_parts, table.columns[0].device)
    sh = _shard_rows_all(all_lanes, mesh, axis)
    k_sh = sh[:n_keys]
    dests = [distributed._hash_dest_multi([k[s] for k in k_sh], n_parts)
             for s in range(n_parts)]
    recv, masks, ovf = _exchange_shards(
        [mesh_mod.shard_rows(present, mesh, axis)] + sh, dests, n_parts, capacity)
    pr, kr = recv[0], recv[1:1 + n_keys]
    vr, vpr = recv[1 + n_keys:1 + n_keys + n_vals], recv[1 + n_keys + n_vals:]

    outs = [[] for _ in range(n_keys + 2 * n_vals + 1)]
    for s in range(n_parts):
        it = iter(vpr)
        vp_full = [None if orig is None else next(it)[s] for orig in val_valid]
        gks, gas, gavs, gv, o2 = _shard_groupby_aggs(
            [k[s] for k in kr], [v[s] for v in vr], hows, masks[s] & pr[s], vp_full, cap_g,
            key_types, val_types)
        for lst, x in zip(outs, gks + gas + gavs + [gv]):
            lst.append(x)
        ovf.append(o2)
    glob = [mesh_mod.cat(o, home) for o in outs]
    gks, gas = glob[:n_keys], glob[n_keys:n_keys + n_vals]
    gavs, gv = glob[n_keys + n_vals:n_keys + 2 * n_vals], glob[-1]
    overflow = bool(torch.stack([o.to(home) for o in ovf]).any())

    sel = torch.nonzero(gv).flatten()
    cols: List[Column] = []
    names: List[str] = []
    li = 0
    for kname, meta, nullable in zip(key_cols, key_metas, key_nullable):
        data = gks[li][sel]
        li += 1
        validity = None
        if nullable:
            validity = gks[li][sel].to(torch.bool)
            li += 1
        cols.append(_rebuild(meta, data, validity))
        names.append(kname)
    # one host read for every aggregate's validity; a validity tensor is
    # kept only where a group's values were all null
    av_all = torch.stack(gavs)[:, sel].cpu() if gavs else None
    for j, ((vname, how, oname), g) in enumerate(zip(aggs, gas)):
        arr = g[sel]
        av = av_all[j]
        validity = None if bool(av.all()) else av.to(home)
        src = table.column(vname)
        # exact paths return FLOAT64 bits: every sum, mean, min and max of
        # a FLOAT64 column, and the exact integer mean
        if (src.dtype.id == TypeId.FLOAT64 and how in ("sum", "mean", "min", "max")) or (
            how == "mean" and not src.data.is_floating_point()
        ):
            cols.append(Column(dt.FLOAT64, data=arr, validity=validity))
        elif how == "mean":
            cols.append(Column(dt.FLOAT64, data=bitutils.float_store(arr, dt.FLOAT64),
                               validity=validity))
        elif how == "count":
            cols.append(Column(dt.INT64, data=arr))
        elif how == "sum" and src.dtype.id == TypeId.UINT64:
            cols.append(Column(dt.UINT64, data=arr, validity=validity))
        elif how == "sum" and not arr.is_floating_point():
            cols.append(Column(dt.INT64, data=arr.to(torch.int64), validity=validity))
        else:
            cols.append(Column(src.dtype, data=arr, validity=validity))
        names.append(oname)
    return Table(cols, names=names), overflow


# -- distributed join on Tables -------------------------------------------------------


def _hash64(key_arrays) -> torch.Tensor:
    """[n] int64: two chained murmur3 hashes of the key tuple (seeds 42 and
    0x9E3779B9) as the low and high words. Collisions are verified away
    pair by pair, so this only routes and orders."""
    h1 = h2 = None
    for k in key_arrays:
        h1 = murmur3_raw(k) if h1 is None else murmur3_raw(k, seed=h1)
        h2 = murmur3_raw(k, seed=0x9E3779B9) if h2 is None else murmur3_raw(k, seed=h2)
    return join_u64(h1, h2)


@op_boundary("distributed_join_table")
def distributed_join_table(
    left: Table,
    right: Table,
    on: Sequence[str],
    mesh,
    how: str = "inner",
    axis: str = "data",
    capacity: Optional[int] = None,
    out_capacity: Optional[int] = None,
    max_retries: int = 2,
) -> Tuple[Table, bool]:
    """Shuffled hash join on Tables across the mesh, ``how`` in {inner,
    left_semi, left_anti}. Composite keys route by chained murmur3 and
    match on a verified 64-bit hash run; STRING key and payload columns
    travel as dictionary codes. Null keys never match (Spark).

    Output: inner -> the left columns and the right's non-key columns;
    semi / anti -> the left columns. A compacted global Table and the
    overflow flag. Defaulted capacities (O(N / P) buffers) re-run 4x
    larger on an overflow, up to ``max_retries`` times."""
    if how not in ("inner", "left_semi", "left_anti"):
        raise ValueError(f"how={how!r} not supported (inner/left_semi/left_anti)")
    n_parts = mesh.shape[axis]
    per_l = (left.num_rows + n_parts - 1) // n_parts
    per_r = (right.num_rows + n_parts - 1) // n_parts
    auto = capacity is None and out_capacity is None
    if capacity is None:
        capacity = max(default_capacity(max(per_l, 1), n_parts),
                       default_capacity(max(per_r, 1), n_parts))
    if out_capacity is None:
        out_capacity = max(per_l, 64) if how != "inner" else max(2 * max(per_l, per_r), 64)
    for _attempt in range(max_retries + 1):
        table, ovf = _join_once(left, right, on, mesh, how, axis, int(capacity),
                                int(out_capacity))
        if not ovf or not auto:
            return table, ovf
        capacity = min(capacity * 4, max(per_l, per_r, 1))
        out_capacity *= 4
    return table, ovf


def _join_once(left: Table, right: Table, on: Sequence[str], mesh, how: str, axis: str,
               capacity: int, out_capacity: int) -> Tuple[Table, bool]:
    n_parts = mesh.shape[axis]
    home = mesh.home(axis)

    # STRING join keys need one dictionary over both tables (codes of two
    # encodes would never compare equal): encode the concatenation and
    # split the codes back a side
    shared = {}
    for name in on:
        lc, rc = left.column(name), right.column(name)
        if lc.dtype.id == TypeId.STRING or rc.dtype.id == TypeId.STRING:
            if lc.dtype.id != rc.dtype.id:
                raise ValueError(f"join key {name!r} has mismatched types")
            both = Column(dt.STRING,
                          offsets=torch.cat([lc.offsets, rc.offsets[1:] + lc.offsets[-1]]),
                          chars=torch.cat([lc.chars, rc.chars]))
            codes, d = dict_encode(both)
            nl = len(lc)
            shared[name] = (codes.data[:nl], codes.data[nl:], d)

    def lanes_of(tbl: Table, side: int):
        lanes, metas, has_v = [], [], []
        for nm, c in zip(tbl.names, tbl.columns):
            if nm in shared:
                data, validity, meta = shared[nm][side], c.validity, ("string", shared[nm][2])
            else:
                data, validity, meta = _col_lanes(c)
            lanes.append(data)
            metas.append(meta)
            has_v.append(validity is not None)
            if validity is not None:
                lanes.append(validity)
        return lanes, metas, has_v

    def key_positions(tbl: Table, has_v):
        # (data lane, validity lane or None) of each key: key lanes ride the
        # exchange once, inside the payload; the routing hash and the
        # collision check both read them there
        out = []
        for name in on:
            i = tbl.names.index(name)
            pos = sum(1 + int(h) for h in has_v[:i])
            out.append((pos, pos + 1 if has_v[i] else None))
        return out

    def keys_from(lanes, kpos):
        ks, non_null = [], None
        for dpos, vpos in kpos:
            ks.append(lanes[dpos])
            if vpos is not None:
                v = lanes[vpos].to(torch.bool)
                non_null = v if non_null is None else (non_null & v)
        return ks, non_null

    def side(tbl: Table, which: int):
        """Route, hash and exchange one side: per destination shard, the
        received hash, present and payload lanes, the occupancy, and the
        overflow flags."""
        lanes, metas, has_v = lanes_of(tbl, which)
        kpos = key_positions(tbl, has_v)
        # pad to a row count the mesh divides (padding never matches)
        lanes, present = _pad_lanes(lanes, tbl.num_rows, n_parts, tbl.columns[0].device)
        sh = _shard_rows_all(lanes, mesh, axis)
        dests = [distributed._hash_dest_multi(keys_from([x[s] for x in sh], kpos)[0], n_parts)
                 for s in range(n_parts)]
        # the 64-bit hash is elementwise: one pass over the global lanes
        # gives each shard's rows their hashes
        hashes = mesh_mod.shard_rows(_hash64(keys_from(lanes, kpos)[0]), mesh, axis)
        (h_r, pres_r, *lanes_r), masks, ovf = _exchange_shards(
            [hashes, mesh_mod.shard_rows(present, mesh, axis)] + sh, dests, n_parts, capacity)
        return metas, has_v, kpos, h_r, pres_r, lanes_r, masks, ovf

    l_metas, l_hasv, l_kpos, lh_r, lpres_r, l_r, lm, o1 = side(left, 0)
    r_metas, r_hasv, r_kpos, rh_r, rpres_r, r_r, rm, o2 = side(right, 1)

    def wsel(mask, arr):  # mask rows, broadcast over trailing dims
        m = mask.reshape(mask.shape + (1,) * (arr.dim() - 1))
        return torch.where(m, arr, torch.zeros((), dtype=arr.dtype, device=arr.device))

    n_lanes = len(l_r) + (len(r_r) if how == "inner" else 0)
    outs, keeps, ovf = [[] for _ in range(n_lanes)], [], o1 + o2
    for s in range(n_parts):
        lps = [x[s] for x in l_r]
        rps = [x[s] for x in r_r]
        lks, lkv = keys_from(lps, l_kpos)
        rks, rkv = keys_from(rps, r_kpos)
        lmask = lm[s] & lpres_r[s]
        rmask = rm[s] & rpres_r[s]
        lpresent = lmask if lkv is None else (lmask & lkv)
        rpresent = rmask if rkv is None else (rmask & rkv)
        li, ri, pv, o3 = shard_join_pairs(lh_r[s], lpresent, rh_r[s], rpresent, out_capacity)
        ovf.append(o3)
        # the raw keys must be equal: hash collisions are shed here
        for a, b in zip(lks, rks):
            pv = pv & (a[li] == b[ri])
        if how == "inner":
            shard_outs = [wsel(pv, x[li]) for x in lps] + [wsel(pv, x[ri]) for x in rps]
            keeps.append(pv)
        else:
            # semi / anti: the pair hits reduced onto the left rows
            hit = torch.zeros(lh_r[s].shape, dtype=torch.int32, device=pv.device).index_add_(
                0, li.to(torch.int64), pv.to(torch.int32)) > 0
            keeps.append((lmask & hit) if how == "left_semi" else (lmask & ~hit))
            shard_outs = lps
        for lst, x in zip(outs, shard_outs):
            lst.append(x)
    overflow = bool(torch.stack([o.to(home) for o in ovf]).any())
    sel = torch.nonzero(mesh_mod.cat(keeps, home)).flatten()
    received = [mesh_mod.cat(o, home)[sel] for o in outs]

    def rebuild(tbl: Table, metas, has_v, lanes, skip_keys: bool):
        cols, names = [], []
        it = iter(lanes)
        for name, meta, nullable in zip(tbl.names, metas, has_v):
            data = next(it)
            validity = next(it).to(torch.bool) if nullable else None
            if skip_keys and name in on:
                continue
            cols.append(_rebuild(meta, data, validity))
            names.append(name)
        return cols, names

    cols, names = rebuild(left, l_metas, l_hasv, received[:len(l_r)], skip_keys=False)
    if how == "inner":
        rc_, rn = rebuild(right, r_metas, r_hasv, received[len(l_r):], skip_keys=True)
        for c, nm in zip(rc_, rn):
            names.append(nm if nm not in names else f"{nm}_right")
            cols.append(c)
    return Table(cols, names=names), overflow
