"""Compiled query pipelines: one stage of a plan (join* -> filter ->
project -> aggregate) run as one call (port of the JAX package's
``pipeline.py``).

The reference traces the whole stage under one ``jax.jit`` so a backend
pays one dispatch per ColumnarBatch. The port runs the same body eagerly,
one torch op after another; ``CompiledPipeline`` keeps its name and its
contract (a plan bound once, called per batch). What the body does:

- Grouped aggregation over BOUNDED key domains (dictionary-coded group
  columns): the group id is a mixed radix over the per-key domains, and
  each aggregate is a dense reduction over [num + 1] segments, the last
  one a trash segment for filtered-out, null-keyed and null-valued rows.
  No sort; empty groups are dropped on the host at the end.
- Filters never materialize a filtered table: rows outside the predicate
  fall into the trash segment (grouped) or a masked identity (global).
- Joins against build tables: a dense bounded-domain map (``num_keys``
  set) or a sort-merge lookup (``num_keys=None``).
- FLOAT64 SUM/MEAN are exact (``ops/f64acc``); integer SUM/MEAN are exact
  int64 sums materialized as correctly rounded float64 bits; MIN/MAX
  compare in the exact total-order or integer domain; FLOAT32 sums go to
  the bounded group-by (B3 on the card).

Host syncs, as in the reference: the join mis-declaration counts, the
out-of-domain count, and the group counts for the compaction. The call
crosses ``op_boundary("compiled_pipeline")`` and counts
``pipeline.compiles`` / ``batches`` / ``rows`` as the reference does; its
spillable build tables (memgov) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .columnar import Column, Table
from .columnar import dtype as dt
from .ops import bitutils
from .ops.aggregate import _from_total_order, _int_values, groupby_sum_bounded
from .ops.expressions import Expression
from .ops.f64acc import (i64_to_f64bits, mean_i64_div, segment_mean_f64bits, segment_rows,
                         segment_sum_f64bits, u64_to_f64bits)
from .utils import deadline, metrics
from .utils.dispatch import op_boundary

__all__ = ["Agg", "GroupKey", "JoinSpec", "PlanSpec", "CompiledPipeline", "compile_plan"]

_AGG_HOWS = ("sum", "count", "count_all", "min", "max", "mean")
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class Agg:
    """One aggregate over an input or projected column."""

    source: str
    how: str
    name: Optional[str] = None  # output column name; default source_how

    @property
    def out_name(self) -> str:
        return self.name or f"{self.source}_{self.how}"


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """Bounded-domain group key: values must lie in [0, num_keys)."""

    column: str
    num_keys: int


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """Join against a BUILD table (the broadcast dimension join a stage
    offloads). ``num_keys`` set: bounded domain, the build side scattered
    into a dense [num_keys] presence/payload map and the probe a row
    gather. ``num_keys=None``: sort-merge for arbitrary integer keys, the
    build side sorted once (excluded rows parked after every entered
    row), each probe binary-searched and verified by raw key equality.

    ``how``: "inner" gathers ``payload`` columns into the working schema
    and drops probe misses; "semi"/"anti" keep/drop rows by presence only
    (no payload). Build keys must be UNIQUE among rows passing
    ``build_filter`` for inner joins; duplicates raise, like out-of-domain
    group keys."""

    build: str  # name of the build table passed to __call__
    probe_key: str  # column in the working (fact-side) schema
    build_key: str  # column in the build table
    num_keys: Optional[int] = None  # bounded domain; None = sort-merge
    payload: Tuple[str, ...] = ()
    how: str = "inner"
    build_filter: Optional[Expression] = None

    def __post_init__(self):
        if self.how not in ("inner", "semi", "anti"):
            raise ValueError(f"unknown join {self.how!r}")
        if self.how != "inner" and self.payload:
            raise ValueError("payload columns require an inner join")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Declarative single-stage plan: join* -> filter -> project ->
    aggregate. ``joins`` apply in order and splice their payload columns
    into the working schema; ``filter`` and ``project`` see the post-join
    schema; aggregates may name input, payload or projected columns. With
    no ``group_by`` the stage is a global aggregation giving one row."""

    filter: Optional[Expression] = None
    project: Tuple[Tuple[str, Expression], ...] = ()
    group_by: Tuple[GroupKey, ...] = ()
    aggregates: Tuple[Agg, ...] = ()
    joins: Tuple[JoinSpec, ...] = ()

    def __post_init__(self):
        if not self.aggregates:
            raise ValueError("plan needs at least one aggregate")
        for a in self.aggregates:
            if a.how not in _AGG_HOWS:
                raise ValueError(f"unknown aggregate {a.how!r}")


class CompiledPipeline:
    """A plan bound once; call it with a Table of the plan's schema (and
    its build tables) per batch."""

    def __init__(self, plan: PlanSpec):
        self.plan = plan
        metrics.counter("pipeline.compiles").inc()

    def register_build(self, name: str, table: Table) -> None:
        raise NotImplementedError(
            "spillable build tables need the memory governor, not ported yet "
            "(ROADMAP.md, Open items, section 1, item 12); pass builds= to the call")

    def unregister_builds(self) -> None:
        raise NotImplementedError(
            "spillable build tables need the memory governor, not ported yet "
            "(ROADMAP.md, Open items, section 1, item 12)")

    def _run(self, table: Table, builds: Dict[str, Table]):
        """The stage's body: (aggregates, counts_all, num, out-of-domain
        count, duplicate build keys, out-of-domain build rows), all on the
        device."""
        plan = self.plan
        dev = table.columns[0].device
        cols = dict(zip(table.names, table.columns))
        mask = None
        n_dup = torch.zeros((), dtype=torch.int64, device=dev)
        n_bad_build = torch.zeros((), dtype=torch.int64, device=dev)
        for js in plan.joins:
            join = _sorted_join if js.num_keys is None else _dense_join
            hit, joined, dups, bad_build = join(js, cols, builds[js.build])
            n_dup = n_dup + dups
            n_bad_build = n_bad_build + bad_build
            keep = ~hit if js.how == "anti" else hit
            mask = keep if mask is None else mask & keep
            cols.update(joined)

        if plan.filter is not None:
            pred = plan.filter.evaluate(Table(list(cols.values()), list(cols.keys())))
            fm = pred.data.to(torch.bool)
            if pred.validity is not None:
                fm = fm & pred.validity
            mask = fm if mask is None else mask & fm

        # projected columns join the working schema
        work = Table(list(cols.values()), list(cols.keys()))
        for name, expr in plan.project:
            cols[name] = expr.evaluate(work)

        if not plan.group_by:
            out = {}
            for agg in plan.aggregates:
                col = cols[agg.source]
                if agg.how == "count_all":
                    v = mask  # COUNT(*): the filter applies, null values still count
                else:
                    v = col.validity
                    if mask is not None:
                        v = mask if v is None else v & mask
                out[agg.out_name] = _global_agg(col, v, agg.how)
            return out, None, None, None, n_dup, n_bad_build

        # mixed-radix group id over the bounded domains; filtered-out and
        # null-keyed rows land in the trash segment
        num = 1
        for gk in plan.group_by:
            num *= gk.num_keys
        n = table.num_rows
        gid = torch.zeros((n,), dtype=torch.int32, device=dev)
        bad = torch.zeros((n,), dtype=torch.bool, device=dev)  # null key or filtered
        out_of_domain = torch.zeros((n,), dtype=torch.bool, device=dev)
        for gk in plan.group_by:
            kcol = cols[gk.column]
            k = kcol.data.to(torch.int32)  # narrowed first, as in the reference
            oob = (k < 0) | (k >= gk.num_keys)
            if kcol.validity is not None:
                oob = oob & kcol.validity  # null keys are not "out of domain"
                bad = bad | ~kcol.validity
            out_of_domain = out_of_domain | oob
            bad = bad | oob
            gid = gid * gk.num_keys + k.clamp(0, gk.num_keys - 1)
        if mask is not None:
            bad = bad | ~mask
            out_of_domain = out_of_domain & mask
        gid = torch.where(bad, num, gid)
        # keys outside the declared domain: a plan mis-declaration,
        # raised by the host wrapper
        n_out_of_domain = out_of_domain.to(torch.int64).sum()
        counts_all = segment_rows(torch.ones((n,), dtype=torch.int64, device=dev), gid,
                                  num + 1)[:num]
        aggs = {}
        for agg in plan.aggregates:
            col = cols[agg.source]
            aggs[agg.out_name] = _grouped_agg(col, col.validity, gid, num, agg.how, counts_all)
        return aggs, counts_all, num, n_out_of_domain, n_dup, n_bad_build

    @op_boundary("compiled_pipeline")
    def __call__(self, table: Table, builds: Optional[Dict[str, Table]] = None) -> Table:
        """One batch through the plan. ``op_boundary`` makes this a
        deadline-scoped dispatch (``deadline_s=`` or the ambient knob),
        with a cancel point between the body and the host-side result
        materialization."""
        plan = self.plan
        metrics.counter("pipeline.batches").inc()
        metrics.counter("pipeline.rows").inc(table.num_rows)
        want = {js.build for js in plan.joins}
        have = set(builds or {})
        if want != have:
            raise ValueError(f"plan needs build tables {sorted(want)}, got {sorted(have)}")
        aggs, counts_all, num, n_oob, n_dup, n_bad_build = self._run(table, builds or {})
        # cancel point: a query whose budget died in the body stops here,
        # before the host syncs and the compaction
        deadline.check("compiled_pipeline")
        if plan.joins:
            dups, bad_build = int(n_dup), int(n_bad_build)
            if dups:
                raise ValueError(
                    f"{dups} duplicate build keys in an inner-join payload map; "
                    "bounded-domain joins require unique build keys")
            if bad_build:
                raise ValueError(
                    f"{bad_build} build rows have join keys outside the declared "
                    "bounded domain; widen the JoinSpec num_keys")
        if n_oob is not None:
            oob = int(n_oob)
            if oob:
                raise ValueError(
                    f"{oob} rows have group keys outside the declared bounded "
                    "domain; widen the GroupKey num_keys or pre-filter")
        if not plan.group_by:
            out_cols, names = [], []
            for agg in plan.aggregates:
                data, valid = aggs[agg.out_name]
                out_cols.append(_wrap_result(data[None], None if valid is None else valid[None],
                                             agg.how))
                names.append(agg.out_name)
            return Table(out_cols, names)

        # compact the non-empty groups (one host sync for the result size)
        present = np.nonzero(counts_all.cpu().numpy() > 0)[0]
        dev = counts_all.device
        idx = torch.from_numpy(present).to(dev)
        out_cols = []
        radix = present.copy()
        for gk in reversed(plan.group_by):
            out_cols.insert(0, Column(dt.INT32, data=torch.from_numpy(
                (radix % gk.num_keys).astype(np.int32)).to(dev)))
            radix //= gk.num_keys
        names = [gk.column for gk in plan.group_by]
        for agg in plan.aggregates:
            data, valid = aggs[agg.out_name]
            out_cols.append(_wrap_result(data[idx], None if valid is None else valid[idx],
                                         agg.how))
            names.append(agg.out_name)
        return Table(out_cols, names)


def _global_agg(col: Column, v, how: str):
    """Global (one-group) aggregate through the grouped path with a single
    segment, so every exactness path is shared."""
    n = len(col)
    dev = col.device
    gid = torch.zeros((n,), dtype=torch.int32, device=dev)
    m = torch.ones((n,), dtype=torch.bool, device=dev) if v is None else v
    counts = m.to(torch.int64).sum()[None]
    data, valid = _grouped_agg(col, v, gid, 1, how, counts)
    return data[0], None if valid is None else valid[0]


def _grouped_agg(col: Column, v, gid, num: int, how: str, counts_all):
    """Dense [num] aggregate and optional [num] validity; rows with
    gid == num (and null values) are dropped. Exact FLOAT64 results come
    back as int64 IEEE bits (told apart by ``_wrap_result``)."""
    n = len(col)
    m = torch.ones((n,), dtype=torch.bool, device=gid.device) if v is None else v
    gid_v = torch.where(m, gid, num)  # null values drop from value aggregates
    if how == "count_all":
        return counts_all, None
    if how == "count":
        return segment_rows(m.to(torch.int64), gid_v, num + 1)[:num], None
    d = col.dtype
    if how in ("sum", "mean"):
        if d.id == dt.TypeId.FLOAT64:
            if how == "sum":
                s = segment_sum_f64bits(col.data, gid_v, num + 1)[:num]
                c = segment_rows(m.to(torch.int64), gid_v, num + 1)[:num]
                return s, c > 0
            mb, c = segment_mean_f64bits(col.data, gid_v, num + 1)
            return mb[:num], c[:num] > 0
        if not d.is_floating:
            # integers: exact int64 sums (Spark sum(int) -> long),
            # materialized into FLOAT64 bits; UINT64 sums share the two's
            # complement bits and only the final reading is unsigned
            is_u64 = d.id == dt.TypeId.UINT64
            vals = torch.where(m, _int_values(col.data, d), 0)
            s = segment_rows(vals, gid_v, num + 1)[:num]
            c = segment_rows(m.to(torch.int64), gid_v, num + 1)[:num]
            if how == "sum":
                return (u64_to_f64bits(s) if is_u64 else i64_to_f64bits(s)), c > 0
            return mean_i64_div(s, c, unsigned=is_u64), c > 0
        # FLOAT32: sums and per-group valid counts in one bounded group-by
        s, c = groupby_sum_bounded(gid_v, col.data, num)
        if how == "sum":
            return s, c > 0
        return s / c.to(s.dtype).clamp(min=1.0), c > 0
    # min/max validity comes from the per-group valid-row count, never
    # from the result: a genuine +/-inf value must survive
    has_vals = segment_rows(m.to(torch.int64), gid_v, num + 1)[:num] > 0
    red = "amin" if how == "min" else "amax"
    fill = _INT64_MAX if how == "min" else _INT64_MIN
    if d.id == dt.TypeId.FLOAT64:
        # exact total-order comparison on the stored bits
        k = bitutils.total_order_key(col.data, dt.FLOAT64)
        r = _segment_reduce(torch.where(m, k, fill), gid_v, num, red, fill)
        return _from_total_order(r, dt.FLOAT64), has_vals
    if not d.is_floating:
        is_u64 = d.id == dt.TypeId.UINT64
        # a UINT64 value compares through its sign-flipped bits
        vals = col.data.to(torch.int64) ^ bitutils.SIGN64 if is_u64 else _int_values(col.data, d)
        r = _segment_reduce(torch.where(m, vals, fill), gid_v, num, red, fill)
        r = torch.where(has_vals, r, 0)
        if is_u64:
            return u64_to_f64bits(torch.where(has_vals, r ^ bitutils.SIGN64, 0)), has_vals
        return i64_to_f64bits(r), has_vals
    inf = float("inf") if how == "min" else float("-inf")
    return _segment_reduce(torch.where(m, col.data, inf), gid_v, num, red, inf), has_vals


def _segment_reduce(x: torch.Tensor, gid: torch.Tensor, num: int, red: str, fill) -> torch.Tensor:
    out = torch.full((num + 1,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, gid.to(torch.int64), x, red)[:num]


def _build_enter_mask(js: JoinSpec, bt: Table) -> torch.Tensor:
    """Build-side liveness: a valid key AND ``build_filter`` (with its own
    null semantics), shared by both join lowerings."""
    enter = bt.column(js.build_key).valid_mask()
    if js.build_filter is not None:
        bf = js.build_filter.evaluate(bt)
        bfm = bf.data.to(torch.bool)
        if bf.validity is not None:
            bfm = bfm & bf.validity
        enter = enter & bfm
    return enter


def _check_payload(name: str, d) -> None:
    if not d.is_fixed_width or d.id == dt.TypeId.DECIMAL128:
        raise ValueError(f"join payload {name!r}: only plain fixed-width columns")


def _sorted_join(js: JoinSpec, cols: Dict[str, Column], bt: Table):
    """Sort-merge lowering for unbounded build keys: order the build side
    by (parked last, key), so entered rows form a sorted prefix at every
    key (a genuine INT64_MAX key cannot meet the parked sentinel), then
    binary-search every probe and verify raw equality and build-row
    liveness. Same (hit, joined, dups, bad_build) contract as
    ``_dense_join``; bad_build is always 0 (no declared domain)."""
    bk = bt.column(js.build_key)
    n_b = len(bk)
    enter = _build_enter_mask(js, bt)
    keys = _int_values(bk.data, bk.dtype)
    pcol = cols[js.probe_key]
    pk = _int_values(pcol.data, pcol.dtype)
    n_p = pk.shape[0]
    dev = pk.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    if n_b == 0:
        joined = {}
        for pname in js.payload:
            src = bt.column(pname)
            _check_payload(pname, src.dtype)
            joined[pname] = Column(src.dtype,
                                   data=torch.zeros((n_p,) + tuple(src.data.shape[1:]),
                                                    dtype=src.data.dtype, device=dev),
                                   validity=torch.zeros((n_p,), dtype=torch.bool, device=dev))
        return torch.zeros((n_p,), dtype=torch.bool, device=dev), joined, zero, zero

    # lexsort((keys, ~enter)): two stable sorts, the last key first
    order = torch.argsort(keys, stable=True)
    order = order[torch.argsort((~enter)[order].to(torch.int8), stable=True)]
    ks = keys[order]
    es = enter[order]
    sk = torch.where(es, ks, _INT64_MAX)
    dups = zero
    if js.how == "inner" and n_b > 1:
        dups = ((ks[1:] == ks[:-1]) & es[1:] & es[:-1]).to(torch.int64).sum()
    idx = torch.searchsorted(sk, pk, side="left").clamp(0, n_b - 1)
    src_rows = order[idx]
    hit = (ks[idx] == pk) & es[idx] & pcol.valid_mask()
    joined: Dict[str, Column] = {}
    for pname in js.payload:
        pc = bt.column(pname)
        _check_payload(pname, pc.dtype)
        data = torch.where(hit.view((-1,) + (1,) * (pc.data.dim() - 1)), pc.data[src_rows],
                           torch.zeros((), dtype=pc.data.dtype, device=dev))
        joined[pname] = Column(pc.dtype, data=data, validity=pc.valid_mask()[src_rows] & hit)
    return hit, joined, dups, zero


def _dense_join(js: JoinSpec, cols: Dict[str, Column], bt: Table):
    """One bounded-domain join: the (filtered) build side written into
    dense [num + 1] presence/payload maps (slot num takes every dropped
    row and is sliced off), the probe a row gather. Returns (hit [N]
    bool, {name: joined Column}, duplicate-key count, out-of-domain
    build-row count)."""
    num = js.num_keys
    bk = bt.column(js.build_key)
    enter = _build_enter_mask(js, bt)
    # the domain guard runs before the int32 narrowing: an int64 key
    # >= 2^31 must miss, not wrap into the domain. A build row inside the
    # filter but outside the domain is a mis-declaration, counted.
    in_dom_b = (bk.data >= 0) & (bk.data < num)
    bad_build = (enter & ~in_dom_b).to(torch.int64).sum()
    enter = enter & in_dom_b
    slot = torch.where(enter, bk.data.to(torch.int64), num)
    dev = slot.device

    present = torch.zeros((num + 1,), dtype=torch.bool, device=dev)
    present[slot] = True
    present = present[:num]
    dups = torch.zeros((), dtype=torch.int64, device=dev)
    if js.how == "inner":
        # duplicate build keys would collapse inner-join multiplicity:
        # always surfaced, with or without payload columns
        cnt = segment_rows(enter.to(torch.int64), slot, num + 1)[:num]
        dups = (cnt > 1).to(torch.int64).sum()

    pcol = cols[js.probe_key]
    indom = (pcol.data >= 0) & (pcol.data < num)
    pkc = pcol.data.clamp(0, num - 1).to(torch.int64)
    hit = present[pkc] & indom & pcol.valid_mask()

    joined: Dict[str, Column] = {}
    for pname in js.payload:
        src = bt.column(pname)
        _check_payload(pname, src.dtype)
        dense = torch.zeros((num + 1,), dtype=src.data.dtype, device=dev)
        dense[slot] = torch.where(enter, src.data, torch.zeros((), dtype=src.data.dtype,
                                                                device=dev))
        dvalid = torch.zeros((num + 1,), dtype=torch.bool, device=dev)
        dvalid[slot] = src.valid_mask() & enter
        joined[pname] = Column(src.dtype, data=dense[:num][pkc], validity=dvalid[:num][pkc] & hit)
    return hit, joined, dups, bad_build


def _wrap_result(data, valid, how: str) -> Column:
    if how in ("count", "count_all"):
        return Column(dt.INT64, data=data.to(torch.int64), validity=valid)
    if data.dtype == torch.int64:  # the exact paths give FLOAT64 bits
        return Column(dt.FLOAT64, data=data, validity=valid)
    # float32 aggregates store into the FLOAT64 bit format
    return Column(dt.FLOAT64, data=bitutils.float_store(data, dt.FLOAT64), validity=valid)


def compile_plan(plan: PlanSpec) -> CompiledPipeline:
    """Bind a plan once; reuse it across batches of the same schema."""
    return CompiledPipeline(plan)
