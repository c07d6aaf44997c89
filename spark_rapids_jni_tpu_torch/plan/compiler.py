"""Plan compiler: optimized logical plan -> executable stages (port of
the JAX package's ``plan/compiler.py``).

The Flare thesis (arxiv 1703.08219) applied to this engine: the hot
scan->join*->filter->project->aggregate region of a query should run as
ONE compiled program, not operator-at-a-time. The compiler walks the
optimized plan and, at every ``Aggregate``, tries to FUSE its input
chain into the same ``pipeline.CompiledPipeline`` the hand-built greens
use — star joins become ``JoinSpec``s (dense bounded-domain when the
``Join.bounded`` hint is set, sort-merge otherwise; a build side that is
itself a subplan is materialized at call time and joined sort-merge),
filters conjoin into the fused mask, projections become fused
projections, and bounded group-key domains are scanned host-side from
the bound tables exactly as the hand-built queries did. Everything the
fused grammar cannot express — fact-fact set ops, post-aggregate joins,
windows, sorts, unions — lowers to the tested ``ops/`` operators over
the (small) intermediate tables.

Estimates (Theseus, arxiv 2508.05029: the plan is where data-movement /
memory decisions belong): every stage carries ``rows``/``bytes``
estimates derived from schema width x bound-table cardinalities at
compile time. The whole-plan peak feeds ``memgov`` admission when the
governor is armed (``CompiledPlan.estimated_memory_bytes`` — the same
``memory_bytes=`` contract the serve scheduler's pre-admission uses),
and after every run the per-stage estimate-vs-actual pairs are recorded
(``last_report``; appended to the ``SRJTORCH_PLAN_REPORT`` JSONL when set)
so CI can gate estimate blowups.

What the port leaves out until the memory governor is ported (ROADMAP.md,
Open items, section 1, item 12b): ``CompiledPlan.__call__`` admits
nothing (the reference's ``memgov.admit``; ``memgov_admitted_bytes``
reads 0, as it does in the reference when the governor is not armed),
and ``compile_ir`` / ``lower_ir`` return the ``CompiledPlan`` itself, the
reference's result with out-of-core execution off (``plan/ooc.py``,
``maybe_out_of_core``).

Where a stage runs is where its tables are: the plan binds to the tables
it is given, and a plan over card tables launches the ported kernels of
the ops it lowers onto (B1 for ``ppart``, B4 for the operator tier's
single-key joins, B3 for a bounded group-by of FLOAT32 values), while a
plan over CPU tables runs their plain versions.

Engine dtype contract (mirrored by ``nodes.infer_schema``): aggregate
outputs materialize as INT64 (counts) / FLOAT64 (everything else) on
BOTH tiers — the operator tier normalizes to the fused pipeline's
``_wrap_result`` convention so a plan's schema never depends on which
tier a stage landed on.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from ..utils import knobs, metrics
from .exprs import PExpr, PlanError, conjoin, is_col, is_null_lit
from .nodes import (
    Aggregate,
    Exchange,
    Filter,
    Join,
    Limit,
    Node,
    Project,
    Scan,
    Sort,
    UnionAll,
    Window,
    infer_schema,
)
from .rewrites import rewrite
from .stats.model import calibration_factor


def _durable(name: str):
    """Registry-direct counter (always-on, like serve's shed accounting)
    so the compiler tier can be metrics-asserted without arming the
    event log."""
    return metrics.registry().counter(name)

__all__ = ["CompiledPlan", "compile_ir", "lower_ir"]

Schema = Dict[str, DType]

_FUSED_AGGS = ("sum", "count", "count_all", "min", "max", "mean")
_FILTER_SELECTIVITY = 0.5  # conservative: only UNDERestimates are gated
_MAX_DENSE_GROUPS = 1 << 22


def _width(schema: Schema) -> int:
    total = 0
    for d in schema.values():
        # +1: the per-row validity lane. The archived r6 estimate-vs-
        # actual reports (artifacts/plan_compile.jsonl) showed the
        # value-only width UNDERestimating every nullable narrow table
        # by up to 1.25x (a lone INT32 column is 5 bytes/row with its
        # bool mask, not 4) — the one systematic drift in the gated
        # direction, and what let premerge tighten the blowup gate to 3x
        total += (d.size_bytes if d.is_fixed_width else 16) + 1
    return max(total, 1)


def _column_nbytes(c: Column) -> int:
    total = sum(int(x.nbytes) for x in (c.data, c.validity, c.offsets, c.chars)
                if x is not None)
    if c.child is not None:
        total += _column_nbytes(c.child)
    for k in c.children or ():
        total += _column_nbytes(k)
    return total


def _table_nbytes(t: Table) -> int:
    """The bytes of every buffer of the table's columns (the reference
    sums its pytree leaves: the same buffers)."""
    return sum(_column_nbytes(c) for c in t.columns)


def _eval_expr(e: PExpr, table: Table, want: DType) -> Column:
    """Evaluate a lowered plan expression, broadcasting a scalar result
    (bare literal projection) to the table's row count and pinning the
    inferred dtype for typed null literals."""
    n_rows = table.num_rows
    if is_null_lit(e):
        # typed SQL NULL: materialize at the DECLARED dtype — the
        # runtime literal tier evaluates NULL as INT32 lanes, which
        # would silently contradict the inferred schema for FLOAT64
        # (or any non-int) rolled keys in a grouping-set union
        if not want.is_fixed_width:
            raise PlanError(f"cannot materialize a NULL literal as {want!r}")
        dev = table.columns[0].device
        shape = (n_rows, 4) if want.id == TypeId.DECIMAL128 else (n_rows,)
        return Column(want, data=torch.zeros(shape, dtype=want.torch_dtype, device=dev),
                      validity=torch.zeros((n_rows,), dtype=torch.bool, device=dev))
    c = e.lower().evaluate(table)
    n = table.num_rows
    if c.data.ndim == 0:
        data = c.data.reshape(1).expand(n).contiguous()
        v = (None if c.validity is None
             else c.validity.reshape(1).expand(n).contiguous())
        c = Column(c.dtype, data=data, validity=v)
    elif len(c) != n:
        raise PlanError(f"projection produced {len(c)} rows for {n}")
    if c.dtype.id != want.id and c.dtype.is_integral and want.is_integral:
        c = Column(want, data=c.data.to(want.torch_dtype), validity=c.validity)
    elif c.dtype.id != want.id and want.id == TypeId.BOOL8:
        c = Column(dt.BOOL8, data=c.data.to(torch.uint8), validity=c.validity)
    return c


def _normalize_agg_column(col: Column, how: str) -> Column:
    """Bring an operator-tier aggregate column onto the fused tier's
    materialization contract (counts INT64, everything else FLOAT64
    bit-lanes) so schema inference holds regardless of tier."""
    if how in ("count", "count_all", "nunique"):
        return col
    if col.dtype.id == TypeId.FLOAT64:
        return col
    from ..ops import bitutils
    from ..ops.f64acc import i64_to_f64bits

    # the int64 -> float64 bits conversion is the exact accumulator's
    # correctly rounded one, as in the reference; both the CPU and the
    # card compute float64, so a FLOAT32 value widens exactly
    if col.dtype.is_integral:
        return Column(dt.FLOAT64, data=i64_to_f64bits(col.data.to(torch.int64)),
                      validity=col.validity)
    if col.dtype.id == TypeId.FLOAT32:
        return Column(dt.FLOAT64, data=bitutils.float_store(col.data, dt.FLOAT64),
                      validity=col.validity)
    raise PlanError(f"cannot normalize {how} over {col.dtype!r}")


class _RunContext:
    """One execution of a compiled plan: node-result memoization (shared
    CTE subtrees run once) + per-stage actual byte accounting. Actuals
    live HERE, not on the shared _Exec objects — one CompiledPlan may
    be running on several serve slots at once, and per-run state on the
    stage objects would tear the estimate-vs-actual report."""

    __slots__ = ("tables", "cache", "actuals", "subcache")

    def __init__(self, tables: Dict[str, Table], subcache=None):
        self.tables = tables
        self.cache: Dict[int, Table] = {}
        self.actuals: Dict[int, Tuple[int, int]] = {}  # exec id -> (rows, bytes)
        # the cross-run subresult cache, or None
        # when caching is off — stages annotated with a ``cache_key``
        # consult it before recomputing
        self.subcache = subcache


class _Exec:
    """One lowered stage: knows its schema, estimates, and inputs."""

    kind = "?"

    # set once at annotation time (before any
    # concurrent run) on stages whose subtree result is cacheable; the
    # key pins (parameterized structure, literal bindings, table
    # generations), so a stale entry is unreachable by construction
    cache_key = None

    def __init__(self, schema: Schema, est_rows: int, inputs: List["_Exec"]):
        self.schema = schema
        self.est_rows = max(int(est_rows), 1)
        self.inputs = inputs
        # byte estimates carry the per-kind factor
        # learned from archived estimate-vs-actual reports (neutral 1.0
        # on a fresh checkout, clamped to [0.5, 2x]); the floor keeps
        # the verifier's est_bytes >= est_rows invariant under any factor
        self.est_bytes = max(self.est_rows,
                             int(self.est_rows * _width(schema)
                                 * calibration_factor(self.kind)))

    def run(self, ctx: _RunContext) -> Table:
        key = id(self)
        if key in ctx.cache:
            return ctx.cache[key]
        if ctx.subcache is not None and self.cache_key is not None:
            out = ctx.subcache.lookup_or_compute(
                self.cache_key, lambda: self._run(ctx))
        else:
            out = self._run(ctx)
        ctx.actuals[key] = (out.num_rows, _table_nbytes(out))
        ctx.cache[key] = out
        return out

    def _run(self, ctx: _RunContext) -> Table:
        raise NotImplementedError

    def working_set_est(self) -> int:
        return self.est_bytes + sum(i.est_bytes for i in self.inputs)

    def working_set_actual(self, actuals: Dict[int, Tuple[int, int]]) -> Optional[int]:
        mine = actuals.get(id(self))
        if mine is None:
            return None
        parts = [mine[1]]
        for i in self.inputs:
            got = actuals.get(id(i))
            if got is not None:
                parts.append(got[1])
        return sum(parts)


class _ScanExec(_Exec):
    kind = "scan"

    def __init__(self, node: Scan, schema: Schema, tables):
        super().__init__(schema, tables[node.table].num_rows, [])
        self.table = node.table
        self.columns = list(schema.keys())

    def _run(self, ctx):
        return ctx.tables[self.table].select(self.columns)


class _FilterExec(_Exec):
    kind = "filter"

    def __init__(self, node: Filter, schema: Schema, child: _Exec,
                 est_rows: Optional[int] = None):
        if est_rows is None:
            est_rows = math.ceil(child.est_rows * _FILTER_SELECTIVITY)
        super().__init__(schema, min(est_rows, child.est_rows), [child])
        self.pred = node.predicate

    def _run(self, ctx):
        from ..ops import copying

        t = self.inputs[0].run(ctx)
        mask = self.pred.lower().evaluate(t)
        return copying.apply_boolean_mask(t, mask)


class _ProjectExec(_Exec):
    kind = "project"

    def __init__(self, node: Project, schema: Schema, child: _Exec):
        super().__init__(schema, child.est_rows, [child])
        self.exprs = node.exprs

    def _run(self, ctx):
        t = self.inputs[0].run(ctx)
        cols = [_eval_expr(e, t, self.schema[name]) for name, e in self.exprs]
        return Table(cols, [name for name, _ in self.exprs])


class _JoinExec(_Exec):
    kind = "join"

    def __init__(self, node: Join, schema: Schema, left: _Exec, right: _Exec,
                 est_rows: Optional[int] = None):
        if est_rows is None:
            est_rows = (left.est_rows + right.est_rows if node.how == "full"
                        else left.est_rows)
        super().__init__(schema, est_rows, [left, right])
        self.on = node.on
        self.how = node.how

    def _run(self, ctx):
        from ..ops import join as join_ops

        left = self.inputs[0].run(ctx)
        right = self.inputs[1].run(ctx)
        lnames = [l for l, _ in self.on]
        rename = {r: l for l, r in self.on}
        right = Table(list(right.columns),
                      [rename.get(n, n) for n in right.names])
        fn = {
            "inner": join_ops.inner_join,
            "left": join_ops.left_join,
            "full": join_ops.full_join,
            "semi": join_ops.left_semi_join,
            "anti": join_ops.left_anti_join,
        }[self.how]
        out = fn(left, right, on=lnames)
        return out.select(list(self.schema.keys()))


class _ExchangeExec(_Exec):
    """Hash-repartition across the bound exchange fabric.
    Unbound — no ``plan.distribute.exchange_context`` in scope — or at
    ``world == 1`` this stage is the identity, so one compiled plan
    serves both the single-host oracle and every rank of the
    distributed run. With a cluster + shard catalog bound, the stage
    installs its child subtree as the dead-rank lineage reproducer
    right before moving rows: recovery replays exactly the lowered
    code that produced the lost input."""

    kind = "exchange"

    def __init__(self, node: Exchange, schema: Schema, child: _Exec):
        super().__init__(schema, child.est_rows, [child])
        self.keys = node.keys
        self.world = node.world

    def _run(self, ctx):
        from .distribute import current_binding

        t = self.inputs[0].run(ctx)
        binding = current_binding()
        if binding is None or self.world <= 1:
            return t
        if binding.world != self.world:
            raise PlanError(
                f"exchange stage compiled for world {self.world} bound to "
                f"a {binding.world}-rank fabric")
        if binding.cluster is not None and binding.shard_tables is not None:
            child = self.inputs[0]
            shards = binding.shard_tables
            binding.cluster.set_lineage(
                lambda r: child.run(_RunContext(shards(r))))
        return binding.exchange.exchange_table(
            t, list(self.keys), binding.peers,
            epoch=binding.stage_epoch(id(self)), cluster=binding.cluster,
        )


class _AggExec(_Exec):
    """Operator-tier grouped/global aggregation (the general fallback:
    arbitrary key dtypes, var/std/nunique, DISTINCT)."""

    kind = "aggregate"

    def __init__(self, node: Aggregate, schema: Schema, child: _Exec,
                 est_rows: Optional[int] = None):
        super().__init__(schema, child.est_rows if est_rows is None else est_rows,
                         [child])
        self.keys = node.keys
        self.aggs = node.aggs

    def _run(self, ctx):
        from ..ops.aggregate import groupby_aggregate

        t = self.inputs[0].run(ctx)
        n = t.num_rows
        if not self.keys and n == 0:
            # SQL global aggregates yield ONE row on empty input (the
            # fused tier does; the sort-based kernel yields zero groups)
            cols, names = [], []
            dev = t.columns[0].device
            for a in self.aggs:
                if a.how in ("count", "count_all", "nunique"):
                    cols.append(Column(dt.INT64, data=torch.zeros(
                        (1,), dtype=torch.int64, device=dev)))
                else:
                    cols.append(Column(
                        dt.FLOAT64, data=torch.zeros((1,), dtype=torch.int64, device=dev),
                        validity=torch.zeros((1,), dtype=torch.bool, device=dev),
                    ))
                names.append(a.name)
            return Table(cols, names)
        if self.keys:
            keys_tbl = t.select(list(self.keys))
        else:
            keys_tbl = Table(
                [Column(dt.INT32, data=torch.zeros(
                    (n,), dtype=torch.int32, device=t.columns[0].device))], ["__g"]
            )
        spec = []
        for a in self.aggs:
            src = a.source if a.source is not None else (
                self.keys[0] if self.keys else t.names[0]
            )
            spec.append((src, a.how, a.name))
        values = t
        agg = groupby_aggregate(keys_tbl, values, [(s, h) for s, h, _ in spec])
        # groupby_aggregate names outputs {src}_{how} in order after the
        # keys; rebind positionally to the AggSpec names and normalize
        # onto the fused materialization contract
        nk = keys_tbl.num_columns
        out_cols: List[Column] = []
        out_names: List[str] = []
        if self.keys:
            for i, k in enumerate(self.keys):
                out_cols.append(agg.column(i))
                out_names.append(k)
        for j, (_, how, name) in enumerate(spec):
            out_cols.append(_normalize_agg_column(agg.column(nk + j), how))
            out_names.append(name)
        return Table(out_cols, out_names)


class _FusedAggExec(_Exec):
    """The fused tier: one ``CompiledPipeline`` dispatch for the whole
    join*->filter->project->aggregate stage. ``builds`` maps build name
    -> either a compile-time Table (direct dim build) or an _Exec run at
    call time (materialized subplan build)."""

    kind = "fused_aggregate"

    def __init__(self, schema: Schema, pipeline, fact: _Exec,
                 builds: Dict[str, object], est_rows: int,
                 out_names: List[str]):
        build_execs = [b for b in builds.values() if isinstance(b, _Exec)]
        super().__init__(schema, est_rows, [fact] + build_execs)
        self.pipeline = pipeline
        self.builds = builds
        self.out_names = out_names
        self._static_build_bytes = sum(
            _table_nbytes(b) for b in builds.values() if isinstance(b, Table)
        )
        self.est_bytes += self._static_build_bytes

    def _run(self, ctx):
        fact = self.inputs[0].run(ctx)
        builds = {}
        for name, b in self.builds.items():
            builds[name] = b.run(ctx) if isinstance(b, _Exec) else b
        out = self.pipeline(fact, builds)
        _durable("plan.fused_dispatches").inc()
        return Table(list(out.columns), self.out_names)


class _WindowExec(_Exec):
    kind = "window"

    def __init__(self, node: Window, schema: Schema, child: _Exec):
        super().__init__(schema, child.est_rows, [child])
        self.node = node

    def _run(self, ctx):
        from ..ops.window import window_aggregate

        t = self.inputs[0].run(ctx)
        return window_aggregate(
            t, list(self.node.partition_by), list(self.node.order_by),
            list(self.node.aggs),
        )


class _SortExec(_Exec):
    kind = "sort"

    def __init__(self, node: Sort, schema: Schema, child: _Exec):
        super().__init__(schema, child.est_rows, [child])
        self.keys = node.keys

    def _run(self, ctx):
        from ..ops.sort import sort_by_key

        t = self.inputs[0].run(ctx)
        keys = Table([t.column(c) for c, _ in self.keys],
                     [f"k{i}" for i in range(len(self.keys))])
        return sort_by_key(t, keys, ascending=[asc for _, asc in self.keys])


class _LimitExec(_Exec):
    kind = "limit"

    def __init__(self, node: Limit, schema: Schema, child: _Exec):
        super().__init__(schema, min(child.est_rows, node.n), [child])
        self.n = node.n

    def _run(self, ctx):
        from ..ops import copying

        t = self.inputs[0].run(ctx)
        return copying.slice_table(t, 0, min(self.n, t.num_rows))


class _UnionExec(_Exec):
    kind = "union_all"

    def __init__(self, schema: Schema, children: List[_Exec]):
        super().__init__(schema, sum(c.est_rows for c in children), children)

    def _run(self, ctx):
        from ..ops import copying

        names = list(self.schema.keys())
        parts = [c.run(ctx).select(names) for c in self.inputs]
        return copying.concatenate(parts)


# ---------------------------------------------------------------------------
# fused-stage detection
# ---------------------------------------------------------------------------


class _Bail(Exception):
    """Internal: this aggregate does not fit the fused grammar — fall
    back to the operator tier (never an error)."""


def _int_domain(col: Column) -> Optional[int]:
    """[0, num) bounded domain of an integer column (host scan at bind
    time, the same sync the hand-built queries pay), or None when the
    column is empty/negative/non-integral. One ``aminmax`` and one read
    back: a single device sync per column."""
    if not col.dtype.is_integral:
        return None
    if len(col) == 0:
        return 1
    lo, hi = torch.stack(torch.aminmax(col.data)).tolist()
    if lo < 0:
        return None
    return int(hi) + 1


class _Fuser:
    """Pattern-match one Aggregate's input chain onto a PlanSpec."""

    def __init__(self, lowerer: "_Lowerer", agg: Aggregate):
        self.low = lowerer
        self.agg = agg
        self.joins: List[Join] = []
        self.filters: List[PExpr] = []
        self.project: Optional[Project] = None
        self.fact: Optional[Scan] = None

    def _walk(self, n: Node, under_join: bool) -> None:
        if isinstance(n, Project) and all(
            is_col(e) == name for name, e in n.exprs
        ):
            # passthrough-only narrowing (pruning inserts these): a
            # no-op for the fused working schema at any depth
            self._walk(n.input, under_join)
        elif isinstance(n, Project) and not under_join:
            if self.project is not None:
                raise _Bail("stacked projects")
            self.project = n
            self._walk(n.input, under_join)
        elif isinstance(n, Filter):
            self.filters.append(n.predicate)
            self._walk(n.input, True)
        elif isinstance(n, Join):
            if n.how not in ("inner", "semi", "anti") or len(n.on) != 1:
                raise _Bail("join shape")
            self._walk(n.left, True)
            self.joins.append(n)
        elif isinstance(n, Scan):
            if self.fact is not None:
                raise _Bail("two facts")
            self.fact = n
        else:
            raise _Bail(type(n).__name__)

    def try_build(self) -> Optional[_FusedAggExec]:
        from ..pipeline import Agg as PAgg
        from ..pipeline import GroupKey, JoinSpec, PlanSpec, compile_plan

        agg = self.agg
        if agg.grouping_sets is not None or not agg.aggs:
            return None
        if any(a.how not in _FUSED_AGGS for a in agg.aggs):
            return None
        try:
            self._walk(agg.input, False)
        except _Bail:
            return None
        if self.fact is None:
            return None
        fact_schema = self.low.schema_of(self.fact)

        # the working schema the pipeline sees: fact columns + payloads
        work: Dict[str, str] = {c: self.fact.table for c in fact_schema}
        specs: List[JoinSpec] = []
        builds: Dict[str, object] = {}
        try:
            for idx, j in enumerate(self.joins):
                spec, bname, build = self._build_side(j, work, idx)
                if bname in builds:
                    return None  # duplicate build name (self-join w/o alias)
                specs.append(spec)
                builds[bname] = build
                if j.how == "inner":
                    for pname in spec.payload:
                        work[pname] = bname
        except _Bail:
            return None

        # projections: passthrough names stay; computed exprs fuse
        proj_entries: List[Tuple[str, object]] = []
        visible = set(work)
        key_source: Dict[str, str] = {}
        if self.project is not None:
            visible = set()
            for name, e in self.project.exprs:
                src = is_col(e)
                if src is not None and src == name:
                    visible.add(name)
                    key_source[name] = name
                else:
                    proj_entries.append((name, e))
                    visible.add(name)
        else:
            key_source = {c: c for c in work}

        # group keys: un-projected INT32 columns with scannable domains
        gks: List[GroupKey] = []
        domain_product = 1
        for k in agg.keys:
            src = key_source.get(k)
            if src is None or src not in work:
                return None
            owner = work[src]
            src_col = self._owner_column(owner, src, builds)
            if src_col is None or src_col.dtype.id != TypeId.INT32:
                return None
            num = _int_domain(src_col)
            if num is None:
                return None
            domain_product *= num
            if domain_product > _MAX_DENSE_GROUPS:
                return None
            gks.append(GroupKey(k, num))

        # aggregate sources must be visible post-project
        if not fact_schema:
            return None
        paggs = []
        for a in agg.aggs:
            src = a.source
            if a.how == "count_all":
                src = next(iter(fact_schema))
            if src not in visible:
                return None
            paggs.append(PAgg(src, a.how, a.name))

        filt = None
        if self.filters:
            filt = conjoin(self.filters).lower()
        spec = PlanSpec(
            joins=tuple(specs),
            filter=filt,
            project=tuple((n, e.lower()) for n, e in proj_entries),
            group_by=tuple(gks),
            aggregates=tuple(paggs),
        )
        out_schema = self.low.schema_of(agg)
        out_names = list(out_schema.keys())
        est_rows = min(self.low.exec_of(self.fact).est_rows,
                       domain_product if gks else 1)
        if self.low.est is not None and gks:
            # sketch ndv product is usually tighter than the dense
            # key-domain product (domains count holes, ndv does not)
            est_rows = min(est_rows, self.low.est.agg_rows(
                self.low.exec_of(self.fact).est_rows, agg.keys))
        pipeline = compile_plan(spec)
        fact_exec = self.low.exec_of(self.fact)
        _durable("plan.fused_stages").inc()
        return _FusedAggExec(out_schema, pipeline, fact_exec, builds,
                             est_rows, out_names)

    def _owner_column(self, owner: str, name: str, builds) -> Optional[Column]:
        """The bind-time column backing a group key: a fact column or a
        DIRECT build's payload column (materialized builds have no
        bind-time data to scan)."""
        if owner == self.fact.table:
            return self.low.tables[self.fact.table].column(name)
        b = builds.get(owner)
        if isinstance(b, Table) and name in b.names:
            return b.column(name)
        return None

    def _build_side(self, j: Join, work, idx: int) -> Tuple[object, str, object]:
        """Lower one join's right side: a Scan (+Filter) reduces to a
        compile-time build table + fused build_filter; anything else
        materializes its subplan at call time (sort-merge)."""
        from ..pipeline import JoinSpec

        probe, bkey = j.on[0]
        if probe not in work:
            raise _Bail("probe key not in working schema")
        right = j.right
        rschema = self.low.schema_of(right)
        payload = tuple(n for n in rschema if n != bkey) if j.how == "inner" else ()
        for pname in payload:
            d = rschema[pname]
            if not d.is_fixed_width or d.id == TypeId.DECIMAL128:
                raise _Bail("payload dtype")

        pred = None
        cur = right
        if isinstance(cur, Project) and all(
            is_col(e) == name for name, e in cur.exprs
        ):
            cur = cur.input  # pruning's narrowing wrapper
        if isinstance(cur, Filter):
            pred = cur.predicate
            cur = cur.input
        if isinstance(cur, Scan):
            bname = cur.key
            bt = self.low.tables[cur.table]
            needed = [bkey] + [p for p in payload if p != bkey]
            if pred is not None:
                needed += [r for r in pred.refs() if r not in needed]
            for c in needed:
                if c not in bt.names:
                    raise _Bail("build column missing")
            build_tbl = bt.select(needed)
            num_keys = None
            if j.bounded:
                num_keys = _int_domain(build_tbl.column(bkey))
                if num_keys is None:
                    raise _Bail("unbounded build key domain")
            spec = JoinSpec(
                build=bname, probe_key=probe, build_key=bkey,
                num_keys=num_keys, payload=payload, how=j.how,
                build_filter=None if pred is None else pred.lower(),
            )
            return spec, bname, build_tbl
        # materialized build: run the subplan, join sort-merge
        bexec = self.low.lower(right)
        bname = f"__build_{idx}_{bkey}"
        spec = JoinSpec(build=bname, probe_key=probe, build_key=bkey,
                        num_keys=None, payload=payload, how=j.how)
        return spec, bname, bexec


# ---------------------------------------------------------------------------
# the lowerer
# ---------------------------------------------------------------------------


class _Lowerer:
    def __init__(self, tables: Dict[str, Table], catalog: Dict[str, Schema],
                 est=None):
        self.tables = tables
        self.catalog = catalog
        # sketch-backed stats.Estimator, or None —
        # stages then keep the original hand-tuned row heuristics
        self.est = est
        self._schemas: dict = {}
        self._execs: Dict[int, _Exec] = {}
        self.all_execs: List[_Exec] = []

    def schema_of(self, node: Node) -> Schema:
        return infer_schema(node, self.catalog, self._schemas)

    def exec_of(self, node: Node) -> _Exec:
        return self.lower(node)

    def lower(self, node: Node) -> _Exec:
        key = id(node)
        if key in self._execs:
            return self._execs[key]
        ex = self._lower(node)
        self._execs[key] = ex
        if ex not in self.all_execs:
            self.all_execs.append(ex)
        return ex

    def _lower(self, node: Node) -> _Exec:
        schema = self.schema_of(node)
        if isinstance(node, Scan):
            return _ScanExec(node, schema, self.tables)
        if isinstance(node, Filter):
            child = self.lower(node.input)
            rows = (self.est.filter_rows(child.est_rows, node.predicate)
                    if self.est is not None else None)
            return _FilterExec(node, schema, child, est_rows=rows)
        if isinstance(node, Project):
            return _ProjectExec(node, schema, self.lower(node.input))
        if isinstance(node, Join):
            left = self.lower(node.left)
            right = self.lower(node.right)
            rows = (self.est.join_rows(node.how, left.est_rows,
                                       right.est_rows, node.on)
                    if self.est is not None else None)
            return _JoinExec(node, schema, left, right, est_rows=rows)
        if isinstance(node, Aggregate):
            fused = _Fuser(self, node).try_build()
            if fused is not None:
                self.all_execs.append(fused)
                return fused
            _durable("plan.ops_stages").inc()
            child = self.lower(node.input)
            rows = (self.est.agg_rows(child.est_rows, node.keys)
                    if self.est is not None else None)
            return _AggExec(node, schema, child, est_rows=rows)
        if isinstance(node, Exchange):
            return _ExchangeExec(node, schema, self.lower(node.input))
        if isinstance(node, Window):
            return _WindowExec(node, schema, self.lower(node.input))
        if isinstance(node, Sort):
            return _SortExec(node, schema, self.lower(node.input))
        if isinstance(node, Limit):
            return _LimitExec(node, schema, self.lower(node.input))
        if isinstance(node, UnionAll):
            return _UnionExec(schema, [self.lower(b) for b in node.branches])
        raise PlanError(
            f"cannot lower {type(node).__name__}: sugar nodes must be "
            "rewritten away before compilation")


# ---------------------------------------------------------------------------
# the public compile surface
# ---------------------------------------------------------------------------


def _count_nodes(node: Node) -> int:
    seen = set()

    def visit(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for i in n.inputs():
            visit(i)

    visit(node)
    return len(seen)


class CompiledPlan:
    """A bound, optimized, lowered plan. Calling it runs the query over
    the bound tables and returns the result Table. Carries the
    plan-derived ``estimated_memory_bytes`` the memory governor and the
    serve scheduler consume, and a ``last_report`` with per-stage
    estimate-vs-actual bytes after each run."""

    def __init__(self, name: str, root: _Exec, tables: Dict[str, Table],
                 stages: List[_Exec], raw_nodes: int, opt_nodes: int,
                 rewrites_fired: Dict[str, int], opt_plan: Node,
                 obligations: Optional[list] = None,
                 node_execs: Optional[Dict[int, _Exec]] = None,
                 modeled: Optional[dict] = None):
        self.name = name
        self.schema = dict(root.schema)
        self.optimized = opt_plan
        # translation-validation records from the rewrite pass, carried
        # for srjt-plancheck (plan.verifier.verify_obligations)
        self.obligations = list(obligations or ())
        self._root = root
        self._tables = tables
        self._stages = stages
        self._raw_nodes = raw_nodes
        self._opt_nodes = opt_nodes
        self._rewrites = dict(rewrites_fired)
        # id(optimized node) -> lowered stage,
        # so the cache layer can annotate cacheable subtrees with their
        # keys; and the cross-run subresult cache the run context
        # consults (None = caching off). Both are set once before the
        # plan is ever run concurrently.
        self._node_execs = dict(node_execs or {})
        self.subcache = None
        # {"author": cost, "chosen": cost,
        # "joins": n} when the search ran — the premerge modeled-cost
        # gate's source; None on the cache-hit / CBO-off paths
        self.modeled = dict(modeled) if modeled else None
        self.estimated_memory_bytes = max(
            s.working_set_est() for s in stages
        )
        self.last_report: Optional[dict] = None
        _durable("plan.compiles").inc()

    def exec_for(self, node: Node) -> Optional[_Exec]:
        """The lowered stage an optimized-plan node became, when it
        lowered to a stage of its own (fused pipelines consume their
        inner nodes)."""
        return self._node_execs.get(id(node))

    @property
    def stages(self) -> list:
        """The lowered stage DAG (read-only view) — what
        ``plan.verifier.verify_estimates`` walks for the per-stage
        ``memory_bytes`` presence/monotonicity checks."""
        return list(self._stages)

    @property
    def rewrites_fired(self) -> Dict[str, int]:
        return dict(self._rewrites)

    def __call__(self) -> Table:
        # the memory governor's admission (the reference's memgov.admit)
        # waits for its port: nothing is admitted, as in the reference
        # with the governor unarmed
        _durable("plan.executions").inc()
        admitted = 0
        ctx = _RunContext(self._tables, subcache=self.subcache)
        out = self._root.run(ctx)
        # the report is built from THIS run's context and published as
        # one fresh dict — concurrent runs each see a coherent report
        # (last writer wins on the attribute)
        self.last_report = self._report(admitted, ctx.actuals)
        path = knobs.get_str("SRJTORCH_PLAN_REPORT")
        if path:
            with open(path, "a") as f:
                f.write(json.dumps(self.last_report) + "\n")
        return out

    def _report(self, admitted: int, actuals: Dict[int, Tuple[int, int]]) -> dict:
        stages = []
        est_peak = self.estimated_memory_bytes
        actual_peak = 0
        for s in self._stages:
            ws = s.working_set_actual(actuals)
            if ws is not None:
                actual_peak = max(actual_peak, ws)
            mine = actuals.get(id(s))
            stages.append({
                "kind": s.kind,
                "est_rows": s.est_rows,
                "est_bytes": s.est_bytes,
                "actual_rows": None if mine is None else mine[0],
                "actual_bytes": None if mine is None else mine[1],
            })
        return {
            "query": self.name,
            "nodes_raw": self._raw_nodes,
            "nodes_optimized": self._opt_nodes,
            "rewrites": self._rewrites,
            "stages": stages,
            "fused_stages": sum(1 for s in self._stages
                                if s.kind == "fused_aggregate"),
            "est_peak_bytes": est_peak,
            "actual_peak_bytes": actual_peak,
            "peak_blowup": (actual_peak / est_peak) if est_peak else None,
            "memgov_admitted_bytes": admitted,
            "modeled_cost_author": (
                None if self.modeled is None else self.modeled["author"]),
            "modeled_cost_chosen": (
                None if self.modeled is None else self.modeled["chosen"]),
            "join_count": (
                None if self.modeled is None else self.modeled["joins"]),
        }


def compile_ir(plan: Node, tables: Dict[str, Table],
               name: str = "plan") -> CompiledPlan:
    """Validate, rewrite, and lower a logical plan against bound tables.
    The returned ``CompiledPlan`` is a zero-argument callable producing
    the result Table; submit it to ``serve`` directly (the scheduler
    derives ``memory_bytes=`` from its stage estimates)."""
    catalog = {t: {n: c.dtype for n, c in zip(tbl.names, tbl.columns)}
               for t, tbl in tables.items()}
    raw_nodes = _count_nodes(plan)
    infer_schema(plan, catalog)
    res = rewrite(plan, catalog)
    # the cost-based search runs AFTER the default
    # rewrite (so rule-idempotence of the default set is undisturbed);
    # every reorder / build-side / strategy fire lands in the same
    # obligation ledger the verifier discharges
    from . import optimizer as _cbo
    from . import stats as _stats

    opt_plan, fired, obligations = res.plan, dict(res.fired), list(res.obligations)
    modeled = None
    est = _stats.make_estimator(tables)
    if _cbo.enabled() and est is not None:
        cres = _cbo.optimize(opt_plan, catalog, tables, est=est)
        opt_plan = cres.plan
        for rule, n in cres.fired.items():
            fired[rule] = fired.get(rule, 0) + n
        obligations.extend(cres.obligations)
        modeled = {"author": cres.author_cost, "chosen": cres.chosen_cost,
                   "joins": cres.join_count}
    for rule, n in fired.items():
        _durable(f"plan.rewrites.{rule}").inc(n)
    low = _Lowerer(tables, catalog, est=est)
    root = low.lower(opt_plan)
    cp = CompiledPlan(name, root, tables, low.all_execs, raw_nodes,
                      _count_nodes(opt_plan), fired, opt_plan,
                      obligations=obligations, node_execs=low._execs,
                      modeled=modeled)
    # the reference's out-of-core hook (plan/ooc.py, maybe_out_of_core)
    # waits for the memory governor's port; with out-of-core off it
    # returns cp itself
    return cp


def lower_ir(opt_plan: Node, tables: Dict[str, Table], name: str = "plan", *,
             raw_nodes: Optional[int] = None,
             rewrites_fired: Optional[Dict[str, int]] = None,
             obligations: Optional[list] = None) -> CompiledPlan:
    """Lower an ALREADY-OPTIMIZED plan, skipping the rewrite pass — the
    plan-cache hit path: the cached entry's
    optimized structure was verifier-green at insert, so binding fresh
    literals only needs schema inference + lowering. The caller passes
    through the cached entry's rewrite tallies and obligation ledger so
    the compiled artifact stays auditable (``verify_obligations`` still
    discharges the ORIGINAL firings — a literal rebind is
    structure-preserving by construction)."""
    catalog = {t: {n: c.dtype for n, c in zip(tbl.names, tbl.columns)}
               for t, tbl in tables.items()}
    infer_schema(opt_plan, catalog)
    opt_nodes = _count_nodes(opt_plan)
    # the cache-hit path skips the SEARCH (the
    # cached structure already won it) but keeps sketch-driven row
    # estimates — admission numbers must not depend on cache hit/miss
    from . import stats as _stats

    low = _Lowerer(tables, catalog, est=_stats.make_estimator(tables))
    root = low.lower(opt_plan)
    _durable("plan.lower_only").inc()
    cp = CompiledPlan(name, root, tables, low.all_execs,
                      raw_nodes if raw_nodes is not None else opt_nodes,
                      opt_nodes, dict(rewrites_fired or {}), opt_plan,
                      obligations=obligations, node_execs=low._execs)
    # out-of-core re-selection per binding waits for the memory
    # governor's port, as in compile_ir
    return cp
