"""Logical-plan IR nodes + schema inference (port of the JAX package's
``plan/nodes.py``: the same frozen dataclasses and fields).

A small relational algebra over named Tables — ``Scan / Filter /
Project / Join / Aggregate / Window / Sort / Limit / UnionAll`` — plus
the SUGAR nodes the rewrite framework (rewrites.py) eliminates before
lowering: ``SetOp`` (INTERSECT/EXCEPT), ``Exists`` (EXISTS/NOT EXISTS),
``Having``, ``CorrelatedAggFilter`` (the correlated-scalar-subquery
family), and grouping sets on ``Aggregate`` (ROLLUP). These are exactly
the constructs QUERIES.md documents as "standard executor rewrites":
the IR keeps them first-class so a query transliterates from its SQL,
and the optimizer — not the query author — performs the expansion Spark
itself would.

Every node infers its output schema (ordered ``{name: DType}``) under a
catalog of table schemas, validating references as it goes; inference
follows the ENGINE's materialization contract, not textbook SQL:

- aggregate outputs: ``count``/``count_all`` -> INT64, the variance
  family -> FLOAT64, and ``sum``/``mean``/``min``/``max`` over numerics
  -> FLOAT64 (the fused pipeline materializes every non-count aggregate
  into FLOAT64 bit-lanes — ``pipeline._wrap_result`` — and the
  operator-tier lowering normalizes to the same contract so a plan's
  dtype never depends on which tier it landed on);
- window outputs mirror ``ops/window.py`` exactly (rank family INT32,
  count INT64, int cumsum INT64, lag/lead/min/max source-typed);
- join outputs: probe/left schema + the build/right non-key columns.

Plans are TREES by construction but DAGs by sharing: reusing a node
object (a CTE referenced twice, q1's customer_total_return) is the
sharing mechanism — the compiler memoizes execution per node identity.

``structure(node)`` renders a plan as canonical nested tuples; the
rewrite-idempotence and bit-identity tests compare those, since node
``__eq__`` is left as identity (expressions overload ``==`` to build
comparison nodes, so structural ``__eq__`` on dataclasses would lie).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from .exprs import PExpr, PlanError

__all__ = [
    "Node", "Scan", "Filter", "Project", "Join", "AggSpec", "Aggregate",
    "Window", "Sort", "Limit", "UnionAll", "SetOp", "Exists", "Having",
    "CorrelatedAggFilter", "Exchange", "rollup", "infer_schema",
    "structure", "PlanError",
]

Schema = Dict[str, DType]

_JOIN_HOWS = ("inner", "left", "full", "semi", "anti")
_AGG_HOWS = ("sum", "count", "count_all", "min", "max", "mean",
             "var", "std", "var_pop", "stddev_pop", "nunique")
_WINDOW_HOWS = ("row_number", "rank", "dense_rank", "lag", "lead", "sum",
                "mean", "min", "max", "count", "cumsum", "var", "std",
                "var_pop", "stddev_pop")
_SETOP_KINDS = ("intersect", "except")


class Node:
    """Base logical-plan node."""

    def inputs(self) -> Tuple["Node", ...]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class Scan(Node):
    """Read a named table from the bound catalog. ``columns`` is the
    pruned projection (None = all); ``alias`` disambiguates two scans of
    one table (self-joins) in the fused tier's build map."""

    table: str
    columns: Optional[Tuple[str, ...]] = None
    alias: Optional[str] = None

    def inputs(self):
        return ()

    @property
    def key(self) -> str:
        return self.alias or self.table


@dataclasses.dataclass(frozen=True, eq=False)
class Filter(Node):
    input: Node
    predicate: PExpr

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True, eq=False)
class Project(Node):
    """Output schema IS ``exprs`` (name, expression), in order — a
    rename/narrow/compute node, like Spark's Project."""

    input: Node
    exprs: Tuple[Tuple[str, PExpr], ...]

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True, eq=False)
class Join(Node):
    """Equi-join on ``on = ((left_col, right_col), ...)`` pairs.
    ``bounded=True`` hints the fused tier to lower a single-int-key
    inner/semi/anti join through the dense bounded-domain map (domain
    scanned from the build table at bind time); ``False`` (the
    default) lowers sort-merge; ``None`` means "author abstains" and
    lets the cost-based optimizer resolve the strategy from the build
    key's sketch (``cbo_join_strategy`` — falsy, so an unresolved
    ``None`` still lowers sort-merge). The hint never changes
    semantics, only the kernel."""

    left: Node
    right: Node
    on: Tuple[Tuple[str, str], ...]
    how: str = "inner"
    bounded: Optional[bool] = False

    def __post_init__(self):
        if self.how not in _JOIN_HOWS:
            raise PlanError(f"unknown join how {self.how!r}")
        if not self.on:
            raise PlanError("join needs at least one key pair")

    def inputs(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True, eq=False)
class AggSpec:
    """One aggregate: ``source`` column (None only for count_all),
    ``how``, output ``name``."""

    source: Optional[str]
    how: str
    name: str

    def __post_init__(self):
        if self.how not in _AGG_HOWS:
            raise PlanError(f"unknown aggregate {self.how!r}")
        if self.source is None and self.how != "count_all":
            raise PlanError(f"aggregate {self.how!r} needs a source column")


@dataclasses.dataclass(frozen=True, eq=False)
class Aggregate(Node):
    """GROUP BY ``keys`` computing ``aggs``; empty keys = one global
    row; empty aggs = DISTINCT over the keys. ``grouping_sets`` (e.g.
    from ``rollup()``) is sugar the optimizer expands into a UnionAll
    of plain group-bys with null-filled rolled columns."""

    input: Node
    keys: Tuple[str, ...] = ()
    aggs: Tuple[AggSpec, ...] = ()
    grouping_sets: Optional[Tuple[Tuple[str, ...], ...]] = None

    def __post_init__(self):
        if not self.keys and not self.aggs:
            raise PlanError("aggregate needs keys or aggregates")
        if self.grouping_sets is not None:
            if not self.aggs:
                raise PlanError("grouping sets need at least one aggregate")
            for gs in self.grouping_sets:
                extra = set(gs) - set(self.keys)
                if extra:
                    raise PlanError(f"grouping set {gs} not a subset of keys: {extra}")
        names = list(self.keys) + [a.name for a in self.aggs]
        if len(set(names)) != len(names):
            raise PlanError(f"duplicate output names in aggregate: {names}")

    def inputs(self):
        return (self.input,)


def rollup(*keys: str) -> Tuple[Tuple[str, ...], ...]:
    """ROLLUP(k1, .., kn) -> the n+1 grouping sets (k1..kn), (k1..kn-1),
    ..., () — pass as ``Aggregate(grouping_sets=rollup(...))``."""
    return tuple(tuple(keys[:i]) for i in range(len(keys), -1, -1))


@dataclasses.dataclass(frozen=True, eq=False)
class Exchange(Node):
    """Hash-repartition the input across ``world`` ranks on ``keys``:
    after this stage, all rows of one key value live on
    hash(key) % world, whatever rank produced them — the distribution
    guarantee a downstream keyed Aggregate/Join needs to compute its
    partition of the answer locally. Schema- and (globally)
    row-preserving: an Exchange moves rows, it never creates, drops,
    or rewrites one. On a single rank (``world == 1`` or no exchange
    binding at run time) it lowers to the identity, so a distributed
    plan compiles and runs unchanged on one host."""

    input: Node
    keys: Tuple[str, ...]
    world: int

    def __post_init__(self):
        if not self.keys:
            raise PlanError("exchange needs at least one key column")
        if self.world < 1:
            raise PlanError(f"exchange world must be >= 1, got {self.world}")

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True, eq=False)
class Window(Node):
    """Append window columns (``ops/window.window_aggregate``), original
    row order preserved. ``aggs``: ((source, how, out_name), ...)."""

    input: Node
    partition_by: Tuple[str, ...]
    order_by: Tuple[Tuple[str, bool], ...]
    aggs: Tuple[Tuple[str, str, str], ...]

    def __post_init__(self):
        for _, how, _ in self.aggs:
            if how not in _WINDOW_HOWS:
                raise PlanError(f"unknown window function {how!r}")

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True, eq=False)
class Sort(Node):
    """Total-order sort by ``keys = ((column, ascending), ...)``."""

    input: Node
    keys: Tuple[Tuple[str, bool], ...]

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True, eq=False)
class Limit(Node):
    input: Node
    n: int

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True, eq=False)
class UnionAll(Node):
    branches: Tuple[Node, ...]

    def __post_init__(self):
        if len(self.branches) < 2:
            raise PlanError("UnionAll needs at least two branches")

    def inputs(self):
        return self.branches


@dataclasses.dataclass(frozen=True, eq=False)
class SetOp(Node):
    """INTERSECT / EXCEPT (set semantics — deduplicated), rewritten to
    semi/anti joins over deduped keys (the q8/q14/q38/q87 expansion)."""

    left: Node
    right: Node
    kind: str

    def __post_init__(self):
        if self.kind not in _SETOP_KINDS:
            raise PlanError(f"unknown set op {self.kind!r}")

    def inputs(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True, eq=False)
class Exists(Node):
    """EXISTS / NOT EXISTS correlated on equi-pairs — rewritten to a
    semi/anti join (Spark's own EXISTS plan; q10/q16/q35/q69 class)."""

    input: Node
    sub: Node
    on: Tuple[Tuple[str, str], ...]
    negated: bool = False

    def inputs(self):
        return (self.input, self.sub)


@dataclasses.dataclass(frozen=True, eq=False)
class Having(Node):
    """Post-aggregate predicate — rewritten to a plain Filter over the
    aggregate's output schema (q34/q73 class)."""

    input: Node
    predicate: PExpr

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True, eq=False)
class CorrelatedAggFilter(Node):
    """The correlated scalar-subquery comparison (q1/q6/q30/q32/q92
    family): for each input row, compare against ``agg`` computed over
    the ``sub`` rows whose ``on[1]`` equals the row's ``on[0]``.
    Decorrelated (rewrites.py) into ``Filter(Join(input,
    Aggregate(sub, keys=(on[1],), aggs=(agg,))), predicate)`` — an
    aggregate + join, which is how Spark decorrelates it. The inner
    join implements SQL's NULL-comparison semantics: rows with an empty
    subquery group drop. The aggregate's output column joins the
    schema, so ``predicate`` may reference ``agg.name``."""

    input: Node
    sub: Node
    on: Tuple[str, str]
    agg: AggSpec
    predicate: PExpr

    def inputs(self):
        return (self.input, self.sub)


# ---------------------------------------------------------------------------
# schema inference
# ---------------------------------------------------------------------------


def _numeric_agg_dtype(d: DType, how: str, where: str) -> DType:
    if how in ("count", "count_all", "nunique"):
        return dt.INT64
    if not (d.is_integral or d.is_floating):
        raise PlanError(f"{where}: {how} needs a numeric column, got {d!r}")
    return dt.FLOAT64


def _window_dtype(d: DType, how: str) -> DType:
    if how in ("row_number", "rank", "dense_rank"):
        return dt.INT32
    if how == "count":
        return dt.INT64
    if how in ("mean", "var", "std", "var_pop", "stddev_pop"):
        return dt.FLOAT64
    if how == "cumsum":
        return dt.INT64 if d.is_integral else d
    if how == "sum":
        if d.id == TypeId.FLOAT32:
            return dt.FLOAT32
        return dt.INT64 if d.is_integral else dt.FLOAT64
    return d  # lag/lead/min/max keep the source type


def _check_key_pair(ls: Schema, rs: Schema, pair, where: str) -> None:
    lname, rname = pair
    if lname not in ls:
        raise PlanError(f"{where}: left key {lname!r} not in {sorted(ls)}")
    if rname not in rs:
        raise PlanError(f"{where}: right key {rname!r} not in {sorted(rs)}")
    ld, rd = ls[lname], rs[rname]
    compat = (ld.id == rd.id) or (ld.is_integral and rd.is_integral)
    if not compat:
        raise PlanError(f"{where}: key dtypes incompatible: "
                        f"{lname}:{ld!r} vs {rname}:{rd!r}")


def infer_schema(node: Node, catalog: Dict[str, Schema],
                 _memo: Optional[dict] = None) -> Schema:
    """Infer (and validate) ``node``'s output schema under ``catalog``
    (table name -> {column: DType}). Raises PlanError on unknown
    columns/tables, name collisions, or dtype mismatches."""
    memo = {} if _memo is None else _memo
    key = id(node)
    if key in memo:
        return memo[key]
    s = _infer(node, catalog, memo)
    memo[key] = s
    return s


def _infer(node: Node, catalog, memo) -> Schema:
    if isinstance(node, Scan):
        if node.table not in catalog:
            raise PlanError(f"unknown table {node.table!r}; catalog has "
                            f"{sorted(catalog)}")
        base = catalog[node.table]
        if node.columns is None:
            return dict(base)
        out: Schema = {}
        for c in node.columns:
            if c not in base:
                raise PlanError(f"scan {node.key}: no column {c!r}")
            out[c] = base[c]
        return out

    if isinstance(node, Filter):
        s = infer_schema(node.input, catalog, memo)
        d = node.predicate.dtype(s)
        if d.id != TypeId.BOOL8:
            raise PlanError(f"filter predicate must be BOOL8, got {d!r}")
        return dict(s)

    if isinstance(node, Project):
        s = infer_schema(node.input, catalog, memo)
        out = {}
        for name, e in node.exprs:
            if name in out:
                raise PlanError(f"project: duplicate output name {name!r}")
            out[name] = e.dtype(s)
        return out

    if isinstance(node, Join):
        ls = infer_schema(node.left, catalog, memo)
        rs = infer_schema(node.right, catalog, memo)
        for pair in node.on:
            _check_key_pair(ls, rs, pair, f"{node.how} join")
        if node.how in ("semi", "anti"):
            return dict(ls)
        rkeys = {r for _, r in node.on}
        out = dict(ls)
        for name, d in rs.items():
            if name in rkeys:
                continue
            if name in out:
                raise PlanError(
                    f"join: build column {name!r} collides with the probe "
                    "schema; Project-rename one side first")
            out[name] = d
        return out

    if isinstance(node, Aggregate):
        s = infer_schema(node.input, catalog, memo)
        out: Schema = {}
        for k in node.keys:
            if k not in s:
                raise PlanError(f"aggregate key {k!r} not in {sorted(s)}")
            out[k] = s[k]
        for a in node.aggs:
            if a.how == "count_all":
                out[a.name] = dt.INT64
                continue
            if a.source not in s:
                raise PlanError(f"aggregate source {a.source!r} not in {sorted(s)}")
            out[a.name] = _numeric_agg_dtype(s[a.source], a.how, "aggregate")
        return out

    if isinstance(node, Exchange):
        s = infer_schema(node.input, catalog, memo)
        for c in node.keys:
            if c not in s:
                raise PlanError(f"exchange key {c!r} not in {sorted(s)}")
        return dict(s)

    if isinstance(node, Window):
        s = infer_schema(node.input, catalog, memo)
        for c in node.partition_by:
            if c not in s:
                raise PlanError(f"window partition key {c!r} not in {sorted(s)}")
        for c, _ in node.order_by:
            if c not in s:
                raise PlanError(f"window order key {c!r} not in {sorted(s)}")
        out = dict(s)
        for src, how, name in node.aggs:
            if src not in s:
                raise PlanError(f"window source {src!r} not in {sorted(s)}")
            if name in out:
                raise PlanError(f"window output {name!r} collides")
            out[name] = _window_dtype(s[src], how)
        return out

    if isinstance(node, (Sort,)):
        s = infer_schema(node.input, catalog, memo)
        for c, _ in node.keys:
            if c not in s:
                raise PlanError(f"sort key {c!r} not in {sorted(s)}")
        return dict(s)

    if isinstance(node, Limit):
        return dict(infer_schema(node.input, catalog, memo))

    if isinstance(node, UnionAll):
        first = infer_schema(node.branches[0], catalog, memo)
        for b in node.branches[1:]:
            s = infer_schema(b, catalog, memo)
            if list(s.keys()) != list(first.keys()) or any(
                s[k].id != first[k].id or s[k].scale != first[k].scale
                for k in first
            ):
                raise PlanError(
                    f"UNION ALL branch schemas differ: {first} vs {s}")
        return dict(first)

    if isinstance(node, SetOp):
        ls = infer_schema(node.left, catalog, memo)
        rs = infer_schema(node.right, catalog, memo)
        if list(ls.keys()) != list(rs.keys()) or any(
            ls[k].id != rs[k].id for k in ls
        ):
            raise PlanError(f"{node.kind} sides disagree: {ls} vs {rs}")
        return dict(ls)

    if isinstance(node, Exists):
        s = infer_schema(node.input, catalog, memo)
        sub = infer_schema(node.sub, catalog, memo)
        for pair in node.on:
            _check_key_pair(s, sub, pair, "exists")
        return dict(s)

    if isinstance(node, Having):
        s = infer_schema(node.input, catalog, memo)
        d = node.predicate.dtype(s)
        if d.id != TypeId.BOOL8:
            raise PlanError(f"having predicate must be BOOL8, got {d!r}")
        return dict(s)

    if isinstance(node, CorrelatedAggFilter):
        s = infer_schema(node.input, catalog, memo)
        sub = infer_schema(node.sub, catalog, memo)
        _check_key_pair(s, sub, node.on, "correlated filter")
        a = node.agg
        if a.source is not None and a.source not in sub:
            raise PlanError(f"correlated agg source {a.source!r} not in "
                            f"{sorted(sub)}")
        out = dict(s)
        if a.name in out:
            raise PlanError(f"correlated agg output {a.name!r} collides")
        out[a.name] = (dt.INT64 if a.how in ("count", "count_all", "nunique")
                       else _numeric_agg_dtype(sub[a.source], a.how,
                                               "correlated filter"))
        d = node.predicate.dtype(out)
        if d.id != TypeId.BOOL8:
            raise PlanError(f"correlated predicate must be BOOL8, got {d!r}")
        return out

    raise PlanError(f"unknown plan node {type(node).__name__}")


# ---------------------------------------------------------------------------
# canonical structure (structural equality for tests / idempotence)
# ---------------------------------------------------------------------------


def structure(node: Node) -> tuple:
    """Canonical nested-tuple rendering of a plan (expressions included
    via ``PExpr.structure``); two plans are structurally equal iff their
    structures compare equal."""
    if isinstance(node, Scan):
        return ("scan", node.table, node.columns, node.alias)
    if isinstance(node, Filter):
        return ("filter", node.predicate.structure(), structure(node.input))
    if isinstance(node, Project):
        return ("project",
                tuple((n, e.structure()) for n, e in node.exprs),
                structure(node.input))
    if isinstance(node, Join):
        return ("join", node.how, node.on, node.bounded,
                structure(node.left), structure(node.right))
    if isinstance(node, Aggregate):
        return ("aggregate", node.keys,
                tuple((a.source, a.how, a.name) for a in node.aggs),
                node.grouping_sets, structure(node.input))
    if isinstance(node, Exchange):
        return ("exchange", node.keys, node.world, structure(node.input))
    if isinstance(node, Window):
        return ("window", node.partition_by, node.order_by, node.aggs,
                structure(node.input))
    if isinstance(node, Sort):
        return ("sort", node.keys, structure(node.input))
    if isinstance(node, Limit):
        return ("limit", node.n, structure(node.input))
    if isinstance(node, UnionAll):
        return ("union_all", tuple(structure(b) for b in node.branches))
    if isinstance(node, SetOp):
        return ("set_op", node.kind, structure(node.left), structure(node.right))
    if isinstance(node, Exists):
        return ("exists", node.on, node.negated,
                structure(node.input), structure(node.sub))
    if isinstance(node, Having):
        return ("having", node.predicate.structure(), structure(node.input))
    if isinstance(node, CorrelatedAggFilter):
        return ("corr_agg_filter", node.on,
                (node.agg.source, node.agg.how, node.agg.name),
                node.predicate.structure(),
                structure(node.input), structure(node.sub))
    raise PlanError(f"unknown plan node {type(node).__name__}")
