"""Rewrite-pass framework over the logical-plan IR (port of the JAX
package's ``plan/rewrites.py``; fingerprints are the reference's bytes).

The standard executor expansions QUERIES.md documents (and
tests/test_ledger_rewrites.py proves in isolation), applied MECHANICALLY
by an optimizer instead of by hand per query:

- ``decorrelate_scalar_agg``   correlated scalar subquery -> aggregate +
                               join + filter (q1/q6/q30/q32/q92 family)
- ``expand_grouping_sets``     ROLLUP / GROUPING SETS -> UnionAll of
                               plain group-bys, rolled keys null-filled
                               (q5/q18/q22/q27/q77 family)
- ``setop_to_joins``           INTERSECT/EXCEPT -> semi/anti join on
                               deduplicated keys (q8/q14/q38/q87)
- ``exists_to_semijoin``       EXISTS / NOT EXISTS -> semi / anti join
                               (q10/q16/q35/q69)
- ``having_to_filter``         HAVING -> post-aggregate Filter (q34/q73)
- ``merge_filters``            stacked Filters -> one conjunction
- ``push_filter_through_project`` / ``push_filter_into_join`` /
  ``push_filter_through_union``  predicate pushdown, conjunct-at-a-time
- ``prune_columns``            projection pushdown: scans narrowed to
                               the columns the plan actually reads

Engine contract: ``rewrite()`` runs bottom-up passes to a FIXPOINT
(a pass that fires nothing is the last), preserving node sharing (a CTE
node referenced twice stays one object, so the compiler still evaluates
it once). Every rule is idempotent at the fixpoint by construction —
sugar rules eliminate their node class, merges reduce filter count, and
pushes only fire when a conjunct actually moves — which is what the
applied-twice-equals-applied-once test pins.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Tuple

from . import exprs as ex
from .exprs import PlanError, pcol, plit
from .nodes import (
    Aggregate,
    CorrelatedAggFilter,
    Exchange,
    Exists,
    Filter,
    Having,
    Join,
    Limit,
    Node,
    Project,
    Scan,
    SetOp,
    Sort,
    UnionAll,
    Window,
    infer_schema,
)

__all__ = ["rewrite", "prune_columns", "RewriteResult", "RULES",
           "Obligation", "fingerprint", "ParamFingerprint",
           "parameterized_fingerprint", "rebind_literals"]


def fingerprint(node: Node) -> str:
    """Stable structural fingerprint of a subtree (over
    ``nodes.structure``) — the obligation records and the fuzzer's
    bisection reports identify subtrees by it."""
    from .nodes import structure

    return hashlib.sha1(repr(structure(node)).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# parameterized fingerprint
# ---------------------------------------------------------------------------
#
# The plan cache keys on structure with literal VALUES slotted out, so
# "same dashboard query, different date" maps to one cache entry. Each
# slot keeps a type tag (and the literal's explicit dtype when one was
# given): ``plit(1998)`` and ``plit(19.98)`` infer different dtypes, so
# they must never share a key — a hit must be schema-identical to the
# cached structure, not merely tree-shaped like it.


def _lit_tag(value) -> str:
    """Type-class tag of a literal value. Two literals are slot-
    compatible (one may be rebound to the other) iff tags match — the
    tag pins exactly what ``_PLit.dtype`` infers, so a rebind can never
    change the plan's schema."""
    import numpy as np

    if value is None:
        return "null"
    if isinstance(value, (bool, np.bool_)):
        return "bool"
    if isinstance(value, np.int32):
        return "i32"
    if isinstance(value, (int, np.integer)):
        return "int"
    if isinstance(value, (float, np.floating)):
        return "float"
    return f"other:{type(value).__name__}"


@dataclasses.dataclass(frozen=True)
class ParamFingerprint:
    """``key`` hashes the plan structure with literal values replaced by
    typed slot markers; ``bindings`` are the slotted-out
    ``(tag, value, dtype_key)`` triples in deterministic traversal
    order. Two submissions with equal ``key`` are the same query modulo
    literal values — the compiled-plan cache's identity."""

    key: str
    bindings: Tuple[Tuple, ...]

    @property
    def values(self) -> Tuple:
        return tuple(b[1] for b in self.bindings)


def _slot_literals(s, bindings: list):
    """Recursively replace ``("lit", value, d)`` leaves of a
    ``nodes.structure`` rendering with positional typed slots,
    collecting the displaced values. Literal tuples are the only
    3-tuples whose head is "lit" and whose tail is a dtype key (tuple or
    None) — agg/window triples carry a string there, so the shape test
    cannot misfire on them."""
    if isinstance(s, tuple):
        if (len(s) == 3 and s[0] == "lit"
                and (s[2] is None or isinstance(s[2], tuple))):
            tag = _lit_tag(s[1])
            if tag.startswith("other"):
                return s  # untypable literal: keep inline, never slot
            bindings.append((tag, s[1], s[2]))
            return ("lit", ("?", len(bindings) - 1, tag), s[2])
        return tuple(_slot_literals(x, bindings) for x in s)
    return s


def parameterized_fingerprint(node: Node) -> ParamFingerprint:
    """Structural fingerprint with literals slotted out:
    plans differing only in literal values share a ``key``; plans
    differing in structure, literal type class, or explicit literal
    dtype never do."""
    from .nodes import structure

    bindings: list = []
    slotted = _slot_literals(structure(node), bindings)
    key = hashlib.sha1(repr(slotted).encode()).hexdigest()[:16]
    return ParamFingerprint(key, tuple(bindings))


def _map_node_exprs(node: Node, f) -> Node:
    """Rebuild ``node`` (inputs untouched) with its expressions mapped
    through ``f`` — only Filter/Project/Having/CorrelatedAggFilter
    carry expressions."""
    if isinstance(node, Filter):
        return Filter(node.input, f(node.predicate))
    if isinstance(node, Project):
        return Project(node.input, tuple((n, f(e)) for n, e in node.exprs))
    if isinstance(node, Having):
        return Having(node.input, f(node.predicate))
    if isinstance(node, CorrelatedAggFilter):
        return CorrelatedAggFilter(node.input, node.sub, node.on,
                                   node.agg, f(node.predicate))
    return node


def rebind_literals(plan: Node, mapping: Dict) -> Node:
    """Rebuild ``plan`` with literal values substituted through
    ``mapping`` (``(tag, value, dtype_key) -> new_value``). Literals
    without a mapping entry — e.g. the null fills grouping-set
    expansion synthesizes — are kept. Shared subtrees stay shared (the
    memo is by object identity), so a rebound CTE still lowers to one
    stage. The caller is responsible for mapping only tag-compatible
    values; rewrite rules copy and reorder literals but never fold
    them, which is what makes by-value rebinding sound."""
    from .exprs import map_literals, plit

    def map_expr(e):
        def one(lit):
            d = None if lit.d is None else (int(lit.d.id), lit.d.scale)
            key = (_lit_tag(lit.value), lit.value, d)
            if key in mapping:
                new = mapping[key]
                if new is not lit.value and not _same_value(new, lit.value):
                    return plit(new, lit.d)
            return lit
        return map_literals(e, one)

    memo: Dict[int, Node] = {}

    def visit(n: Node) -> Node:
        got = memo.get(id(n))
        if got is not None:
            return got
        new_inputs = tuple(visit(i) for i in n.inputs())
        out = n if new_inputs == n.inputs() else _with_inputs(n, new_inputs)
        out = _map_node_exprs(out, map_expr)
        memo[id(n)] = out
        return out

    return visit(plan)


def _same_value(a, b) -> bool:
    try:
        return bool(a == b) and type(a) is type(b)
    except Exception:  # srjt-lint: allow-broad-except(exotic literal __eq__ = not rebindable, never an error)
        return False


@dataclasses.dataclass
class Obligation:
    """Translation-validation record for ONE rule firing (plan verification):
    the subtree before, the rule's one-step output (captured
    BEFORE the engine recursed into the fresh children), structure
    fingerprints of both, and the preserved-schema witness inferred from
    the before-subtree. ``plan.verifier.verify_obligations`` discharges
    these structurally; an undischargeable obligation is a hard PLAN006
    violation. Records are collected on EVERY rewrite (and retained by
    ``CompiledPlan``) by design: a plan tree is dozens of nodes and real
    queries fire a handful of rules, so the witness inference and the
    pinned subtrees are noise next to the lowering itself — and a
    production-compiled plan stays verifiable after the fact."""

    rule: str
    before: Node
    after: Node
    before_fp: str
    after_fp: str
    schema: Optional[Dict] = None  # name -> DType witness (before-subtree)


def _make_obligation(rule: str, before: Node, after: Node,
                     catalog) -> Obligation:
    try:
        schema = infer_schema(before, catalog)
    except PlanError:
        # a malformed before-subtree cannot witness a schema; the
        # discharge still runs its structural checks
        schema = None
    return Obligation(rule, before, after, fingerprint(before),
                      fingerprint(after), schema)


@dataclasses.dataclass
class RewriteResult:
    plan: Node
    fired: Dict[str, int]
    obligations: List[Obligation] = dataclasses.field(default_factory=list)


# each rule: (name, fn(node, catalog, memo) -> Optional[Node]) — a
# one-step rewrite of THIS node, or None when it does not apply
Rule = Tuple[str, Callable]


def _schema(node: Node, catalog, memo):
    # a fresh inference memo per query: rules run on freshly-built
    # subtrees whose lifetimes are shorter than a shared id()-keyed
    # memo could safely cache
    return infer_schema(node, catalog)


def _decorrelate_scalar_agg(node, catalog, memo) -> Optional[Node]:
    if not isinstance(node, CorrelatedAggFilter):
        return None
    pk, bk = node.on
    agg = Aggregate(node.sub, keys=(bk,), aggs=(node.agg,))
    joined = Join(node.input, agg, on=((pk, bk),), how="inner")
    return Filter(joined, node.predicate)


def _expand_grouping_sets(node, catalog, memo) -> Optional[Node]:
    if not isinstance(node, Aggregate) or node.grouping_sets is None:
        return None
    in_schema = _schema(node.input, catalog, memo)
    branches: List[Node] = []
    for gs in node.grouping_sets:
        branch = Aggregate(node.input, keys=gs, aggs=node.aggs)
        outs = []
        for k in node.keys:
            if k in gs:
                outs.append((k, pcol(k)))
            else:
                outs.append((k, plit(None, in_schema[k])))
        for a in node.aggs:
            outs.append((a.name, pcol(a.name)))
        branches.append(Project(branch, tuple(outs)))
    if len(branches) == 1:
        return branches[0]
    return UnionAll(tuple(branches))


def _setop_to_joins(node, catalog, memo) -> Optional[Node]:
    if not isinstance(node, SetOp):
        return None
    cols = tuple(_schema(node.left, catalog, memo).keys())
    dl = Aggregate(node.left, keys=cols, aggs=())
    dr = Aggregate(node.right, keys=cols, aggs=())
    how = "semi" if node.kind == "intersect" else "anti"
    return Join(dl, dr, on=tuple((c, c) for c in cols), how=how)


def _exists_to_semijoin(node, catalog, memo) -> Optional[Node]:
    if not isinstance(node, Exists):
        return None
    keys = Project(node.sub, tuple((r, pcol(r)) for _, r in node.on))
    return Join(node.input, keys, on=node.on,
                how="anti" if node.negated else "semi")


def _having_to_filter(node, catalog, memo) -> Optional[Node]:
    if not isinstance(node, Having):
        return None
    return Filter(node.input, node.predicate)


def _merge_filters(node, catalog, memo) -> Optional[Node]:
    if not (isinstance(node, Filter) and isinstance(node.input, Filter)):
        return None
    inner = node.input
    pred = ex.conjoin(ex.conjuncts(inner.predicate) + ex.conjuncts(node.predicate))
    return Filter(inner.input, pred)


def _push_filter_through_project(node, catalog, memo) -> Optional[Node]:
    if not (isinstance(node, Filter) and isinstance(node.input, Project)):
        return None
    proj = node.input
    mapping = {}
    for name, e in proj.exprs:
        src = ex.is_col(e)
        if src is not None:
            mapping[name] = src
    refs = node.predicate.refs()
    if not refs <= set(mapping):
        return None  # predicate reads a computed column — stays above
    pushed = ex.substitute(node.predicate, mapping)
    return Project(Filter(proj.input, pushed), proj.exprs)


def _push_filter_through_union(node, catalog, memo) -> Optional[Node]:
    if not (isinstance(node, Filter) and isinstance(node.input, UnionAll)):
        return None
    u = node.input
    return UnionAll(tuple(Filter(b, node.predicate) for b in u.branches))


def _push_filter_into_join(node, catalog, memo) -> Optional[Node]:
    """Move conjuncts below the join where row-subsetting commutes:
    probe-side conjuncts for inner/semi/anti/left joins, build-side
    conjuncts for inner joins (the build side of a semi/anti defines
    membership — filtering it changes semantics; a full join
    null-extends both sides, so nothing commutes)."""
    if not (isinstance(node, Filter) and isinstance(node.input, Join)):
        return None
    j = node.input
    if j.how == "full":
        return None
    left_schema = set(_schema(j.left, catalog, memo))
    right_schema = set(_schema(j.right, catalog, memo))
    to_left, to_right, stay = [], [], []
    for c in ex.conjuncts(node.predicate):
        refs = c.refs()
        if refs <= left_schema:
            to_left.append(c)
        elif j.how == "inner" and refs <= right_schema:
            to_right.append(c)
        else:
            stay.append(c)
    if not to_left and not to_right:
        return None
    left = Filter(j.left, ex.conjoin(to_left)) if to_left else j.left
    right = Filter(j.right, ex.conjoin(to_right)) if to_right else j.right
    out: Node = Join(left, right, on=j.on, how=j.how, bounded=j.bounded)
    if stay:
        out = Filter(out, ex.conjoin(stay))
    return out


RULES: Tuple[Rule, ...] = (
    ("decorrelate_scalar_agg", _decorrelate_scalar_agg),
    ("expand_grouping_sets", _expand_grouping_sets),
    ("setop_to_joins", _setop_to_joins),
    ("exists_to_semijoin", _exists_to_semijoin),
    ("having_to_filter", _having_to_filter),
    ("merge_filters", _merge_filters),
    ("push_filter_through_project", _push_filter_through_project),
    ("push_filter_through_union", _push_filter_through_union),
    ("push_filter_into_join", _push_filter_into_join),
)

_MAX_PASSES = 64  # defensive bound; real plans converge in a handful


def _one_pass(node: Node, catalog, fired: Dict[str, int],
              rebuilt: Dict[int, Node], keepalive: List[Node],
              rules: Tuple[Rule, ...],
              obligations: Optional[List[Obligation]],
              budget: Optional[List[int]]) -> Node:
    """One bottom-up pass: rewrite children (sharing-preserving via the
    ``rebuilt`` memo), then apply rules at this node until none fires.
    ``keepalive`` pins every memo key's node for the pass so an id()
    can never be recycled into a stale hit. Each fire appends one
    ``Obligation`` (the before-subtree and the rule's ONE-STEP output,
    captured before recursing into the fresh children) and spends one
    unit of ``budget`` when set — the fuzzer's bisection replays the
    deterministic fire sequence with ``max_fires=k``."""
    key = id(node)
    if key in rebuilt:
        return rebuilt[key]
    new_inputs = tuple(_one_pass(i, catalog, fired, rebuilt, keepalive,
                                 rules, obligations, budget)
                       for i in node.inputs())
    cur = node if all(a is b for a, b in zip(new_inputs, node.inputs())) \
        else _with_inputs(node, new_inputs)
    changed = True
    while changed:
        changed = False
        if budget is not None and budget[0] <= 0:
            break
        for name, fn in rules:
            nxt = fn(cur, catalog, None)
            if nxt is not None:
                fired[name] = fired.get(name, 0) + 1
                if budget is not None:
                    budget[0] -= 1
                if obligations is not None:
                    obligations.append(
                        _make_obligation(name, cur, nxt, catalog))
                # a rule's output may contain unrewritten children —
                # recurse over the fresh subtree before retrying rules
                sub_inputs = tuple(
                    _one_pass(i, catalog, fired, rebuilt, keepalive,
                              rules, obligations, budget)
                    for i in nxt.inputs()
                )
                cur = nxt if all(a is b for a, b in zip(sub_inputs, nxt.inputs())) \
                    else _with_inputs(nxt, sub_inputs)
                changed = True
                break
    keepalive.append(node)
    rebuilt[key] = cur
    return cur


def _with_inputs(node: Node, inputs: Tuple[Node, ...]) -> Node:
    if isinstance(node, Filter):
        return Filter(inputs[0], node.predicate)
    if isinstance(node, Project):
        return Project(inputs[0], node.exprs)
    if isinstance(node, Join):
        return Join(inputs[0], inputs[1], on=node.on, how=node.how,
                    bounded=node.bounded)
    if isinstance(node, Aggregate):
        return Aggregate(inputs[0], keys=node.keys, aggs=node.aggs,
                         grouping_sets=node.grouping_sets)
    if isinstance(node, Window):
        return Window(inputs[0], node.partition_by, node.order_by, node.aggs)
    if isinstance(node, Exchange):
        return Exchange(inputs[0], node.keys, node.world)
    if isinstance(node, Sort):
        return Sort(inputs[0], node.keys)
    if isinstance(node, Limit):
        return Limit(inputs[0], node.n)
    if isinstance(node, UnionAll):
        return UnionAll(inputs)
    if isinstance(node, SetOp):
        return SetOp(inputs[0], inputs[1], node.kind)
    if isinstance(node, Exists):
        return Exists(inputs[0], inputs[1], node.on, node.negated)
    if isinstance(node, Having):
        return Having(inputs[0], node.predicate)
    if isinstance(node, CorrelatedAggFilter):
        return CorrelatedAggFilter(inputs[0], inputs[1], node.on, node.agg,
                                   node.predicate)
    if isinstance(node, Scan):
        return node
    raise PlanError(f"unknown plan node {type(node).__name__}")


def rewrite(plan: Node, catalog: Dict[str, Dict], *,
            rules: Optional[Tuple[Rule, ...]] = None,
            max_fires: Optional[int] = None,
            prune: bool = True) -> RewriteResult:
    """Run the rule set bottom-up to a fixpoint, then prune columns.
    ``catalog`` maps table name -> {column: DType} (rules that split
    predicates or null-fill rolled keys need schemas). Every rule
    firing emits a translation-validation ``Obligation`` (discharged by
    ``plan.verifier``); ``rules``/``max_fires``/``prune`` exist for the
    fuzzer's bisection (replay the first k fires of the deterministic
    chain) and for seeded broken-rewrite fixtures."""
    rules = RULES if rules is None else tuple(rules)
    infer_schema(plan, catalog)  # validate before touching anything
    fired: Dict[str, int] = {}
    obligations: List[Obligation] = []
    budget = None if max_fires is None else [max_fires]
    from .nodes import structure

    cur = plan
    for _ in range(_MAX_PASSES):
        before = structure(cur)
        cur = _one_pass(cur, catalog, fired, {}, [], rules, obligations,
                        budget)
        if structure(cur) == before:
            break
    else:
        raise PlanError("rewrite did not converge (rule oscillation?)")
    if prune:
        pre_prune = cur
        cur = prune_columns(cur, catalog)
        obligations.append(
            _make_obligation("prune_columns", pre_prune, cur, catalog))
    infer_schema(cur, catalog)  # the rewritten plan must still validate
    return RewriteResult(cur, fired, obligations)


# ---------------------------------------------------------------------------
# projection pushdown (column pruning)
# ---------------------------------------------------------------------------


def prune_columns(plan: Node, catalog: Dict[str, Dict]) -> Node:
    """Narrow every Scan to the columns the plan actually consumes and
    drop unused Project outputs / Aggregate aggregates. Runs after the
    rule fixpoint (sugar nodes must be gone). Shared nodes accumulate
    requirements across ALL their consumers and stay shared."""
    schema_memo: dict = {}
    required: Dict[int, set] = {}

    def need(node: Node, cols: set) -> None:
        required.setdefault(id(node), set()).update(cols)

    order: List[Node] = []  # reverse-topological collection
    seen: Dict[int, Node] = {}

    def topo(node: Node) -> None:
        if id(node) in seen:
            return
        seen[id(node)] = node
        for i in node.inputs():
            topo(i)
        order.append(node)

    topo(plan)
    need(plan, set(infer_schema(plan, catalog, schema_memo)))

    # propagate requirements top-down (reverse of the topo order)
    for node in reversed(order):
        req = required.get(id(node), set())
        if isinstance(node, Filter):
            need(node.input, req | node.predicate.refs())
        elif isinstance(node, Project):
            kept = [(n, e) for n, e in node.exprs if n in req]
            refs: set = set()
            for _, e in kept:
                refs |= e.refs()
            need(node.input, refs)
        elif isinstance(node, Join):
            ls = infer_schema(node.left, catalog, schema_memo)
            rs = infer_schema(node.right, catalog, schema_memo)
            need(node.left, (req & set(ls)) | {l for l, _ in node.on})
            need(node.right, (req & set(rs)) | {r for _, r in node.on})
        elif isinstance(node, Aggregate):
            srcs = {a.source for a in node.aggs if a.source is not None}
            cols = set(node.keys) | srcs
            if not cols:
                # pure COUNT(*): keep one column so the scan still
                # carries the row count
                cols = {next(iter(infer_schema(node.input, catalog,
                                               schema_memo)))}
            need(node.input, cols)
        elif isinstance(node, Window):
            ins = infer_schema(node.input, catalog, schema_memo)
            req_in = (req & set(ins)) | set(node.partition_by)
            req_in |= {c for c, _ in node.order_by}
            req_in |= {s for s, _, _ in node.aggs}
            need(node.input, req_in)
        elif isinstance(node, Exchange):
            # partition keys must survive pruning — the repartition
            # hashes them even when no consumer reads them back
            need(node.input, req | set(node.keys))
        elif isinstance(node, Sort):
            need(node.input, req | {c for c, _ in node.keys})
        elif isinstance(node, Limit):
            need(node.input, req)
        elif isinstance(node, UnionAll):
            for b in node.branches:
                need(b, set(req))
        elif isinstance(node, Scan):
            pass
        else:
            raise PlanError(
                f"prune_columns before desugaring: {type(node).__name__} "
                "must be rewritten away first")

    rebuilt: Dict[int, Node] = {}

    def narrow(child_old: Node, child_new: Node, cols: set) -> Node:
        """Insert a passthrough Project when the rebuilt child still
        carries columns its consumer does not need (a filter-only dim
        column must not ride into a join payload)."""
        s = list(infer_schema(child_old, catalog, schema_memo))
        keep = [c for c in s if c in cols]
        if set(s) == set(keep):
            return child_new
        return Project(child_new, tuple((c, pcol(c)) for c in keep))

    def build(node: Node) -> Node:
        if id(node) in rebuilt:
            return rebuilt[id(node)]
        req = required.get(id(node), set())
        if isinstance(node, Scan):
            base = catalog[node.table]
            cols = tuple(c for c in base if c in req)
            out: Node = Scan(node.table, columns=cols, alias=node.alias)
        elif isinstance(node, Project):
            kept = tuple((n, e) for n, e in node.exprs if n in req)
            if not kept:  # a branch whose output is entirely unused
                kept = node.exprs[:1]
            out = Project(build(node.input), kept)
        elif isinstance(node, Aggregate):
            aggs = tuple(a for a in node.aggs if a.name in req)
            if not aggs and not node.keys:
                aggs = node.aggs[:1]
            out = Aggregate(build(node.input), keys=node.keys, aggs=aggs)
        elif isinstance(node, Join):
            ls = infer_schema(node.left, catalog, schema_memo)
            rs = infer_schema(node.right, catalog, schema_memo)
            lneed = (req & set(ls)) | {l for l, _ in node.on}
            rneed = (req & set(rs)) | {r for _, r in node.on}
            left = narrow(node.left, build(node.left), lneed)
            right = narrow(node.right, build(node.right), rneed)
            out = Join(left, right, on=node.on, how=node.how,
                       bounded=node.bounded)
        else:
            out = _with_inputs(node, tuple(build(i) for i in node.inputs()))
        rebuilt[id(node)] = out
        return out

    return build(plan)
