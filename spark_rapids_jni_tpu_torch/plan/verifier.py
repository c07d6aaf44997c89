"""Plan-IR verifier + per-rewrite translation validation (port of the
JAX package's ``plan/verifier.py``: the same PLAN0xx codes and messages).

Until this module, the ONLY evidence a rewrite pass preserved semantics
was the per-query pandas oracle — every new lower greened through the
compiler was one unchecked rewrite chain away from a silently wrong
answer. srjt-plancheck makes plan transformations first-class checked
artifacts (the Flare stance: plan-level compilation earns its speed only
when the transformations themselves are verified), in three layers:

1. **Well-formedness** (``verify_plan``): an INDEPENDENT bottom-up walk
   of the plan — every column reference resolves against its child
   schema, expression dtypes are sound (reusing ``exprs.py`` inference
   per expression, with node-level typing rules re-derived here rather
   than shared with ``nodes.infer_schema``), join/aggregate/window key
   arity and dtype contracts hold, and no sugar node (``SetOp`` /
   ``Exists`` / ``Having`` / ``CorrelatedAggFilter`` / grouping sets)
   survives when the plan claims to be past the rewrite fixpoint. The
   walk's derived schema is then CROSS-CHECKED against the production
   ``infer_schema`` — two implementations must agree, so a bug in either
   surfaces as a violation instead of propagating silently.

2. **Translation validation** (``verify_obligations``): the rewrite
   engine (``rewrites.py``) emits an ``Obligation`` record for every
   fired rule — rule name, before/after subtrees with structure
   fingerprints, and the preserved-schema witness inferred BEFORE the
   rewrite. Each obligation is discharged STRUCTURALLY by the per-rule
   checker registered in ``OBLIGATION_DISCHARGERS``: schema equality for
   every rule, plus rule-specific soundness (conjunct-multiset
   preservation and join-side legality for pushdowns, dedup/keys shape
   for set-op lowering, null-fill discipline for grouping-set expansion,
   scan-narrowing-only for pruning). An obligation that cannot be
   discharged — or that names a rule with no registered discharger — is
   a hard PLAN006 violation; ``srjt-lint`` SRJT011 statically requires
   every registered rule to carry a discharger here or a reasoned
   ``# srjt-plan: allow-unverified(<reason>)``.

3. **Estimate consistency** (``verify_estimates``): every lowered stage
   must carry a positive ``memory_bytes`` estimate that is
   monotone-consistent with its children (a filter/limit/aggregate never
   estimates MORE output rows than its input, a union estimates exactly
   the sum of its branches), and the plan-level
   ``estimated_memory_bytes`` must equal the per-stage working-set peak
   — the number memgov admission and the serve scheduler trust.

Rule catalog (reported through the shared ``analysis/lint.py`` emitters,
so ``--format=json|sarif`` and exit codes behave exactly like the other
static tools):

    PLAN001 unresolved-ref          column/table reference does not
                                    resolve against the child schema
    PLAN002 dtype-contract          expression/node dtype rules violated
                                    (non-BOOL8 predicate, non-numeric
                                    aggregate source, union/join dtype
                                    mismatch, inference cross-check
                                    disagreement)
    PLAN003 shape-contract          arity/name contracts (duplicate
                                    outputs, payload collisions, unknown
                                    how, negative limit)
    PLAN004 sugar-survives          a sugar node survived past the
                                    rewrite fixpoint
    PLAN005 estimate-inconsistency  missing/non-positive/non-monotone
                                    stage estimate, or a plan peak that
                                    disagrees with its stages
    PLAN006 undischarged-obligation a fired rewrite's obligation failed
                                    its structural discharge
    PLAN007 differential-mismatch   compiler-vs-oracle divergence found
                                    by the fuzzer (analysis/planfuzz.py)
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional

from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from . import exprs as ex
from .exprs import PExpr, PlanError
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

__all__ = [
    "PlanViolation",
    "verify_plan",
    "verify_obligations",
    "verify_estimates",
    "verify_for_cache",
    "OBLIGATION_DISCHARGERS",
]

Schema = Dict[str, DType]

_JOIN_HOWS = ("inner", "left", "full", "semi", "anti")
_AGG_HOWS = ("sum", "count", "count_all", "min", "max", "mean",
             "var", "std", "var_pop", "stddev_pop", "nunique")
_COUNT_AGGS = ("count", "count_all", "nunique")
_WINDOW_HOWS = ("row_number", "rank", "dense_rank", "lag", "lead", "sum",
                "mean", "min", "max", "count", "cumsum", "var", "std",
                "var_pop", "stddev_pop")


class PlanViolation:
    """One verifier finding. Attribute-compatible with
    ``analysis.lint.Violation`` so the shared text/json/sarif emitters
    render it unchanged; ``path`` carries the plan name (``plan:q1``)
    instead of a file."""

    __slots__ = ("path", "line", "rule", "message")

    def __init__(self, where: str, rule: str, message: str):
        self.path = where
        self.line = 1
        self.rule = rule
        self.message = message

    def __repr__(self):
        return f"{self.path}: {self.rule} {self.message}"


def _schema_eq(a: Schema, b: Schema) -> bool:
    return list(a) == list(b) and all(
        a[k].id == b[k].id and a[k].scale == b[k].scale for k in a
    )


def _fmt_schema(s: Optional[Schema]) -> str:
    if s is None:
        return "<unavailable>"
    return "{" + ", ".join(f"{k}: {d!r}" for k, d in s.items()) + "}"


# ---------------------------------------------------------------------------
# layer 1: well-formedness
# ---------------------------------------------------------------------------


class _Verifier:
    """Independent bottom-up schema derivation. Returns None for a node
    whose subtree already produced a violation, so one seeded defect
    reports exactly ONE finding instead of cascading up the tree (the
    gate-can-fail fixtures pin that discipline)."""

    def __init__(self, catalog: Dict[str, Schema], desugared: bool,
                 where: str):
        self.catalog = catalog
        self.desugared = desugared
        self.where = where
        self.violations: List[PlanViolation] = []
        self._memo: Dict[int, Optional[Schema]] = {}

    def flag(self, rule: str, message: str) -> None:
        self.violations.append(PlanViolation(self.where, rule, message))

    def schema(self, node: Node) -> Optional[Schema]:
        key = id(node)
        if key in self._memo:
            return self._memo[key]
        # pre-insert None so a (malformed) cyclic plan terminates
        self._memo[key] = None
        s = self._node(node)
        self._memo[key] = s
        return s

    # -- expressions --------------------------------------------------------

    def _expr(self, e: PExpr, s: Schema, what: str,
              want_bool: bool = False) -> Optional[DType]:
        missing = sorted(e.refs() - set(s))
        if missing:
            self.flag("PLAN001",
                      f"{what}: column(s) {missing} not in the child "
                      f"schema {sorted(s)}")
            return None
        try:
            d = e.dtype(s)
        except PlanError as exc:
            self.flag("PLAN002", f"{what}: expression dtype unsound: {exc}")
            return None
        if want_bool and d.id != TypeId.BOOL8:
            self.flag("PLAN002", f"{what}: predicate must be BOOL8, got {d!r}")
            return None
        return d

    def _key_pair(self, ls: Schema, rs: Schema, pair, what: str) -> bool:
        lname, rname = pair
        ok = True
        if lname not in ls:
            self.flag("PLAN001", f"{what}: left key {lname!r} not in {sorted(ls)}")
            ok = False
        if rname not in rs:
            self.flag("PLAN001", f"{what}: right key {rname!r} not in {sorted(rs)}")
            ok = False
        if not ok:
            return False
        ld, rd = ls[lname], rs[rname]
        if not ((ld.id == rd.id) or (ld.is_integral and rd.is_integral)):
            self.flag("PLAN002", f"{what}: key dtypes incompatible: "
                      f"{lname}:{ld!r} vs {rname}:{rd!r}")
            return False
        return True

    def _agg_out(self, s: Schema, a, what: str) -> Optional[DType]:
        if a.how not in _AGG_HOWS:
            self.flag("PLAN003", f"{what}: unknown aggregate {a.how!r}")
            return None
        if a.how == "count_all":
            return dt.INT64
        if a.source not in s:
            self.flag("PLAN001",
                      f"{what}: aggregate source {a.source!r} not in {sorted(s)}")
            return None
        d = s[a.source]
        if a.how in _COUNT_AGGS:
            return dt.INT64
        if not (d.is_integral or d.is_floating):
            self.flag("PLAN002",
                      f"{what}: {a.how} needs a numeric source, got {d!r}")
            return None
        return dt.FLOAT64

    # -- nodes --------------------------------------------------------------

    def _node(self, node: Node) -> Optional[Schema]:
        if isinstance(node, Scan):
            if node.table not in self.catalog:
                self.flag("PLAN001", f"scan of unknown table {node.table!r}; "
                          f"catalog has {sorted(self.catalog)}")
                return None
            base = self.catalog[node.table]
            if node.columns is None:
                return dict(base)
            out: Schema = {}
            bad = [c for c in node.columns if c not in base]
            if bad:
                self.flag("PLAN001",
                          f"scan {node.key}: column(s) {bad} not in table "
                          f"{node.table!r}")
                return None
            for c in node.columns:
                out[c] = base[c]
            return out

        if isinstance(node, Filter):
            s = self.schema(node.input)
            if s is None:
                return None
            if self._expr(node.predicate, s, "filter", want_bool=True) is None:
                return None
            return dict(s)

        if isinstance(node, Project):
            s = self.schema(node.input)
            if s is None:
                return None
            out = {}
            for name, e in node.exprs:
                if name in out:
                    self.flag("PLAN003",
                              f"project: duplicate output name {name!r}")
                    return None
                d = self._expr(e, s, f"project output {name!r}")
                if d is None:
                    return None
                out[name] = d
            return out

        if isinstance(node, Join):
            ls = self.schema(node.left)
            rs = self.schema(node.right)
            if ls is None or rs is None:
                return None
            if node.how not in _JOIN_HOWS:
                self.flag("PLAN003", f"join: unknown how {node.how!r}")
                return None
            if not node.on:
                self.flag("PLAN003", "join: no key pairs")
                return None
            for pair in node.on:
                if not self._key_pair(ls, rs, pair, f"{node.how} join"):
                    return None
            if node.how in ("semi", "anti"):
                return dict(ls)
            rkeys = {r for _, r in node.on}
            out = dict(ls)
            for name, d in rs.items():
                if name in rkeys:
                    continue
                if name in out:
                    self.flag("PLAN003",
                              f"join: build column {name!r} collides with "
                              "the probe schema")
                    return None
                out[name] = d
            return out

        if isinstance(node, Aggregate):
            s = self.schema(node.input)
            if s is None:
                return None
            if node.grouping_sets is not None and self.desugared:
                self.flag("PLAN004",
                          "grouping sets survived the rewrite fixpoint "
                          "(expand_grouping_sets never fired?)")
                # fall through: type it as a plain aggregate so the
                # finding stays exactly one
            out: Schema = {}
            for k in node.keys:
                if k not in s:
                    self.flag("PLAN001",
                              f"aggregate key {k!r} not in {sorted(s)}")
                    return None
                out[k] = s[k]
            for a in node.aggs:
                if a.name in out:
                    self.flag("PLAN003",
                              f"aggregate: duplicate output {a.name!r}")
                    return None
                d = self._agg_out(s, a, "aggregate")
                if d is None:
                    return None
                out[a.name] = d
            if node.grouping_sets is not None:
                for gs in node.grouping_sets:
                    extra = set(gs) - set(node.keys)
                    if extra:
                        self.flag("PLAN003",
                                  f"grouping set {gs} not a subset of the "
                                  f"keys: {sorted(extra)}")
                        return None
            return out

        if isinstance(node, Window):
            s = self.schema(node.input)
            if s is None:
                return None
            for c in node.partition_by:
                if c not in s:
                    self.flag("PLAN001",
                              f"window partition key {c!r} not in {sorted(s)}")
                    return None
            for c, _ in node.order_by:
                if c not in s:
                    self.flag("PLAN001",
                              f"window order key {c!r} not in {sorted(s)}")
                    return None
            out = dict(s)
            for src, how, name in node.aggs:
                if how not in _WINDOW_HOWS:
                    self.flag("PLAN003", f"window: unknown function {how!r}")
                    return None
                if src not in s:
                    self.flag("PLAN001",
                              f"window source {src!r} not in {sorted(s)}")
                    return None
                if name in out:
                    self.flag("PLAN003", f"window output {name!r} collides")
                    return None
                out[name] = self._window_dtype(s[src], how)
            return out

        if isinstance(node, Exchange):
            s = self.schema(node.input)
            if s is None:
                return None
            if node.world < 1:
                self.flag("PLAN003",
                          f"exchange: world must be >= 1 ({node.world})")
                return None
            for c in node.keys:
                if c not in s:
                    self.flag("PLAN001",
                              f"exchange key {c!r} not in {sorted(s)}")
                    return None
            return dict(s)

        if isinstance(node, Sort):
            s = self.schema(node.input)
            if s is None:
                return None
            for c, _ in node.keys:
                if c not in s:
                    self.flag("PLAN001", f"sort key {c!r} not in {sorted(s)}")
                    return None
            return dict(s)

        if isinstance(node, Limit):
            s = self.schema(node.input)
            if s is None:
                return None
            if node.n < 0:
                self.flag("PLAN003", f"limit: negative n ({node.n})")
                return None
            return dict(s)

        if isinstance(node, UnionAll):
            schemas = [self.schema(b) for b in node.branches]
            if any(s is None for s in schemas):
                return None
            first = schemas[0]
            for s in schemas[1:]:
                if not _schema_eq(first, s):
                    self.flag("PLAN002",
                              "UNION ALL branch schemas differ: "
                              f"{_fmt_schema(first)} vs {_fmt_schema(s)}")
                    return None
            return dict(first)

        # -- sugar nodes ----------------------------------------------------

        if isinstance(node, SetOp):
            ls = self.schema(node.left)
            rs = self.schema(node.right)
            if ls is None or rs is None:
                return None
            if self.desugared:
                self.flag("PLAN004",
                          f"SetOp({node.kind}) survived the rewrite fixpoint")
                return dict(ls)
            if list(ls) != list(rs) or any(ls[k].id != rs[k].id for k in ls):
                self.flag("PLAN002", f"{node.kind} sides disagree: "
                          f"{_fmt_schema(ls)} vs {_fmt_schema(rs)}")
                return None
            return dict(ls)

        if isinstance(node, Exists):
            s = self.schema(node.input)
            sub = self.schema(node.sub)
            if s is None or sub is None:
                return None
            if self.desugared:
                self.flag("PLAN004", "Exists survived the rewrite fixpoint")
                return dict(s)
            for pair in node.on:
                if not self._key_pair(s, sub, pair, "exists"):
                    return None
            return dict(s)

        if isinstance(node, Having):
            s = self.schema(node.input)
            if s is None:
                return None
            if self.desugared:
                self.flag("PLAN004", "Having survived the rewrite fixpoint")
                return dict(s)
            if self._expr(node.predicate, s, "having", want_bool=True) is None:
                return None
            return dict(s)

        if isinstance(node, CorrelatedAggFilter):
            s = self.schema(node.input)
            sub = self.schema(node.sub)
            if s is None or sub is None:
                return None
            if self.desugared:
                self.flag("PLAN004",
                          "CorrelatedAggFilter survived the rewrite fixpoint")
                return dict(s)
            if not self._key_pair(s, sub, node.on, "correlated filter"):
                return None
            d = self._agg_out(sub, node.agg, "correlated filter")
            if d is None:
                return None
            out = dict(s)
            if node.agg.name in out:
                self.flag("PLAN003",
                          f"correlated agg output {node.agg.name!r} collides")
                return None
            out[node.agg.name] = d
            if self._expr(node.predicate, out, "correlated predicate",
                          want_bool=True) is None:
                return None
            return out

        self.flag("PLAN003", f"unknown plan node {type(node).__name__}")
        return None

    @staticmethod
    def _window_dtype(d: DType, how: str) -> DType:
        # re-derived independently of nodes._window_dtype: the final
        # cross-check against infer_schema is what catches drift
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
        return d


def verify_plan(plan: Node, catalog: Dict[str, Schema],
                desugared: bool = False,
                where: str = "plan") -> List[PlanViolation]:
    """Check plan well-formedness bottom-up. ``desugared=True``
    additionally bans sugar nodes (the post-fixpoint contract). The
    independent walk's schema is cross-checked against the production
    ``infer_schema`` when the walk itself is clean."""
    v = _Verifier(catalog, desugared, where)
    mine = v.schema(plan)
    if not v.violations:
        try:
            ref = infer_schema(plan, catalog)
        except PlanError as exc:
            v.flag("PLAN002",
                   "inference cross-check: infer_schema rejects a plan the "
                   f"verifier passed: {exc}")
        else:
            if mine is not None and not _schema_eq(mine, ref):
                v.flag("PLAN002",
                       "inference cross-check: verifier derived "
                       f"{_fmt_schema(mine)} but infer_schema says "
                       f"{_fmt_schema(ref)}")
    return v.violations


# ---------------------------------------------------------------------------
# layer 2: translation validation (obligation discharge)
# ---------------------------------------------------------------------------


def _conjunct_counter(e: PExpr) -> Counter:
    return Counter(repr(c.structure()) for c in ex.conjuncts(e))


def _d_decorrelate(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not isinstance(b, CorrelatedAggFilter):
        return ["before-subtree is not a CorrelatedAggFilter"]
    if not (isinstance(a, Filter) and isinstance(a.input, Join)):
        return ["after-subtree is not Filter(Join(...))"]
    j = a.input
    msgs = []
    pk, bk = b.on
    if not (isinstance(j.right, Aggregate) and j.right.input is b.sub
            and j.right.keys == (bk,) and j.right.aggs == (b.agg,)):
        msgs.append("join build side is not Aggregate(sub, keys=(corr key,), "
                    "aggs=(the correlated agg,))")
    if j.left is not b.input or j.how != "inner" or j.on != ((pk, bk),):
        msgs.append("join probe side / how / keys do not reproduce the "
                    "correlation (inner join on the correlation pair)")
    if a.predicate.structure() != b.predicate.structure():
        msgs.append("comparison predicate changed across decorrelation")
    return msgs


def _d_grouping_sets(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not (isinstance(b, Aggregate) and b.grouping_sets is not None):
        return ["before-subtree is not an Aggregate with grouping sets"]
    branches = a.branches if isinstance(a, UnionAll) else (a,)
    if len(branches) != len(b.grouping_sets):
        return [f"{len(b.grouping_sets)} grouping sets expanded into "
                f"{len(branches)} branches"]
    msgs = []
    agg_names = {x.name for x in b.aggs}
    want_names = tuple(b.keys) + tuple(x.name for x in b.aggs)
    for gs, br in zip(b.grouping_sets, branches):
        if not (isinstance(br, Project) and isinstance(br.input, Aggregate)):
            msgs.append(f"branch for grouping set {gs} is not "
                        "Project(Aggregate(...))")
            continue
        ag = br.input
        if ag.input is not b.input or ag.keys != gs or ag.aggs != b.aggs:
            msgs.append(f"branch aggregate for {gs} does not group the "
                        "ORIGINAL input by exactly that set with the "
                        "original aggregates")
        if tuple(n for n, _ in br.exprs) != want_names:
            msgs.append(f"branch for {gs} does not project the original "
                        f"output names {want_names}")
            continue
        for n, e in br.exprs:
            rolled = n in b.keys and n not in gs
            if rolled and not ex.is_null_lit(e):
                msgs.append(f"rolled key {n!r} in branch {gs} is not a "
                            "typed NULL literal")
            if not rolled and (n in gs or n in agg_names) \
                    and ex.is_col(e) != n:
                msgs.append(f"kept column {n!r} in branch {gs} is not a "
                            "passthrough reference")
    return msgs


def _d_setop(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not isinstance(b, SetOp):
        return ["before-subtree is not a SetOp"]
    if not isinstance(a, Join):
        return ["after-subtree is not a Join"]
    want_how = "semi" if b.kind == "intersect" else "anti"
    msgs = []
    if a.how != want_how:
        msgs.append(f"{b.kind} must lower to a {want_how} join, got {a.how}")
    try:
        cols = tuple(infer_schema(b.left, catalog).keys())
    except PlanError as exc:
        return [f"before-subtree no longer infers: {exc}"]
    for side, src in (("left", b.left), ("right", b.right)):
        node = a.left if side == "left" else a.right
        if not (isinstance(node, Aggregate) and node.input is src
                and node.keys == cols and node.aggs == ()):
            msgs.append(f"{side} side is not deduplicated "
                        "(keys-only Aggregate over the original branch) — "
                        "set semantics lost")
    if a.on != tuple((c, c) for c in cols):
        msgs.append("join keys are not the full column set")
    return msgs


def _d_exists(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not isinstance(b, Exists):
        return ["before-subtree is not an Exists"]
    if not isinstance(a, Join):
        return ["after-subtree is not a Join"]
    msgs = []
    want_how = "anti" if b.negated else "semi"
    if a.how != want_how:
        msgs.append(f"{'NOT ' if b.negated else ''}EXISTS must lower to a "
                    f"{want_how} join, got {a.how}")
    if a.left is not b.input or a.on != b.on:
        msgs.append("probe side / key pairs do not reproduce the "
                    "correlation")
    sub = a.right
    if isinstance(sub, Project):
        if not (sub.input is b.sub and all(
                ex.is_col(e) == n for n, e in sub.exprs)):
            msgs.append("subquery side is not a passthrough key projection "
                        "of the original subquery")
    elif sub is not b.sub:
        msgs.append("subquery side was replaced")
    return msgs


def _d_having(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not isinstance(b, Having):
        return ["before-subtree is not a Having"]
    if not (isinstance(a, Filter) and a.input is b.input
            and a.predicate.structure() == b.predicate.structure()):
        return ["after-subtree is not Filter(<original aggregate>, "
                "<original predicate>)"]
    return []


def _d_merge_filters(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not (isinstance(b, Filter) and isinstance(b.input, Filter)):
        return ["before-subtree is not Filter(Filter(...))"]
    if not (isinstance(a, Filter) and a.input is b.input.input):
        return ["after-subtree does not sit directly on the inner "
                "filter's input"]
    want = _conjunct_counter(b.predicate) + _conjunct_counter(b.input.predicate)
    got = _conjunct_counter(a.predicate)
    if want != got:
        return ["conjunct multiset changed across the merge: "
                f"{sorted(want)} -> {sorted(got)}"]
    return []


def _d_push_project(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not (isinstance(b, Filter) and isinstance(b.input, Project)):
        return ["before-subtree is not Filter(Project(...))"]
    proj = b.input
    if not (isinstance(a, Project) and isinstance(a.input, Filter)
            and a.input.input is proj.input):
        return ["after-subtree is not Project(Filter(<project input>))"]
    msgs = []
    if a.exprs is not proj.exprs and tuple(
        (n, e.structure()) for n, e in a.exprs
    ) != tuple((n, e.structure()) for n, e in proj.exprs):
        msgs.append("projection list changed while pushing the filter")
    mapping = {}
    for name, e in proj.exprs:
        src = ex.is_col(e)
        if src is not None:
            mapping[name] = src
    refs = b.predicate.refs()
    if not refs <= set(mapping):
        msgs.append("predicate reads a COMPUTED projection column "
                    f"({sorted(refs - set(mapping))}) — pushing it below "
                    "the project changes semantics")
    elif ex.substitute(b.predicate, mapping).structure() \
            != a.input.predicate.structure():
        msgs.append("pushed predicate is not the original under the "
                    "project's rename mapping")
    return msgs


def _d_push_union(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not (isinstance(b, Filter) and isinstance(b.input, UnionAll)):
        return ["before-subtree is not Filter(UnionAll(...))"]
    u = b.input
    if not (isinstance(a, UnionAll) and len(a.branches) == len(u.branches)):
        return ["after-subtree is not a UnionAll of the same arity"]
    msgs = []
    want = b.predicate.structure()
    for i, (orig, got) in enumerate(zip(u.branches, a.branches)):
        if not (isinstance(got, Filter) and got.input is orig
                and got.predicate.structure() == want):
            msgs.append(f"branch {i} is not Filter(<original branch>, "
                        "<original predicate>)")
    return msgs


def _new_conjuncts(after_side: Node, before_side: Node, what: str,
                   msgs: List[str]) -> List[PExpr]:
    if after_side is before_side:
        return []
    if isinstance(after_side, Filter) and after_side.input is before_side:
        return list(ex.conjuncts(after_side.predicate))
    msgs.append(f"{what} side of the join was restructured, not just "
                "filtered")
    return []


def _d_push_join(ob, catalog) -> List[str]:
    b, a = ob.before, ob.after
    if not (isinstance(b, Filter) and isinstance(b.input, Join)):
        return ["before-subtree is not Filter(Join(...))"]
    j = b.input
    stay: List[PExpr] = []
    aj = a
    if isinstance(a, Filter):
        stay = list(ex.conjuncts(a.predicate))
        aj = a.input
    if not isinstance(aj, Join):
        return ["after-subtree is not a Join (or Filter over one)"]
    msgs: List[str] = []
    if aj.how != j.how or aj.on != j.on:
        msgs.append("join how/keys changed while pushing the filter")
    new_left = _new_conjuncts(aj.left, j.left, "probe", msgs)
    new_right = _new_conjuncts(aj.right, j.right, "build", msgs)
    want = _conjunct_counter(b.predicate)
    got = Counter(repr(c.structure()) for c in new_left + new_right + stay)
    if want != got:
        msgs.append("conjunct multiset changed across the push (a conjunct "
                    "was dropped, duplicated, or invented)")
    # legality: row-subsetting must commute with the join
    if j.how == "full" and (new_left or new_right):
        msgs.append("nothing commutes below a FULL join (both sides "
                    "null-extend)")
    if new_right and j.how != "inner":
        msgs.append(f"build-side conjunct pushed below a {j.how} join — the "
                    "build side defines membership/null-extension there, "
                    "so filtering it changes semantics")
    try:
        ls = set(infer_schema(j.left, catalog))
        rs = set(infer_schema(j.right, catalog))
    except PlanError as exc:
        msgs.append(f"join sides no longer infer: {exc}")
        return msgs
    for c in new_left:
        if not c.refs() <= ls:
            msgs.append(f"probe-side conjunct reads {sorted(c.refs() - ls)} "
                        "outside the probe schema")
    for c in new_right:
        if not c.refs() <= rs:
            msgs.append(f"build-side conjunct reads {sorted(c.refs() - rs)} "
                        "outside the build schema")
    return msgs


def _scans(node: Node) -> List[Scan]:
    out, seen = [], set()

    def visit(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, Scan):
            out.append(n)
        for i in n.inputs():
            visit(i)

    visit(node)
    return out


def _d_prune(ob, catalog) -> List[str]:
    # schema equality (the common check) already pins column-set
    # preservation at the root; here: scans may only NARROW within their
    # table, never invent columns
    msgs = []
    for s in _scans(ob.after):
        if s.table not in catalog:
            msgs.append(f"pruned scan references unknown table {s.table!r}")
            continue
        if s.columns is None:
            continue
        extra = [c for c in s.columns if c not in catalog[s.table]]
        if extra:
            msgs.append(f"pruned scan {s.key} invented column(s) {extra}")
    return msgs


def _d_partition_ooc(ob, catalog) -> List[str]:
    """Aggregate -> UnionAll of per-partition
    aggregates. Branch ``i`` must be the ORIGINAL aggregate (same keys,
    same agg specs, no grouping sets) over ``Filter(<original input>,
    part_hash(keys, K) == i)``. With the branches ordered ``i =
    0..K-1``, disjointness and completeness hold by construction — the
    partition ids partition the rows — and every group lands whole in
    exactly one branch because all of its rows share one key tuple."""
    b, a = ob.before, ob.after
    if not (isinstance(b, Aggregate) and b.keys
            and b.grouping_sets is None):
        return ["before-subtree is not a keyed Aggregate (no grouping "
                "sets)"]
    if not (isinstance(a, UnionAll) and len(a.branches) >= 2):
        return ["after-subtree is not a UnionAll of >= 2 partition "
                "branches"]
    msgs: List[str] = []
    parts = len(a.branches)
    want_aggs = [(s.source, s.how, s.name) for s in b.aggs]
    for i, br in enumerate(a.branches):
        if not (isinstance(br, Aggregate) and br.keys == b.keys
                and br.grouping_sets is None
                and [(s.source, s.how, s.name) for s in br.aggs] == want_aggs):
            msgs.append(f"branch {i} is not the original Aggregate "
                        "(keys/aggs changed)")
            continue
        f = br.input
        want = (ex.ppart(b.keys, parts) == ex.plit(i)).structure()
        if not (isinstance(f, Filter) and f.input is b.input
                and f.predicate.structure() == want):
            msgs.append(f"branch {i} input is not Filter(<original "
                        f"input>, part_hash(keys, {parts}) == {i})")
    return msgs


def _chain_sig(joins) -> Counter:
    """Multiset signature of a join chain: one entry per chain member
    carrying its key pairs, build-subtree fingerprint, join kind, and
    strategy hint — exactly what a pure REORDER must preserve."""
    from .rewrites import fingerprint
    return Counter((j.how, j.on, fingerprint(j.right), j.bounded)
                   for j in joins)


def _d_cbo_reorder(ob, catalog) -> List[str]:
    """A join-order enumeration fire. The after-
    subtree must be a passthrough Project (restoring the witnessed
    column order — checked by the common schema discharge) over a
    rebuilt chain of the SAME inner joins: same base, and the multiset
    of (how, on-pairs, build fingerprint, bounded) chain members
    preserved. Only inner joins may move (outer-join legality): the
    chain walk itself admits nothing else, so a reorder that absorbed
    a left/semi/anti join shows up as a base-fingerprint mismatch."""
    from .optimizer import collect_chain, is_passthrough_project
    from .rewrites import fingerprint
    b, a = ob.before, ob.after
    if not (isinstance(b, Join) and b.how == "inner"):
        return ["before-subtree is not an inner Join chain head"]
    if not is_passthrough_project(a):
        return ["after-subtree is not a passthrough column-restoring "
                "Project"]
    b_base, b_joins = collect_chain(b, catalog)
    a_base, a_joins = collect_chain(a.input, catalog)
    msgs: List[str] = []
    if len(b_joins) < 2:
        msgs.append("reorder fired on a chain of fewer than 2 joins")
    if fingerprint(b_base) != fingerprint(a_base):
        msgs.append("chain base changed across the reorder (a non-inner "
                    "join or the fact subtree was restructured)")
    if _chain_sig(b_joins) != _chain_sig(a_joins):
        msgs.append("join-predicate multiset not preserved: a chain "
                    "member's keys, build side, kind, or strategy hint "
                    "was dropped, duplicated, or invented")
    return msgs


def _d_cbo_build_side(ob, catalog) -> List[str]:
    """A build/probe commute. after must be
    Project(Join(right, left, on-swapped)) with the Project renaming
    the surviving right key back to the dropped left key's name — legal
    only for INNER joins with exactly-matching key dtypes (equi-join
    output has the pair equal row-for-row, so the rename is the
    identity on every surviving row)."""
    from .optimizer import is_passthrough_project  # noqa: F401 (shape doc)
    from .rewrites import fingerprint
    b, a = ob.before, ob.after
    if not (isinstance(b, Join) and b.how == "inner"):
        return ["before-subtree is not an inner Join"]
    if not (isinstance(a, Project) and isinstance(a.input, Join)):
        return ["after-subtree is not Project(Join(...))"]
    aj = a.input
    msgs: List[str] = []
    if aj.how != "inner":
        msgs.append("commuted join is not inner (outer-join commutes are "
                    "illegal)")
    if aj.on != tuple((r, l) for l, r in b.on):
        msgs.append("key pairs are not the originals swapped")
    if fingerprint(aj.left) != fingerprint(b.right) \
            or fingerprint(aj.right) != fingerprint(b.left):
        msgs.append("commuted join sides are not the original sides "
                    "swapped")
    if aj.bounded != b.bounded:
        msgs.append("strategy hint changed across the commute")
    try:
        ls = infer_schema(b.left, catalog)
        rs = infer_schema(b.right, catalog)
    except PlanError as exc:
        msgs.append(f"join sides no longer infer: {exc}")
        return msgs
    if any(l in ls and r in rs
           and (ls[l].id != rs[r].id or ls[l].scale != rs[r].scale)
           for l, r in b.on):
        msgs.append("key dtypes differ — the restoring rename would "
                    "retype the key column")
    rename = {l: r for l, r in b.on if l != r}
    try:
        want = list(infer_schema(b, catalog))
    except PlanError as exc:
        msgs.append(f"before-subtree no longer infers: {exc}")
        return msgs
    got = [(n, ex.is_col(e)) for n, e in a.exprs]
    if [n for n, _ in got] != want or any(
            src != rename.get(n, n) for n, src in got):
        msgs.append("restoring Project is not the identity-or-key-rename "
                    "mapping over the original schema")
    return msgs


def _d_cbo_join_strategy(ob, catalog) -> List[str]:
    """A physical-strategy resolution. Everything
    but the ``bounded`` hint must be identical, the before-hint must be
    None (author abstained — author-written hints are binding), and the
    after-hint a concrete bool. The hint never changes semantics (the
    dense path re-validates its domain at bind time and falls back),
    so structure preservation IS the proof."""
    from .rewrites import fingerprint
    b, a = ob.before, ob.after
    if not (isinstance(b, Join) and isinstance(a, Join)):
        return ["strategy fire is not Join -> Join"]
    msgs: List[str] = []
    if b.bounded is not None:
        msgs.append("author-written strategy hint overridden (before-"
                    "bounded was not None)")
    if not isinstance(a.bounded, bool):
        msgs.append("strategy not resolved to a concrete bool")
    if a.how != b.how or a.on != b.on:
        msgs.append("join how/keys changed in a strategy-only rewrite")
    if fingerprint(a.left) != fingerprint(b.left) \
            or fingerprint(a.right) != fingerprint(b.right):
        msgs.append("join inputs changed in a strategy-only rewrite")
    return msgs


# rule name -> discharge fn(obligation, catalog) -> list of failure
# messages. srjt-lint SRJT011 statically requires every rule registered
# in rewrites.RULES (plus prune_columns) to appear here or carry
# # srjt-plan: allow-unverified(<reason>).
OBLIGATION_DISCHARGERS: Dict[str, Callable] = {
    "decorrelate_scalar_agg": _d_decorrelate,
    "expand_grouping_sets": _d_grouping_sets,
    "setop_to_joins": _d_setop,
    "exists_to_semijoin": _d_exists,
    "having_to_filter": _d_having,
    "merge_filters": _d_merge_filters,
    "push_filter_through_project": _d_push_project,
    "push_filter_through_union": _d_push_union,
    "push_filter_into_join": _d_push_join,
    "prune_columns": _d_prune,
    # emitted by plan/ooc.py (compiler tail), not rewrites.RULES
    "partition_for_ooc": _d_partition_ooc,
    # emitted by the cost-based optimizer pass (plan/optimizer.py,
    # the cost-based optimizer), not rewrites.RULES
    "cbo_reorder_joins": _d_cbo_reorder,
    "cbo_build_side": _d_cbo_build_side,
    "cbo_join_strategy": _d_cbo_join_strategy,
}


def _discharge_schema(ob, catalog) -> List[str]:
    """The common obligation: the rewritten subtree still validates and
    its schema equals the preserved-schema witness."""
    try:
        after = infer_schema(ob.after, catalog)
    except PlanError as exc:
        return [f"rewritten subtree no longer validates: {exc}"]
    if ob.schema is not None and not _schema_eq(ob.schema, after):
        return ["schema not preserved: "
                f"{_fmt_schema(ob.schema)} -> {_fmt_schema(after)}"]
    return []


def verify_obligations(obligations, catalog: Dict[str, Schema],
                       where: str = "plan") -> List[PlanViolation]:
    """Discharge every rewrite obligation structurally. Each failed
    obligation yields exactly ONE PLAN006 violation carrying all of its
    failure messages (so a fixture firing one broken rule reports one
    finding)."""
    out: List[PlanViolation] = []
    for i, ob in enumerate(obligations):
        fn = OBLIGATION_DISCHARGERS.get(ob.rule)
        if fn is None:
            out.append(PlanViolation(
                where, "PLAN006",
                f"obligation #{i} ({ob.rule}, {ob.before_fp}->{ob.after_fp}):"
                " no discharger registered in plan/verifier.py — the rule's"
                " output is unverifiable"))
            continue
        msgs = _discharge_schema(ob, catalog)
        if not msgs:
            msgs = fn(ob, catalog)
        if msgs:
            out.append(PlanViolation(
                where, "PLAN006",
                f"obligation #{i} ({ob.rule}, {ob.before_fp}->{ob.after_fp})"
                f" undischargeable: " + "; ".join(msgs)))
    return out


# ---------------------------------------------------------------------------
# layer 3: estimate consistency (the memgov/serve contract)
# ---------------------------------------------------------------------------

# stage kinds whose output-row estimate must never exceed the (first)
# child's: subsetting and grouping never grow the row count
_ROW_MONOTONE_KINDS = ("filter", "limit", "aggregate", "fused_aggregate",
                       "exchange")


def verify_estimates(cp, where: str = "plan") -> List[PlanViolation]:
    """Every lowered stage carries a positive ``memory_bytes`` estimate,
    row estimates are monotone-consistent with child estimates, and the
    plan-level peak equals the per-stage working-set maximum (the number
    memgov admission and ``serve.submit`` consume)."""
    out: List[PlanViolation] = []
    stages = cp.stages
    if not stages:
        out.append(PlanViolation(where, "PLAN005",
                                 "compiled plan has no lowered stages"))
        return out
    for i, s in enumerate(stages):
        what = f"stage #{i} ({s.kind})"
        if not isinstance(getattr(s, "est_rows", None), int) \
                or not isinstance(getattr(s, "est_bytes", None), int) \
                or s.est_rows < 1 or s.est_bytes < s.est_rows:
            out.append(PlanViolation(
                where, "PLAN005",
                f"{what}: missing/non-positive estimate "
                f"(est_rows={getattr(s, 'est_rows', None)}, "
                f"est_bytes={getattr(s, 'est_bytes', None)})"))
            continue
        if s.kind in _ROW_MONOTONE_KINDS and s.inputs:
            child = s.inputs[0]
            if s.est_rows > child.est_rows:
                out.append(PlanViolation(
                    where, "PLAN005",
                    f"{what}: estimate inversion — estimates {s.est_rows} "
                    f"output rows over a {child.est_rows}-row input "
                    f"({child.kind}); a {s.kind} never grows the row "
                    "count"))
        if s.kind == "union_all":
            want = sum(c.est_rows for c in s.inputs)
            if s.est_rows != want:
                out.append(PlanViolation(
                    where, "PLAN005",
                    f"{what}: union estimate {s.est_rows} != sum of branch "
                    f"estimates {want}"))
    peak = max(s.working_set_est() for s in stages)
    if cp.estimated_memory_bytes != peak or peak <= 0:
        out.append(PlanViolation(
            where, "PLAN005",
            f"plan-level estimated_memory_bytes "
            f"({cp.estimated_memory_bytes}) disagrees with the per-stage "
            f"working-set peak ({peak}) — memgov admission would trust a "
            "stale number"))
    return out


# ---------------------------------------------------------------------------
# layer 4: cache-insert verification
# ---------------------------------------------------------------------------


def verify_for_cache(cp, tables, where: str = "cache") -> List[PlanViolation]:
    """The plan cache's insert gate: a compiled plan enters the cache
    only when its rewrite obligations discharge AND its stage estimates
    are consistent — "verifier-green at insert". Hits then reuse the
    cached structure without re-verifying per submission (the plan cache's
    once-per-structure contract); this is the once."""
    catalog = {t: {n: c.dtype for n, c in zip(tbl.names, tbl.columns)}
               for t, tbl in tables.items()}
    out = verify_obligations(cp.obligations, catalog, where=where)
    out.extend(verify_estimates(cp, where=where))
    return out
