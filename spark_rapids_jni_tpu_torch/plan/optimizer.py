"""Cost-based optimizer: join enumeration as verified rewrites (port of
the JAX package's ``plan/optimizer.py``).

The search half of the plan tier. Three rules, each firing through the
SAME rewrite machinery as the standard executor rewrites — every fire
emits a PLAN006-style translation-validation obligation that
``plan/verifier.py`` discharges (schema witness + join-predicate
multiset preservation + outer-join legality), so a buggy search can
never silently change answers:

- ``cbo_reorder_joins`` — collects the maximal left-deep spine of
  stacked INNER joins over one base (a star: every probe key resolves
  in the base's schema; snowflake spines, whose probe keys come from
  an earlier dim's payload, are left in author order — reordering
  across the dependency is where the legality proofs stop today).
  Dim order is chosen by bounded DP over the join-output cardinality
  model (exact subset DP up to ``SRJTORCH_CBO_DP_TABLES`` dims, greedy
  sort past the bound; under the position-independent fanout
  multipliers the two provably coincide, which also makes the
  canonical order PREFIX-STABLE — a sub-chain of an optimal chain is
  itself optimal, so the bottom-up rewrite fixpoint converges instead
  of oscillating). A fire rebuilds the chain in canonical order and
  wraps it in a passthrough Project restoring the original column
  order, so the obligation's order-sensitive schema witness holds.

- ``cbo_build_side`` — commutes one inner join when the modeled build
  side (right) is strictly larger than the probe side; the wrapper
  Project renames the surviving right key back to the dropped left
  key's name (legal: equi-join output has them equal, and the rule
  only fires when the key dtypes match exactly).

- ``cbo_join_strategy`` — resolves a ``bounded=None`` ("CBO decides")
  join to the dense bounded-domain kernel or sort-merge from the build
  key's sketch (INT32, null-free, non-negative, domain under
  ``_MAX_BOUNDED_DOMAIN``). Author-written ``True``/``False`` are
  binding and never touched; the operator tier's paged-hash probe (B4
  on the card) serves single-key joins underneath either choice.

The CBO pass runs inside ``compile_ir`` AFTER the standard rewrite
fixpoint (so sugar is gone and the idempotence contract of the default
RULES set is untouched), as two ``rewrite(..., rules=..., prune=False)``
invocations: reorder first, then build-side + strategy — physical
decisions must not disturb the canonical order mid-fixpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..columnar.dtype import TypeId
from ..utils import knobs
from . import stats as plan_stats
from .exprs import pcol
from .nodes import Filter, Join, Node, PlanError, Project, Scan, infer_schema
from .rewrites import Obligation, Rule, fingerprint, rewrite

__all__ = [
    "enabled", "optimize", "CboResult", "collect_chain",
    "is_passthrough_project", "reorder_rules", "physical_rules",
]

# dense bounded-domain joins stop paying off (and start bailing at
# bind time) past this build-key domain size
_MAX_BOUNDED_DOMAIN = 1 << 20


def enabled() -> bool:
    return (knobs.get_bool("SRJTORCH_CBO_ENABLED")
            and knobs.get_bool("SRJTORCH_STATS_ENABLED"))


# ---------------------------------------------------------------------------
# chain shape helpers (shared with the verifier's dischargers)
# ---------------------------------------------------------------------------


def is_passthrough_project(node: Node) -> bool:
    """True for a Project whose every output is a bare same-name column
    reference (a pure column permutation / narrowing)."""
    from . import exprs as ex
    return (isinstance(node, Project)
            and all(ex.is_col(e) == name for name, e in node.exprs))


def collect_chain(node: Node, catalog) -> Tuple[Node, List[Join]]:
    """Walk the left spine of stacked inner joins, seeing through any
    passthrough Project — column-pruning's narrowing wrappers and
    earlier fires' own restore Projects both land on the spine — and
    return ``(base, joins)`` with ``joins`` ordered OUTERMOST first. A
    non-inner join, a computing Project, or any other node terminates
    the spine and becomes the base. The rebuild drops the interleaved
    spine Projects (re-widening the intermediates); the head fire's
    restore Project re-narrows to the witnessed schema, and a rebuild
    that resurrects a projected-away name collision fails schema
    inference and aborts the fire."""
    joins: List[Join] = []
    cur = node
    while True:
        if isinstance(cur, Join) and cur.how == "inner":
            joins.append(cur)
            cur = cur.left
            continue
        if is_passthrough_project(cur):
            cur = cur.input
            continue
        break
    return cur, joins


# ---------------------------------------------------------------------------
# the enumeration core
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Dim:
    """One chain member: the join's key pairs + its build subtree."""

    on: Tuple[Tuple[str, str], ...]
    right: Node
    bounded: Optional[bool]
    factor: float          # modeled fanout multiplier (position-free)
    build_rows: int
    fp: str                # deterministic tie-break

    @property
    def order_key(self):
        return (self.factor, self.build_rows, self.fp)


def _dims_of(chain: Sequence[Join], est, catalog) -> List[_Dim]:
    out = []
    for j in chain:
        rrows = plan_stats.model.estimate_rows(j.right, est, catalog)
        denom = 1.0
        for l, r in j.on:
            d = max(est.ndv(l), est.ndv(r))
            if d > 0:
                denom *= d
        # unclamped fanout: rows multiply by build_rows / key-ndv —
        # position-independent, which the prefix-stability (and hence
        # fixpoint convergence) argument relies on
        factor = rrows / denom if denom > 1.0 else float(rrows)
        out.append(_Dim(on=j.on, right=j.right, bounded=j.bounded,
                        factor=factor, build_rows=rrows,
                        fp=fingerprint(j.right)))
    return out


def _order_cost(base_rows: float, dims: Sequence[_Dim]) -> float:
    """Sum of modeled intermediate cardinalities — the DP objective."""
    card = float(base_rows)
    total = 0.0
    for d in dims:
        card *= d.factor
        total += card
    return total


def _dp_order(base_rows: float, dims: List[_Dim]) -> List[_Dim]:
    """Exact left-deep subset DP minimizing the sum of intermediate
    cardinalities, ties broken toward the greedy (sorted) order — so
    the result is deterministic and equals the greedy order under the
    position-independent multiplier model."""
    n = len(dims)
    order = sorted(range(n), key=lambda i: dims[i].order_key)
    best: Dict[int, Tuple[float, Tuple[int, ...]]] = {0: (0.0, ())}
    rank = {i: pos for pos, i in enumerate(order)}
    for mask in range(1, 1 << n):
        card = base_rows
        for i in range(n):
            if mask & (1 << i):
                card *= dims[i].factor
        choices = []
        for i in range(n):
            if not (mask & (1 << i)):
                continue
            prev_cost, prev_seq = best[mask & ~(1 << i)]
            choices.append((prev_cost + card,
                            tuple(rank[j] for j in prev_seq + (i,)),
                            prev_seq + (i,)))
        choices.sort(key=lambda c: (c[0], c[1]))
        best[mask] = (choices[0][0], choices[0][2])
    seq = best[(1 << n) - 1][1]
    return [dims[i] for i in seq]


def _canonical_order(base_rows: float, dims: List[_Dim]) -> List[_Dim]:
    bound = max(2, knobs.get_int("SRJTORCH_CBO_DP_TABLES"))
    if len(dims) <= bound:
        return _dp_order(base_rows, dims)
    return sorted(dims, key=lambda d: d.order_key)  # greedy fallback


def _rebuild_chain(base: Node, dims: Sequence[_Dim]) -> Node:
    cur = base
    for d in dims:
        cur = Join(cur, d.right, on=d.on, how="inner", bounded=d.bounded)
    return cur


def _restore_order(inner: Node, original_schema) -> Project:
    return Project(inner, tuple((n, pcol(n)) for n in original_schema))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _r_reorder(est):
    def fn(node, catalog, memo) -> Optional[Node]:
        if not (isinstance(node, Join) and node.how == "inner"):
            return None
        base, chain = collect_chain(node, catalog)
        if len(chain) < 2:
            return None
        base_schema = infer_schema(base, catalog)
        # star only: every probe key resolves in the base schema —
        # snowflake dependencies pin the author order
        for j in chain:
            if any(l not in base_schema for l, _ in j.on):
                return None
        # a spine node reused INSIDE a dim subtree is a CTE (q32/q92:
        # the decorrelated scalar agg aggregates the same dated fact
        # join the spine probes) — the plan computes it once by object
        # identity, and a rebuilt spine would break that sharing and
        # pay for the subtree twice, so the author order is pinned
        spine_ids = set()
        walk = node
        while walk is not base:
            spine_ids.add(id(walk))
            walk = walk.left if isinstance(walk, Join) else walk.input
        for j in chain:
            stack = [j.right]
            while stack:
                n = stack.pop()
                if id(n) in spine_ids:
                    return None
                stack.extend(n.inputs())
        dims = list(reversed(_dims_of(chain, est, catalog)))  # innermost 1st
        base_rows = plan_stats.model.estimate_rows(base, est, catalog)
        want = _canonical_order(float(base_rows), dims)
        if [d.fp for d in want] == [d.fp for d in dims]:
            return None
        rebuilt = _rebuild_chain(base, want)
        out = _restore_order(rebuilt, infer_schema(node, catalog))
        try:
            # dropping the spine's narrowing Projects can resurrect a
            # payload-name collision the author projected away — such a
            # rebuild does not validate, so the fire aborts
            infer_schema(out, catalog)
        except PlanError:
            return None
        return out
    return fn


def _key_unique(est, name: str) -> bool:
    """EXACT evidence that a base column is null-free and all-distinct
    — the classic build-on-the-PK-side gate. Sketch ``unique`` is a
    full-scan ``np.unique`` witness (never claimed under sampling): the
    dense payload maps reject duplicate build keys at RUNTIME, so an
    approximate HLL "probably unique" would turn a profitable-looking
    commute into a query failure."""
    sk = est.resolve(name)
    return (sk is not None and sk.nulls == 0 and sk.non_null > 0
            and sk.unique)


def _multiplicity_preserving(node: Node) -> bool:
    """True when ``node`` is a Scan under only Filters / passthrough
    Projects — shapes that can only DROP rows, never duplicate them.
    Base-column uniqueness (``_key_unique``) survives exactly these
    shapes; a join above the scan could fan rows out and re-introduce
    duplicate keys the sketch cannot see."""
    cur = node
    while True:
        if isinstance(cur, Filter):
            cur = cur.input
        elif isinstance(cur, Project) and is_passthrough_project(cur):
            cur = cur.input
        else:
            return isinstance(cur, Scan)


def _r_build_side(est):
    def fn(node, catalog, memo) -> Optional[Node]:
        if not (isinstance(node, Join) and node.how == "inner"):
            return None
        ls = infer_schema(node.left, catalog)
        rs = infer_schema(node.right, catalog)
        # the restore-Project renames the surviving right key to the
        # dropped left key's name: only legal when dtypes match exactly
        if any(ls[l].id != rs[r].id or ls[l].scale != rs[r].scale
               for l, r in node.on):
            return None
        # the commute makes the old probe side the new BUILD side: the
        # fused tier's payload maps need unique build keys, so only
        # commute onto a key-side (a dup-heavy FK stays the probe) that
        # cannot have re-duplicated the key above its scan
        if any(not _key_unique(est, l) for l, _ in node.on) \
                or not _multiplicity_preserving(node.left):
            return None
        lrows = plan_stats.model.estimate_rows(node.left, est, catalog)
        rrows = plan_stats.model.estimate_rows(node.right, est, catalog)
        if rrows <= lrows:
            return None  # build already the smaller side
        swapped = Join(node.right, node.left,
                       on=tuple((r, l) for l, r in node.on),
                       how="inner", bounded=node.bounded)
        rename = {l: r for l, r in node.on if l != r}
        out = tuple((n, pcol(rename.get(n, n)))
                    for n in infer_schema(node, catalog))
        return Project(swapped, out)
    return fn


def _r_join_strategy(est):
    def fn(node, catalog, memo) -> Optional[Node]:
        if not (isinstance(node, Join) and node.bounded is None):
            return None
        decision = False
        if node.how in ("inner", "semi", "anti") and len(node.on) == 1:
            _, r = node.on[0]
            rs = infer_schema(node.right, catalog)
            sk = est.resolve(r)
            if (rs[r].id == TypeId.INT32 and sk is not None
                    and sk.non_null > 0 and sk.nulls == 0
                    and sk.min_val is not None and sk.min_val >= 0
                    and sk.max_val < _MAX_BOUNDED_DOMAIN
                    # dense bounded-domain builds require UNIQUE keys
                    # (the pipeline rejects duplicate payload slots)
                    and _key_unique(est, r)
                    and _multiplicity_preserving(node.right)):
                decision = True
        return Join(node.left, node.right, on=node.on, how=node.how,
                    bounded=decision)
    return fn


def reorder_rules(est) -> Tuple[Rule, ...]:
    return (("cbo_reorder_joins", _r_reorder(est)),)


def physical_rules(est) -> Tuple[Rule, ...]:
    return (("cbo_build_side", _r_build_side(est)),
            ("cbo_join_strategy", _r_join_strategy(est)))


# ---------------------------------------------------------------------------
# the compile_ir entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CboResult:
    plan: Node
    fired: Dict[str, int]
    obligations: List[Obligation]
    author_cost: Optional[float]
    chosen_cost: Optional[float]
    join_count: int
    estimator: object


def _count_joins(node: Node, seen=None) -> int:
    seen = set() if seen is None else seen
    if id(node) in seen:
        return 0
    seen.add(id(node))
    return (1 if isinstance(node, Join) else 0) + sum(
        _count_joins(i, seen) for i in node.inputs())


def optimize(plan: Node, catalog, tables, *, est=None) -> CboResult:
    """Run the CBO search over an already-desugared plan. The author
    plan's modeled cost is recorded BEFORE the search so the premerge
    gate can assert chosen <= author from the compile report."""
    if est is None:
        est = plan_stats.make_estimator(tables)
    if est is None:  # stats knobbed off: CBO has no model to search on
        return CboResult(plan, {}, [], None, None, _count_joins(plan), None)
    author_cost = plan_stats.plan_cost(plan, est, catalog)
    fired: Dict[str, int] = {}
    obligations: List[Obligation] = []
    cur = plan
    # reorder phase: the chain enumeration is local and cannot see DAG
    # sharing across the rest of the plan, so the global model vetoes —
    # a reorder that models worse than the author order is discarded
    res = rewrite(cur, catalog, rules=reorder_rules(est), prune=False)
    if res.fired and plan_stats.plan_cost(
            res.plan, est, catalog) <= author_cost:
        cur = res.plan
        for k, v in res.fired.items():
            fired[k] = fired.get(k, 0) + v
        obligations.extend(res.obligations)
    # physical phase: build-side only commutes the bigger side out of
    # build position and strategy only sets a hint — never cost-raising
    res = rewrite(cur, catalog, rules=physical_rules(est), prune=False)
    cur = res.plan
    for k, v in res.fired.items():
        fired[k] = fired.get(k, 0) + v
    obligations.extend(res.obligations)
    chosen_cost = plan_stats.plan_cost(cur, est, catalog)
    return CboResult(cur, fired, obligations, author_cost, chosen_cost,
                     _count_joins(plan), est)
