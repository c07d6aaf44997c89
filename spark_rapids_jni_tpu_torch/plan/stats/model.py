"""Cardinality + cost model (port of the JAX package's
``plan/stats/model.py``).

Two consumers, one set of numbers:

- the **compiler** (plan/compiler.py) asks :class:`Estimator` for
  per-operator row estimates (filter selectivity from sketches, join
  cardinality from distinct counts, aggregate output from group-key
  ndv products) and for per-kind **byte calibration factors** learned
  from the ``artifacts/plan_compile.jsonl`` estimate-vs-actual reports
  (knob ``SRJTORCH_CBO_CALIBRATION``). Those estimates are what memgov
  admission and OOC partitioning trust, replacing the flat
  ``_FILTER_SELECTIVITY = 0.5`` and uncalibrated ``_width`` numbers.

- the **optimizer** (plan/optimizer.py) asks :func:`plan_cost` for a
  modeled scalar cost of a whole logical plan — rows materialized +
  bytes moved (exchange volume weighted by world size, spill risk
  weighted when a budget is armed) — which is the objective the
  join-order / build-side / strategy search minimizes and the number
  the premerge modeled-cost gate compares (chosen vs author order).

Calibration is loaded once per process under a lock, tolerates a
missing or partial artifact file (all factors default to 1.0 — the
chicken-and-egg posture of a fresh checkout), and clamps every factor
into [0.5, 2.0] so one bad archived run can never swing admission by
more than 2x.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Optional

from ...utils import knobs
from .. import nodes as N
from .sketches import ColumnSketch, DEFAULT_SELECTIVITY, TableStats, selectivity

__all__ = [
    "Estimator", "plan_cost", "estimate_rows", "row_width",
    "calibration_factor", "load_calibration", "reset_calibration",
    "choose_ooc_partitions",
]

# clamp band for learned per-kind byte factors: a single archived run
# must never swing admission estimates by more than 2x either way
_CAL_MIN, _CAL_MAX = 0.5, 2.0

_cal_lock = threading.Lock()
_cal_cache: Optional[Dict[str, float]] = None


def load_calibration(path: str) -> Dict[str, float]:
    """Per-stage-kind byte factor (median actual/est) from a
    plan_compile.jsonl artifact; {} when the file is missing, empty,
    or unparseable — estimates then run uncalibrated."""
    ratios: Dict[str, list] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                for st in rec.get("stages", ()):
                    est = st.get("est_bytes")
                    act = st.get("actual_bytes")
                    kind = st.get("kind")
                    if not kind or not est or act is None:
                        continue
                    ratios.setdefault(kind, []).append(act / est)
    except OSError:
        return {}
    out = {}
    for kind, rs in ratios.items():
        rs.sort()
        med = rs[len(rs) // 2]
        out[kind] = min(_CAL_MAX, max(_CAL_MIN, med))
    return out


def calibration_factor(kind: str) -> float:
    """The learned byte factor for one stage kind (1.0 when no
    artifact has been archived yet). Loaded once per process so every
    compile in a run sees the same model."""
    global _cal_cache
    with _cal_lock:
        if _cal_cache is None:
            path = knobs.get_str("SRJTORCH_CBO_CALIBRATION")
            _cal_cache = load_calibration(path) if path else {}
        return _cal_cache.get(kind, 1.0)


def reset_calibration() -> None:
    """Drop the memoized calibration (tests re-point the knob)."""
    global _cal_cache
    with _cal_lock:
        _cal_cache = None


def row_width(schema) -> int:
    """Estimated bytes per row — mirrors the compiler's width model
    (fixed widths, 16 bytes per variable-width column, +1 validity
    lane)."""
    total = 0
    for d in schema.values():
        total += d.size_bytes if d.is_fixed_width else 16
        total += 1
    return max(total, 1)


class Estimator:
    """Sketch-backed cardinality estimates over a set of bound tables.

    Column sketches are resolved by NAME across every bound table —
    TPC-DS column names are table-prefixed, so the flat namespace is
    unambiguous in practice, and a miss just falls back to the default
    selectivity.
    """

    def __init__(self, stats: Dict[str, TableStats]):
        self.stats = dict(stats)
        self._by_col: Dict[str, ColumnSketch] = {}
        for ts in stats.values():
            for name, sk in ts.columns.items():
                self._by_col.setdefault(name, sk)

    def resolve(self, name: str) -> Optional[ColumnSketch]:
        return self._by_col.get(name)

    def table_rows(self, table: str) -> Optional[int]:
        ts = self.stats.get(table)
        return ts.rows if ts is not None else None

    def ndv(self, name: str, default: float = 0.0) -> float:
        sk = self.resolve(name)
        return sk.ndv if sk is not None else default

    # -- per-operator cardinality ------------------------------------------

    def filter_sel(self, pred) -> float:
        return selectivity(pred, self.resolve)

    def filter_rows(self, child_rows: int, pred) -> int:
        return max(1, int(math.ceil(child_rows * self.filter_sel(pred))))

    def join_rows(self, how: str, left_rows: int, right_rows: int,
                  on) -> int:
        """Equi-join output cardinality from key distinct counts:
        |L join R| ~= |L|*|R| / max(ndv(l), ndv(r)), the standard
        containment assumption; multi-key pairs multiply denominators."""
        if how == "full":
            return max(1, left_rows + right_rows)
        denom = 1.0
        known = False
        for l, r in on:
            nl, nr = self.ndv(l), self.ndv(r)
            d = max(nl, nr)
            if d > 0:
                denom *= d
                known = True
        if how in ("semi", "anti"):
            if not known:
                return max(1, left_rows)
            # fraction of left key values with a build match
            nl = max(1.0, self.ndv(on[0][0], 1.0))
            nr = max(1.0, self.ndv(on[0][1], 1.0))
            match = min(1.0, nr / nl)
            frac = match if how == "semi" else 1.0 - match
            return max(1, int(math.ceil(left_rows * min(1.0, max(frac, 1.0 / max(left_rows, 1))))))
        if not known:
            inner = left_rows
        else:
            inner = left_rows * right_rows / denom
        inner = max(1, min(int(math.ceil(inner)), max(1, left_rows) * max(1, right_rows)))
        if how == "left":
            return max(left_rows, inner)
        return inner

    def agg_rows(self, child_rows: int, keys) -> int:
        """GROUP BY output: product of key ndvs, capped by the input."""
        if not keys:
            return 1
        prod = 1.0
        known = False
        for k in keys:
            n = self.ndv(k)
            if n > 0:
                prod *= n
                known = True
        if not known:
            return max(1, child_rows)
        return max(1, min(int(math.ceil(prod)), max(1, child_rows)))


# ---------------------------------------------------------------------------
# whole-plan modeled cost (the CBO search objective)
# ---------------------------------------------------------------------------


def _rows_of(node: N.Node, est: Estimator, catalog, memo) -> int:
    key = id(node)
    hit = memo.get(key)
    if hit is not None:
        return hit
    r = _rows_calc(node, est, catalog, memo)
    memo[key] = r
    return r


def _rows_calc(node, est, catalog, memo) -> int:
    if isinstance(node, N.Scan):
        r = est.table_rows(node.table)
        return max(1, r if r is not None else 1024)
    if isinstance(node, N.Filter):
        return est.filter_rows(_rows_of(node.input, est, catalog, memo),
                               node.predicate)
    if isinstance(node, N.Join):
        return est.join_rows(node.how,
                             _rows_of(node.left, est, catalog, memo),
                             _rows_of(node.right, est, catalog, memo),
                             node.on)
    if isinstance(node, N.Aggregate):
        return est.agg_rows(_rows_of(node.input, est, catalog, memo),
                            node.keys)
    if isinstance(node, N.Limit):
        return max(1, min(_rows_of(node.input, est, catalog, memo), node.n))
    if isinstance(node, N.UnionAll):
        return sum(_rows_of(b, est, catalog, memo) for b in node.branches)
    if isinstance(node, (N.Project, N.Exchange, N.Sort, N.Window)):
        return _rows_of(node.inputs()[0], est, catalog, memo)
    # sugar (SetOp/Exists/Having/CorrelatedAggFilter) is gone by the
    # time the CBO runs; estimate defensively if one slips through
    child = node.inputs()[0] if node.inputs() else None
    base = _rows_of(child, est, catalog, memo) if child is not None else 1
    return max(1, int(math.ceil(base * DEFAULT_SELECTIVITY)))


def estimate_rows(node: N.Node, est: Estimator, catalog) -> int:
    """Modeled output cardinality of one logical subtree."""
    return _rows_of(node, est, catalog, {})


def plan_cost(node: N.Node, est: Estimator, catalog,
              *, budget: Optional[int] = None) -> float:
    """Modeled scalar cost of a logical plan: per-operator work
    (rows + bytes materialized), exchange volume, and a spill-risk
    surcharge on stages whose working set exceeds an armed budget.
    Only RELATIVE values matter — the search and the premerge gate
    compare plans under the same model."""
    smemo: dict = {}
    rmemo: dict = {}
    seen: dict = {}

    def schema_of(n):
        return N.infer_schema(n, catalog, smemo)

    def passthrough(n) -> bool:
        from .. import exprs as ex
        return (isinstance(n, N.Project)
                and all(ex.is_col(e) == name for name, e in n.exprs))

    def walk(n) -> float:
        if id(n) in seen:
            return 0.0  # shared subtree (CTE): computed once
        seen[id(n)] = True
        c = sum(walk(i) for i in n.inputs())
        if passthrough(n):
            # a pure column permutation/narrowing materializes nothing
            # — column pruning and the reorder rules' restore Projects
            # both wrap subtrees in these, and charging them would make
            # a cost-improving reorder look like a regression
            return c
        rows = _rows_of(n, est, catalog, rmemo)
        width = row_width(schema_of(n))
        out_bytes = rows * width
        op = float(rows + out_bytes / 64.0)
        if isinstance(n, N.Join):
            rrows = _rows_of(n.right, est, catalog, rmemo)
            build_bytes = rrows * row_width(schema_of(n.right))
            op += 2.0 * build_bytes / 64.0  # build + probe table touch
        elif isinstance(n, N.Exchange):
            vol = out_bytes * (n.world - 1) / max(1, n.world)
            op += vol / 16.0  # moving a byte costs ~4x touching one
        elif isinstance(n, (N.Sort, N.Window)):
            op += rows * math.log2(max(2, rows))
        if budget and out_bytes > budget:
            op *= 1.0 + out_bytes / budget  # spill-risk surcharge
        return c + op

    return walk(node)


def choose_ooc_partitions(est_bytes: int, budget: int,
                          *, max_parts: int = 64) -> int:
    """Cost-model K for out-of-core degradation: per-partition fixed
    overhead (spill round-trip, sub-plan compile) makes cost increase
    with K, so the model picks the SMALLEST K whose calibrated
    per-partition peak fits half the budget — the other half covers
    the merge working set and partition skew. 0 when even ``max_parts``
    ways cannot fit."""
    cal = max(est_bytes, int(est_bytes * calibration_factor("aggregate")))
    for k in range(2, max_parts + 1):
        if (cal + k - 1) // k <= budget // 2:
            return k
    return 0
