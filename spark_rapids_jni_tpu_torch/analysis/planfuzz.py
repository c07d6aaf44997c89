"""``srjt-planfuzz``: random-plan differential fuzzer over the port's
plan tier.

The third srjt-plancheck layer. The verifier (``plan/verifier.py``)
checks STRUCTURE — well-formed IR, discharged rewrite obligations,
consistent estimates — but a structural check cannot prove a rewrite
chain computes the right ANSWER on data. This tool closes that gap:

1. **Generate** small typed plans over the TPC-DS generator schemas
   (``models/tpcds.gen_store_wide``), seeded and fully deterministic —
   no wall clock, no ambient randomness (the workflow discipline): every
   plan is a pure function of ``(base seed, plan index)``. Templates
   cover the rewrite catalog: star joins + filters + projections +
   (grouped/global/ROLLUP) aggregates + HAVING + sort/limit, correlated
   scalar-aggregate filters (the q1 decorrelation family), INTERSECT/
   EXCEPT chains, EXISTS/NOT EXISTS, UNION ALL of fused count stars, and
   DISTINCT + semi/anti operator-tier chains.

2. **Execute** each plan through the real pipeline — rewrite fixpoint →
   compile → run — and against a DIRECT-PLAN-INTERPRETATION oracle: a
   node-by-node evaluator over plain Python rows that understands the
   sugar nodes natively (no rewriting), computes aggregates exactly
   (``fractions.Fraction`` sums/means — the engine's exact-FLOAT64
   contract), and speaks the same 3VL the runtime tier does. Results
   ALWAYS compare as multisets — ordering is deliberately out of scope
   here (the per-query oracle tests pin ORDER BY); the generator still
   places a total-order Sort under every Limit so the retained row SET
   is deterministic on both sides.

3. **Bisect** any mismatch to the first rewrite application in the
   chain: the rewrite engine's fire sequence is deterministic, so
   replaying it with ``rewrite(..., max_fires=k, prune=False)`` and
   re-interpreting the partially-rewritten plan (the oracle interprets
   sugar directly, so EVERY prefix is interpretable) localizes the first
   semantics-breaking fire — reported with its rule name and subtree
   fingerprints. A chain whose every prefix is oracle-clean blames the
   lowering instead.

The generator draws exactly the JAX package's plans: one seed builds the
same template with the same fingerprint in both packages. The engine
runs where the bound tables are — on the card unless ``device`` says
otherwise; the oracle always runs on the host.

Run ``python -m spark_rapids_jni_tpu_torch.analysis.planfuzz``: seeds
default to ``SRJTORCH_PLANCHECK_FUZZ_SEEDS``, plans-per-seed to
``SRJTORCH_PLANCHECK_FUZZ_PLANS``; exit 1 on any mismatch (PLAN007) or
verifier violation, ``--format/--out`` through the shared lint emitters,
``--report`` appends per-seed JSON lines to the
``artifacts/plan_verify.jsonl`` contract.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from .lint import write_findings
from .plancheck import catalog_of

__all__ = ["gen_plan", "interpret", "canon", "rel_of_table",
           "bisect_mismatch", "fuzz_one", "run", "main"]


# ---------------------------------------------------------------------------
# the oracle: direct plan interpretation over python rows
# ---------------------------------------------------------------------------

Rel = Tuple[List[str], List[tuple]]  # (column names, row tuples; None=NULL)


def rel_of_table(t) -> Rel:
    """Engine Table -> plain python rows (lanes viewed as the type's
    storage, FLOAT64 bit lanes viewed back to floats, validity folded to
    None); the table may lie on any device."""
    import numpy as np

    from ..columnar.dtype import TypeId

    cols = []
    for name, c in zip(t.names, t.columns):
        arr = c.data.cpu().numpy().view(c.dtype.np_dtype)
        if c.dtype.id == TypeId.FLOAT64:
            vals = arr.view(np.float64).tolist()
        else:
            vals = arr.tolist()
        if c.validity is not None:
            m = c.validity.cpu().numpy()
            vals = [v if ok else None for v, ok in zip(vals, m)]
        cols.append(vals)
    return list(t.names), [tuple(r) for r in zip(*cols)] if cols else []


def canon(rows: List[tuple]) -> List[tuple]:
    """Multiset-canonical row order (None sorts first per column)."""
    return sorted(rows, key=lambda r: tuple(
        (v is None, 0 if v is None else v) for v in r))


def _ev(e, idx: Dict[str, int], row: tuple):
    """Evaluate one plan expression over one row, 3VL (None = NULL).
    Mirrors the runtime tier's semantics for everything the generator
    emits; unsupported expression kinds raise."""
    from ..plan import exprs as pex

    if isinstance(e, pex._PCol):
        return row[idx[e.name]]
    if isinstance(e, pex._PLit):
        v = e.value
        if v is None:
            return None
        if isinstance(v, bool):
            return bool(v)
        if isinstance(v, float):
            return float(v)
        return int(v)
    if isinstance(e, pex._PNot):
        a = _ev(e.a, idx, row)
        return None if a is None else (not a)
    if isinstance(e, pex._PIsNull):
        a = _ev(e.a, idx, row)
        return (a is None) if e.want_null else (a is not None)
    if isinstance(e, pex._PCast):
        a = _ev(e.a, idx, row)
        if a is None:
            return None
        return float(a) if e.d.is_floating else int(a)
    if isinstance(e, pex._PWhen):
        c = _ev(e.cond, idx, row)
        return _ev(e.then, idx, row) if c is True else _ev(e.other, idx, row)
    if isinstance(e, pex._PBin):
        a = _ev(e.a, idx, row)
        b = _ev(e.b, idx, row)
        op = e.op
        if op == "and":  # Kleene
            if a is False or b is False:
                return False
            if a is None or b is None:
                return None
            return True
        if op == "or":
            if a is True or b is True:
                return True
            if a is None or b is None:
                return None
            return False
        if a is None or b is None:
            return None
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
        if op == "div":
            return a / b
        if op == "mod":
            return a % b
        return {"eq": a == b, "ne": a != b, "lt": a < b, "le": a <= b,
                "gt": a > b, "ge": a >= b}[op]
    raise ValueError(f"oracle cannot evaluate {type(e).__name__}")


def _exact_sum(vals) -> float:
    return float(sum(Fraction(v) for v in vals))


def _agg_value(vals: list, group_size: int, how: str):
    """One aggregate over one group's non-null values — exact, matching
    the engine's materialization contract (counts int, everything else
    FLOAT64 value)."""
    if how == "count_all":
        return group_size
    if how == "count":
        return len(vals)
    if how == "nunique":
        return len(set(vals))
    if not vals:
        return None
    if how == "sum":
        return _exact_sum(vals)
    if how == "mean":
        return float(sum(Fraction(v) for v in vals) / len(vals))
    if how == "min":
        return float(min(vals))
    if how == "max":
        return float(max(vals))
    raise ValueError(f"oracle cannot compute aggregate {how!r}")


def _group(rows: List[tuple], key_idx: List[int]) -> Dict[tuple, List[tuple]]:
    out: Dict[tuple, List[tuple]] = {}
    for r in rows:
        out.setdefault(tuple(r[i] for i in key_idx), []).append(r)
    return out


def _agg_rows(rows, names, keys, aggs) -> Rel:
    out_names = list(keys) + [a.name for a in aggs]
    key_idx = [names.index(k) for k in keys]
    src_idx = {a.name: (None if a.source is None else names.index(a.source))
               for a in aggs}
    if not keys:
        if not rows and not aggs:
            return out_names, []
        if not rows:
            # SQL global aggregate over empty input: ONE row, counts 0
            row = tuple(_agg_value([], 0, a.how) for a in aggs)
            return out_names, [row]
        groups = {(): rows}
    else:
        groups = _group(rows, key_idx)
    out = []
    for key, grows in groups.items():
        vals_of = {}
        for a in aggs:
            si = src_idx[a.name]
            vals_of[a.name] = ([] if si is None
                               else [r[si] for r in grows if r[si] is not None])
        out.append(tuple(key) + tuple(
            _agg_value(vals_of[a.name], len(grows), a.how) for a in aggs))
    return out_names, out


def interpret(node, rels: Dict[str, Rel], _memo=None) -> Rel:
    """Direct plan interpretation: the differential oracle. Handles the
    sugar nodes NATIVELY (per their documented semantics), so any prefix
    of the rewrite chain — including the unrewritten plan — is
    interpretable; node sharing is memoized like the compiler does."""
    memo = {} if _memo is None else _memo
    key = id(node)
    if key in memo:
        return memo[key]
    out = _interp(node, rels, memo)
    memo[key] = out
    return out


def _interp(node, rels, memo) -> Rel:
    from ..plan import nodes as pn

    if isinstance(node, pn.Scan):
        names, rows = rels[node.table]
        if node.columns is None:
            return list(names), list(rows)
        sel = [names.index(c) for c in node.columns]
        return list(node.columns), [tuple(r[i] for i in sel) for r in rows]

    if isinstance(node, (pn.Filter, pn.Having)):
        names, rows = interpret(node.input, rels, memo)
        idx = {n: i for i, n in enumerate(names)}
        return names, [r for r in rows
                       if _ev(node.predicate, idx, r) is True]

    if isinstance(node, pn.Project):
        names, rows = interpret(node.input, rels, memo)
        idx = {n: i for i, n in enumerate(names)}
        out_names = [n for n, _ in node.exprs]
        return out_names, [tuple(_ev(e, idx, r) for _, e in node.exprs)
                           for r in rows]

    if isinstance(node, pn.Join):
        lnames, lrows = interpret(node.left, rels, memo)
        rnames, rrows = interpret(node.right, rels, memo)
        lk = [lnames.index(l) for l, _ in node.on]
        rk = [rnames.index(r) for _, r in node.on]
        rkeys = {r for _, r in node.on}
        keep_r = [i for i, n in enumerate(rnames) if n not in rkeys]
        index: Dict[tuple, list] = {}
        for r in rrows:
            k = tuple(r[i] for i in rk)
            if any(v is None for v in k):
                continue  # NULL keys never match
            index.setdefault(k, []).append(r)
        out_names = list(lnames) + [rnames[i] for i in keep_r]
        out = []
        if node.how in ("semi", "anti"):
            want = node.how == "semi"
            return list(lnames), [
                r for r in lrows
                if (tuple(r[i] for i in lk) in index) == want
            ]
        for lr in lrows:
            k = tuple(lr[i] for i in lk)
            matches = index.get(k, []) if not any(v is None for v in k) else []
            for rr in matches:
                out.append(lr + tuple(rr[i] for i in keep_r))
            if not matches and node.how in ("left", "full"):
                out.append(lr + tuple(None for _ in keep_r))
        if node.how == "full":
            matched = {id(rr) for m in index.values() for rr in m
                       if any(tuple(lr[i] for i in lk) ==
                              tuple(rr[i] for i in rk) for lr in lrows)}
            for rr in rrows:
                if id(rr) not in matched:
                    row = [None] * len(lnames)
                    for (l, _), i in zip(node.on, rk):
                        row[lnames.index(l)] = rr[i]
                    out.append(tuple(row) + tuple(rr[i] for i in keep_r))
        return out_names, out

    if isinstance(node, pn.Aggregate):
        names, rows = interpret(node.input, rels, memo)
        if node.grouping_sets is not None:
            out_names = list(node.keys) + [a.name for a in node.aggs]
            out: List[tuple] = []
            for gs in node.grouping_sets:
                _, grows = _agg_rows(rows, names, gs, node.aggs)
                # re-order onto the full key list, rolled keys NULL
                for r in grows:
                    kmap = dict(zip(gs, r[:len(gs)]))
                    out.append(tuple(kmap.get(k) for k in node.keys)
                               + r[len(gs):])
            return out_names, out
        return _agg_rows(rows, names, node.keys, node.aggs)

    if isinstance(node, pn.Sort):
        names, rows = interpret(node.input, rels, memo)
        rows = list(rows)
        for col, asc in reversed(node.keys):
            i = names.index(col)
            rows.sort(key=lambda r: r[i], reverse=not asc)
        return names, rows

    if isinstance(node, pn.Limit):
        names, rows = interpret(node.input, rels, memo)
        return names, rows[:node.n]

    if isinstance(node, pn.UnionAll):
        first_names, out = interpret(node.branches[0], rels, memo)
        out = list(out)
        for b in node.branches[1:]:
            names, rows = interpret(b, rels, memo)
            if names != first_names:
                raise ValueError("oracle: union branch names differ")
            out += rows
        return first_names, out

    # -- sugar nodes, interpreted natively ---------------------------------

    if isinstance(node, pn.SetOp):
        lnames, lrows = interpret(node.left, rels, memo)
        _, rrows = interpret(node.right, rels, memo)
        rset = set(rrows)
        seen = set()
        out = []
        for r in lrows:  # set semantics: dedup the left side
            if r in seen:
                continue
            seen.add(r)
            if (r in rset) == (node.kind == "intersect"):
                out.append(r)
        return lnames, out

    if isinstance(node, pn.Exists):
        names, rows = interpret(node.input, rels, memo)
        snames, srows = interpret(node.sub, rels, memo)
        li = [names.index(l) for l, _ in node.on]
        si = [snames.index(r) for _, r in node.on]
        sset = {tuple(r[i] for i in si) for r in srows}
        want = not node.negated
        return names, [r for r in rows
                       if (tuple(r[i] for i in li) in sset) == want]

    if isinstance(node, pn.CorrelatedAggFilter):
        names, rows = interpret(node.input, rels, memo)
        snames, srows = interpret(node.sub, rels, memo)
        pk, bk = node.on
        groups = _group(srows, [snames.index(bk)])
        a = node.agg
        si = None if a.source is None else snames.index(a.source)
        aggval = {}
        for k, grows in groups.items():
            vals = ([] if si is None
                    else [r[si] for r in grows if r[si] is not None])
            aggval[k[0]] = _agg_value(vals, len(grows), a.how)
        out_names = list(names) + [a.name]
        idx = {n: i for i, n in enumerate(out_names)}
        pi = names.index(pk)
        out = []
        for r in rows:
            if r[pi] not in aggval:
                continue  # empty subquery group: the inner join drops it
            ext = r + (aggval[r[pi]],)
            if _ev(node.predicate, idx, ext) is True:
                out.append(ext)
        return out_names, out

    raise ValueError(f"oracle cannot interpret {type(node).__name__}")


# ---------------------------------------------------------------------------
# the generator: seeded typed plans over the gen_store_wide star
# ---------------------------------------------------------------------------

# (table, fact FK, dim PK, filterable int columns with [lo, hi) domains)
_DIMS = (
    ("date_dim", "ss_sold_date_sk", "d_date_sk",
     (("d_year", 1998, 2003), ("d_moy", 1, 13), ("d_dow", 0, 7))),
    ("store", "ss_store_sk", "s_store_sk", (("s_state", 0, 10),)),
    ("household_demographics", "ss_hdemo_sk", "hd_demo_sk",
     (("hd_dep_count", 0, 10), ("hd_vehicle_count", 0, 5))),
    ("customer_demographics", "ss_cdemo_sk", "cd_demo_sk",
     (("cd_gender", 0, 2), ("cd_marital_status", 0, 5))),
    ("time_dim", "ss_sold_time_sk", "t_time_sk", (("t_hour", 0, 24),)),
)
_MEASURES = ("ss_quantity", "ss_list_price", "ss_coupon_amt",
             "ss_sales_price", "ss_ext_sales_price")
_FACT_KEYS = ("ss_store_sk", "ss_hdemo_sk", "ss_cdemo_sk")
_AGG_HOWS = ("sum", "mean", "min", "max", "count")


def _int_pred(rng, col: str, lo: int, hi: int):
    from ..plan import pcol, plit

    kind = rng.random()
    if kind < 0.3:
        a = int(rng.integers(lo, hi))
        b = int(rng.integers(lo, hi))
        return (pcol(col) == plit(a)) | (pcol(col) == plit(b))
    if kind < 0.55:
        return pcol(col) == plit(int(rng.integers(lo, hi)))
    if kind < 0.8:
        return pcol(col) >= plit(int(rng.integers(lo, hi)))
    return pcol(col) <= plit(int(rng.integers(lo, hi)))


def _dim_pred(rng, cols):
    col, lo, hi = cols[int(rng.integers(0, len(cols)))]
    return _int_pred(rng, col, lo, hi)


def _fact_pred(rng):
    from ..plan import pcol, plit

    if rng.random() < 0.5:
        return _int_pred(rng, "ss_quantity", 1, 100)
    lo = round(float(rng.uniform(1, 150)), 1)
    return pcol("ss_list_price") >= plit(lo)


def _star_chain(rng, max_dims: int = 3):
    """Fact scan + 1..max_dims dim joins (each optionally filtered) +
    optional fact filter. Returns (node, payload column names)."""
    from ..plan import Filter, Join, Scan

    x = Scan("store_sales")
    ndims = int(rng.integers(1, max_dims + 1))
    picks = sorted(int(i) for i in
                   rng.choice(len(_DIMS), size=ndims, replace=False))
    payloads: List[str] = []
    for di in picks:
        tbl, fk, pk, cols = _DIMS[di]
        right = Scan(tbl)
        if rng.random() < 0.8:
            right = Filter(right, _dim_pred(rng, cols))
        x = Join(x, right, on=((fk, pk),),
                 bounded=bool(rng.random() < 0.5))
        payloads += [c for c, _, _ in cols]
    if rng.random() < 0.5:
        x = Filter(x, _fact_pred(rng))
        if rng.random() < 0.4:  # stacked filters: merge_filters fires
            x = Filter(x, _fact_pred(rng))
    return x, payloads


def _t_star(rng):
    from ..plan import AggSpec, Aggregate, Having, Limit, Project, Sort
    from ..plan import pcol, plit, rollup

    x, payloads = _star_chain(rng)
    measures = list(_MEASURES)
    if rng.random() < 0.25:
        # computed measure: passthrough everything + one derived column
        m = str(rng.choice(("ss_list_price", "ss_sales_price")))
        factor = round(float(rng.uniform(0.5, 2.0)), 2)
        exprs = [(c, pcol(c)) for c in
                 ("ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                  "ss_hdemo_sk", "ss_store_sk", "ss_sold_time_sk",
                  "ss_quantity", "ss_list_price", "ss_coupon_amt",
                  "ss_sales_price", "ss_ext_sales_price")]
        exprs += [(c, pcol(c)) for c in payloads]
        exprs.append(("m0", pcol(m) * plit(factor)))
        x = Project(x, tuple(exprs))
        measures.append("m0")
        if rng.random() < 0.5:
            # filter over a passthrough column above the project:
            # push_filter_through_project fires
            from ..plan import Filter

            x = Filter(x, _fact_pred(rng))
    nkeys = int(rng.integers(0, 3))
    keypool = list(_FACT_KEYS) + payloads
    keys: tuple = ()
    if nkeys:
        keys = tuple(str(k) for k in
                     rng.choice(keypool, size=nkeys, replace=False))
    naggs = int(rng.integers(1, 4))
    picks = sorted(int(i) for i in
                   rng.choice(len(measures), size=min(naggs, len(measures)),
                              replace=False))
    aggs = [AggSpec(measures[mi], str(rng.choice(_AGG_HOWS)), f"a{j}")
            for j, mi in enumerate(picks)]
    if rng.random() < 0.3:
        aggs.append(AggSpec(None, "count_all", "cnt"))
    gs = rollup(*keys) if (keys and rng.random() < 0.25) else None
    out = Aggregate(x, keys=keys, aggs=tuple(aggs), grouping_sets=gs)
    if gs is None:
        if rng.random() < 0.35:
            out = Having(out, pcol(aggs[0].name)
                         > plit(round(float(rng.uniform(0, 40)), 1)))
        if rng.random() < 0.4:
            out_cols = list(keys) + [a.name for a in aggs]
            out = Limit(
                Sort(out, tuple((c, bool(rng.random() < 0.7))
                                for c in out_cols)),
                int(rng.integers(1, 25)))
    return out


def _t_corr(rng):
    from ..plan import AggSpec, Aggregate, CorrelatedAggFilter, pcol, plit

    x, _ = _star_chain(rng, max_dims=1)
    k1, k2 = (str(k) for k in rng.choice(_FACT_KEYS, size=2, replace=False))
    m = str(rng.choice(_MEASURES))
    ctr = Aggregate(x, keys=(k1, k2), aggs=(AggSpec(m, "sum", "rev"),))
    factor = float(rng.choice((0.5, 0.8, 1.0, 1.2)))
    caf = CorrelatedAggFilter(
        ctr, ctr, on=(k2, k2), agg=AggSpec("rev", "mean", "ave"),
        predicate=pcol("rev") > plit(factor) * pcol("ave"))
    return Aggregate(caf, keys=(k2,),
                     aggs=(AggSpec(None, "count_all", "cnt"),))


def _t_setop(rng):
    from ..plan import (AggSpec, Aggregate, Filter, Join, Project, Scan,
                        SetOp, pcol)

    def branch():
        x = Join(
            Scan("store_sales"),
            Filter(Scan("date_dim"), _dim_pred(rng, _DIMS[0][3])),
            on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
        return Project(x, (("k", pcol("ss_customer_sk")),))

    kind = str(rng.choice(("intersect", "except")))
    chain = SetOp(branch(), branch(), kind)
    if rng.random() < 0.4:
        chain = SetOp(chain, branch(), str(rng.choice(("intersect",
                                                       "except"))))
    return Aggregate(chain, keys=(),
                     aggs=(AggSpec(None, "count_all", "cnt"),))


def _t_exists(rng):
    from ..plan import AggSpec, Aggregate, Exists, Filter, Join, Scan

    sub = Join(Scan("store_sales"),
               Filter(Scan("date_dim"), _dim_pred(rng, _DIMS[0][3])),
               on=(("ss_sold_date_sk", "d_date_sk"),), bounded=True)
    x = Exists(Scan("customer"), sub,
               on=(("c_customer_sk", "ss_customer_sk"),),
               negated=bool(rng.random() < 0.5))
    keys = ("c_current_addr_sk",) if rng.random() < 0.4 else ()
    return Aggregate(x, keys=keys,
                     aggs=(AggSpec(None, "count_all", "cnt"),))


def _t_union(rng):
    from ..plan import (AggSpec, Aggregate, Filter, Join, Project, Scan,
                        UnionAll, pcol, plit)
    import numpy as np

    branches = []
    for b in range(int(rng.integers(2, 4))):
        x = Join(Scan("store_sales"),
                 Filter(Scan("time_dim"), _int_pred(rng, "t_hour", 0, 24)),
                 on=(("ss_sold_time_sk", "t_time_sk"),), bounded=True)
        agg = Aggregate(x, keys=(),
                        aggs=(AggSpec(None, "count_all", "cnt"),))
        branches.append(Project(agg, (
            ("band", plit(np.int32(b))), ("cnt", pcol("cnt")))))
    out = UnionAll(tuple(branches))
    if rng.random() < 0.5:
        # filter above the union: push_filter_through_union fires
        out = Filter(out, pcol("cnt") >= plit(int(rng.integers(0, 12))))
    return out


def _t_optier(rng):
    from ..plan import Aggregate, Filter, Join, Limit, Scan, Sort

    keys = ("ss_store_sk", "ss_hdemo_sk") if rng.random() < 0.5 \
        else ("ss_store_sk",)
    dedup = Aggregate(Scan("store_sales"), keys=keys, aggs=())
    j = Join(dedup, Filter(Scan("store"), _dim_pred(rng, _DIMS[1][3])),
             on=(("ss_store_sk", "s_store_sk"),),
             how=str(rng.choice(("semi", "anti"))))
    return Limit(Sort(j, tuple((k, True) for k in keys)),
                 int(rng.integers(1, 30)))


def _t_multijoin(rng):
    """srjt-cbo: 3-5 dim star joined in the generator's
    (arbitrary) order, with strategy hints drawn from the full
    {None, True, False} tri-state, optionally extended by a fact ->
    customer [-> customer_address] chain hop. This is every CBO rule's
    habitat: ``cbo_reorder_joins`` (multi-dim inner star),
    ``cbo_join_strategy`` (``bounded=None`` abstentions), and
    ``cbo_build_side`` (the backwards-authored PK->FK variant probes
    from the unique-keyed side into a 4x bigger build, so the commute
    fires)."""
    from ..plan import AggSpec, Aggregate, Filter, Join, Scan

    if rng.random() < 0.3:
        # backwards-authored: customer_address (unique ca_address_sk,
        # <= 500 rows) probes into customer (2000 rows) — exactly the
        # shape cbo_build_side exists to flip
        y = Scan("customer_address")
        if rng.random() < 0.6:
            y = Filter(y, _int_pred(rng, "ca_zip5", 0, 300))
        y = Join(y, Scan("customer"),
                 on=(("ca_address_sk", "c_current_addr_sk"),))
        how = str(rng.choice(_AGG_HOWS[:2]))  # int measure: sum/mean
        return Aggregate(y, keys=("ca_zip5",),
                         aggs=(AggSpec("c_customer_id", how, "a0"),
                               AggSpec(None, "count_all", "cnt")))
    x = Scan("store_sales")
    ndims = int(rng.integers(3, 6))
    picks = [int(i) for i in
             rng.choice(len(_DIMS), size=min(ndims, len(_DIMS)),
                        replace=False)]
    payloads: List[str] = []
    for di in picks:
        tbl, fk, pk, cols = _DIMS[di]
        right = Scan(tbl)
        if rng.random() < 0.6:
            right = Filter(right, _dim_pred(rng, cols))
        hint = (None, True, False)[int(rng.integers(0, 3))]
        x = Join(x, right, on=((fk, pk),), bounded=hint)
        payloads += [c for c, _, _ in cols]
    if rng.random() < 0.5:
        x = Join(x, Scan("customer"),
                 on=(("ss_customer_sk", "c_customer_sk"),))
        payloads += ["c_current_addr_sk", "c_customer_id"]
        if rng.random() < 0.5:
            # snowflake hop: probe key is customer payload, not a fact
            # column — the reorder rule must leave this chain alone
            x = Join(x, Scan("customer_address"),
                     on=(("c_current_addr_sk", "ca_address_sk"),))
            payloads += ["ca_zip5"]
    nkeys = int(rng.integers(1, 3))
    keypool = list(_FACT_KEYS) + payloads
    keys = tuple(str(k) for k in
                 rng.choice(keypool, size=nkeys, replace=False))
    m = str(rng.choice(_MEASURES))
    aggs = (AggSpec(m, str(rng.choice(_AGG_HOWS)), "a0"),
            AggSpec(None, "count_all", "cnt"))
    return Aggregate(x, keys=keys, aggs=aggs)


_TEMPLATES = (
    ("star", _t_star, 0.30),
    ("corr", _t_corr, 0.12),
    ("setop", _t_setop, 0.12),
    ("exists", _t_exists, 0.12),
    ("union", _t_union, 0.14),
    ("optier", _t_optier, 0.10),
    ("multijoin", _t_multijoin, 0.10),
)


def gen_plan(rng) -> Tuple[object, str]:
    """One seeded plan. Deterministic in the generator state — the
    fuzzer's whole chain (generate -> rewrite -> compile -> oracle ->
    bisect) is a pure function of the seed."""
    r = rng.random()
    acc = 0.0
    for name, fn, w in _TEMPLATES:
        acc += w
        if r < acc:
            return fn(rng), name
    name, fn, _ = _TEMPLATES[-1]
    return fn(rng), name


# ---------------------------------------------------------------------------
# differential run + bisection
# ---------------------------------------------------------------------------


def bisect_mismatch(ir, rels, catalog, rules=None) -> dict:
    """Localize a compiler-vs-oracle mismatch to the FIRST rewrite
    application that changes the plan's interpreted result. Replays the
    engine's deterministic fire sequence prefix by prefix (the oracle
    interprets sugar natively, so every prefix is interpretable); a
    chain whose prefixes are all clean blames the lowering."""
    from ..plan import rewrites as rw

    base_names, base_rows = interpret(ir, rels)
    base = (base_names, canon(base_rows))
    full = rw.rewrite(ir, catalog, rules=rules, prune=False)
    for k in range(1, len(full.obligations) + 1):
        pk = rw.rewrite(ir, catalog, rules=rules, max_fires=k, prune=False)
        names, rows = interpret(pk.plan, rels)
        if (names, canon(rows)) != base:
            ob = pk.obligations[-1]
            return {"first_bad_fire": k, "rule": ob.rule,
                    "before_fp": ob.before_fp, "after_fp": ob.after_fp}
    pruned = rw.rewrite(ir, catalog, rules=rules, prune=True)
    names, rows = interpret(pruned.plan, rels)
    if (names, canon(rows)) != base:
        return {"first_bad_fire": len(full.obligations) + 1,
                "rule": "prune_columns"}
    return {"first_bad_fire": None, "rule": "lowering",
            "detail": "every rewrite prefix is oracle-clean; the "
                      "divergence is in compile/execute"}


def fuzz_one(plan_seed: int, tables, rels, catalog,
             where: str) -> Tuple[list, dict]:
    """Generate + verify + differentially execute ONE plan. Returns
    (findings, {template, rewrites, mismatch})."""
    import numpy as np

    from .. import plan as P

    rng = np.random.default_rng(plan_seed)
    ir, template = gen_plan(rng)
    info = {"template": template, "rewrites": {}, "mismatch": False}
    findings = P.verify_plan(ir, catalog, desugared=False, where=where)
    if findings:
        return findings, info
    cp = P.compile_ir(ir, tables, name=where.replace(":", "_"))
    findings += P.verify_plan(cp.optimized, catalog, desugared=True,
                              where=where)
    findings += P.verify_obligations(cp.obligations, catalog, where=where)
    findings += P.verify_estimates(cp, where=where)
    info["rewrites"] = cp.rewrites_fired
    got_names, got_rows = rel_of_table(cp())
    want_names, want_rows = interpret(ir, rels)
    if got_names != want_names or canon(got_rows) != canon(want_rows):
        from ..plan.verifier import PlanViolation

        info["mismatch"] = True
        blame = bisect_mismatch(ir, rels, catalog)
        findings.append(PlanViolation(
            where, "PLAN007",
            f"compiler-vs-oracle mismatch on a generated {template!r} plan "
            f"(engine {len(got_rows)} rows / columns {got_names} vs oracle "
            f"{len(want_rows)} rows / columns {want_names}); bisected to "
            f"{blame}"))
    return findings, info


def run(seeds: List[int], plans: int, rows: int = 160,
        report: Optional[str] = None, device=None) -> Tuple[list, List[dict]]:
    from ..models.tpcds import gen_store_wide

    tables = gen_store_wide(rows, seed=97, device=device)
    rels = {t: rel_of_table(tbl) for t, tbl in tables.items()}
    catalog = catalog_of(tables)
    findings: list = []
    records: List[dict] = []
    for seed in seeds:
        mismatches = violations = 0
        fired: Dict[str, int] = {}
        templates: Dict[str, int] = {}
        for i in range(plans):
            fs, info = fuzz_one(seed * 100003 + i, tables, rels, catalog,
                                where=f"fuzz:{seed}/{i}")
            findings += fs
            mismatches += int(info["mismatch"])
            violations += sum(1 for v in fs if v.rule != "PLAN007")
            templates[info["template"]] = templates.get(info["template"], 0) + 1
            for r, n in info["rewrites"].items():
                fired[r] = fired.get(r, 0) + n
        records.append({"kind": "fuzz", "seed": seed, "plans": plans,
                        "rows": rows, "mismatches": mismatches,
                        "violations": violations, "rewrites": fired,
                        "templates": templates})
    if report:
        d = os.path.dirname(report)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(report, "a", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return findings, records


def main(argv=None) -> int:
    from ..utils import knobs

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.analysis.planfuzz",
        description="srjt-planfuzz: seeded random-plan differential "
                    "fuzzer — rewrite+compile+execute vs direct plan "
                    "interpretation, with first-bad-rewrite bisection")
    ap.add_argument("--seed", type=int, default=None,
                    help="single base seed (overrides --seeds / the knob)")
    ap.add_argument("--seeds",
                    default=knobs.get_str("SRJTORCH_PLANCHECK_FUZZ_SEEDS"),
                    help="comma-separated base seeds")
    ap.add_argument("--plans", type=int,
                    default=knobs.get_int("SRJTORCH_PLANCHECK_FUZZ_PLANS"),
                    help="plans generated per seed")
    ap.add_argument("--rows", type=int, default=160,
                    help="fact rows in the bound generator tables")
    ap.add_argument("--device", default=None,
                    help="device the tables are made and the plans run "
                    "on (default: the card)")
    ap.add_argument("--report", default=None,
                    help="append one JSON line per seed to this path "
                    "(the artifacts/plan_verify.jsonl contract)")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = ([args.seed] if args.seed is not None
             else [int(s) for s in str(args.seeds).split(",") if s.strip()])
    findings, records = run(seeds, args.plans, rows=args.rows,
                            report=args.report, device=args.device)
    total = sum(r["plans"] for r in records)
    mism = sum(r["mismatches"] for r in records)
    print(f"srjt-planfuzz: {total} plans over seeds {seeds}: "
          f"{mism} mismatch(es), "
          f"{sum(r['violations'] for r in records)} violation(s)",
          file=sys.stderr)
    return write_findings(findings, args.format, args.out, "srjt-planfuzz")


if __name__ == "__main__":
    sys.exit(main())
