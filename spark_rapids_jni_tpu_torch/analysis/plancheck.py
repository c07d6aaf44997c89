"""``srjt-plancheck``: verify every checked-in plan of the port.

The CLI front door of the plan-verification tier (the verifier itself
lives in ``plan/verifier.py`` — see that docstring for the PLAN00x rule
catalog). For every query in the ``models/tpcds_plans.py`` registry,
plus the hand-built greens re-expressed as plans (q3/q55) and their
4-rank distributed variants, this tool:

1. binds small generator tables and checks the RAW plan's
   well-formedness (sugar nodes allowed — the optimizer owns them),
2. compiles it (rewrite fixpoint + lowering, no execution) and checks
   the OPTIMIZED plan with sugar banned (PLAN004),
3. discharges every rewrite obligation the engine emitted
   (translation validation, PLAN006),
4. checks per-stage ``memory_bytes`` estimate presence/monotonicity and
   the plan-level peak (PLAN005).

Run ``python -m spark_rapids_jni_tpu_torch.analysis.plancheck`` from the
repo root: exit 1 on any violation, ``--format=json|sarif`` through the
shared emitters in ``lint.py`` (exit-code parity with text mode), and
``--report <path>`` appends one JSON line per verified plan (the
``artifacts/plan_verify.jsonl`` contract). Tables are made on the card
unless ``--device cpu`` is given; ``run(tables=...)`` binds table sets
the caller already holds (one per generator name) instead of making
them. The differential fuzzer is the sibling CLI,
``python -m spark_rapids_jni_tpu_torch.analysis.planfuzz``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from .lint import write_findings

__all__ = ["run", "main", "catalog_of", "check_plan"]


def catalog_of(tables) -> Dict[str, dict]:
    return {t: {n: c.dtype for n, c in zip(tbl.names, tbl.columns)}
            for t, tbl in tables.items()}


def _targets(rows: int, queries: Optional[List[str]], device=None,
             tables: Optional[dict] = None
             ) -> List[Tuple[str, dict, object]]:
    """(name, bound tables, raw plan) for every checked-in plan: the
    whole PLAN_QUERIES registry plus the two re-expressed hand-built
    greens and their distributed variants. ``tables`` maps a generator's
    name to a table set to bind in place of a fresh one. Imports are
    lazy — the analysis package must stay import-light (torch only loads
    when a plan check actually runs)."""
    from ..models import tpcds
    from ..models import tpcds_plans as tp
    from ..plan.distribute import insert_exchanges

    known = set(tp.PLAN_QUERIES) | {"q3", "q55", "q3x4", "q55x4"}
    unknown = sorted(set(queries or ()) - known)
    if unknown:
        # a typo'd --queries must fail loudly, never verify an empty
        # set and report clean
        raise SystemExit(
            f"srjt-plancheck: unknown plan name(s) {unknown}; the "
            f"registry has {sorted(known)}")

    def bind(fn, seed):
        if tables is not None and fn.__name__ in tables:
            return tables[fn.__name__]
        return fn(rows, seed=seed, device=device)

    def wanted(name):
        return not queries or name in queries

    out = []
    for name, d in tp.PLAN_QUERIES.items():
        if wanted(name):
            out.append((name, bind(d.gen.generator, d.gen.seed), d.plan()))
    for name, seed, plan in (
            ("q3", 11, tp.q3_plan()), ("q55", 12, tp.q55_plan()),
            # the 4-rank distributed variants: same plans with exchange
            # stages inserted, verified like any other stage — the
            # verifier must accept what the cluster tier actually runs
            ("q3x4", 11, insert_exchanges(tp.q3_plan(), 4)),
            ("q55x4", 12, insert_exchanges(tp.q55_plan(), 4))):
        if wanted(name):
            out.append((name, bind(tpcds.gen_store, seed), plan))
    return out


def check_plan(name: str, tables, ir) -> Tuple[list, dict]:
    """Run all three verification layers over one bound plan. Returns
    (violations, report-record). Compilation is skipped when the raw
    plan is already malformed (one defect, one finding)."""
    from .. import plan as P

    where = f"plan:{name}"
    catalog = catalog_of(tables)
    violations = P.verify_plan(ir, catalog, desugared=False, where=where)
    record = {"kind": "plan", "query": name, "obligations": 0,
              "rewrites": {}, "est_peak_bytes": 0, "stages": 0}
    if not violations:
        cp = P.compile_ir(ir, tables, name=name)
        violations += P.verify_plan(cp.optimized, catalog, desugared=True,
                                    where=where)
        violations += P.verify_obligations(cp.obligations, catalog,
                                           where=where)
        violations += P.verify_estimates(cp, where=where)
        record.update(
            obligations=len(cp.obligations),
            rewrites=cp.rewrites_fired,
            est_peak_bytes=cp.estimated_memory_bytes,
            stages=len(cp.stages),
        )
    record["violations"] = len(violations)
    record["rules"] = sorted({v.rule for v in violations})
    return violations, record


def run(rows: int = 256, queries: Optional[List[str]] = None,
        report: Optional[str] = None, device=None,
        tables: Optional[dict] = None) -> Tuple[list, List[dict]]:
    violations: list = []
    records: List[dict] = []
    for name, bound, ir in _targets(rows, queries, device, tables):
        vs, rec = check_plan(name, bound, ir)
        violations += vs
        records.append(rec)
    if report:
        d = os.path.dirname(report)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(report, "a", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return violations, records


def main(argv=None) -> int:
    from ..utils import knobs

    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.analysis.plancheck",
        description="srjt-plancheck: plan-IR verifier + per-rewrite "
                    "translation validation over every checked-in plan")
    ap.add_argument("--rows", type=int,
                    default=knobs.get_int("SRJTORCH_PLANCHECK_ROWS"),
                    help="rows bound per generator when compiling the "
                    "checked-in plans (no execution happens)")
    ap.add_argument("--queries", default=None,
                    help="comma-separated subset of plan names "
                    "(default: the whole registry + q3/q55)")
    ap.add_argument("--device", default=None,
                    help="device the generator tables are made on "
                    "(default: the card)")
    ap.add_argument("--report", default=None,
                    help="append one JSON line per verified plan to this "
                    "path (the artifacts/plan_verify.jsonl contract)")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"),
                    help="findings format (exit code is identical in "
                    "every mode)")
    ap.add_argument("--out", default=None,
                    help="also write the formatted findings to this path")
    args = ap.parse_args(argv)
    queries = args.queries.split(",") if args.queries else None
    violations, _ = run(rows=args.rows, queries=queries, report=args.report,
                        device=args.device)
    return write_findings(violations, args.format, args.out,
                          "srjt-plancheck")


if __name__ == "__main__":
    sys.exit(main())
