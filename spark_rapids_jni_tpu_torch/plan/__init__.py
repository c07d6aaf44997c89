"""The plan tier: logical-plan IR + rewrite passes + compiler (port of
the JAX package's ``plan/``).

The front-end that turns QUERIES.md "lowers" green mechanically: express
a TPC-DS query as a small relational-algebra tree (``nodes``), with a
typed expression layer (``exprs``); the optimizer (``rewrites``) applies
the standard executor expansions (decorrelation, ROLLUP, set ops,
EXISTS, HAVING, predicate/projection pushdown); the compiler
(``compiler``) lowers the optimized plan onto the fused
``CompiledPipeline`` tier where the grammar allows and the tested
``ops/`` operators elsewhere, carrying per-stage ``memory_bytes``
estimates for admission and the serve scheduler.

The port leaves out the out-of-core half (``plan/ooc.py``:
``OutOfCorePlan``, ``maybe_out_of_core``) and the memory governor's
admission of a compiled plan until the governor is ported (ROADMAP.md,
Open items, section 1, item 12b): ``compile_ir`` returns the
``CompiledPlan`` itself, as the reference does with out-of-core off.

Quick shape::

    from spark_rapids_jni_tpu_torch import plan as P

    ir = P.Sort(
        P.Aggregate(
            P.Join(P.Scan("fact"), P.Filter(P.Scan("dim"),
                   P.pcol("d_moy") == P.plit(11)),
                   on=(("f_date_sk", "d_date_sk"),)),
            keys=("f_key",),
            aggs=(P.AggSpec("f_price", "sum", "total"),),
        ),
        keys=(("total", False),),
    )
    out = P.compile_ir(ir, {"fact": fact, "dim": dim}, name="demo")()
"""

from .compiler import CompiledPlan, compile_ir, lower_ir  # noqa: F401
from .distribute import (  # noqa: F401
    exchange_context,
    insert_exchanges,
)
from .exprs import (  # noqa: F401
    PExpr,
    PlanError,
    pcol,
    plike,
    plit,
    ppart,
    prlike,
    pwhen,
)
from .nodes import (  # noqa: F401
    Aggregate,
    AggSpec,
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
    rollup,
    structure,
)
from .rewrites import (  # noqa: F401
    Obligation,
    ParamFingerprint,
    RewriteResult,
    fingerprint,
    parameterized_fingerprint,
    prune_columns,
    rebind_literals,
    rewrite,
)
from .verifier import (  # noqa: F401
    PlanViolation,
    verify_estimates,
    verify_obligations,
    verify_plan,
)

__all__ = [
    "CompiledPlan", "compile_ir", "lower_ir",
    "PExpr", "PlanError", "pcol", "plit", "pwhen", "plike", "prlike", "ppart",
    "Node", "Scan", "Filter", "Project", "Join", "Aggregate", "AggSpec",
    "Window", "Sort", "Limit", "UnionAll", "SetOp", "Exists", "Having",
    "CorrelatedAggFilter", "Exchange", "rollup", "infer_schema",
    "structure", "rewrite", "prune_columns", "RewriteResult", "Obligation",
    "fingerprint", "ParamFingerprint", "parameterized_fingerprint",
    "rebind_literals",
    "PlanViolation", "verify_plan", "verify_obligations",
    "verify_estimates", "insert_exchanges", "exchange_context",
]
