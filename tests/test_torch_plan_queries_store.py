"""Port: the plan tier's TPC-DS queries over ``gen_store_wide``, first half
(q8, q9, q13, q15, q27, q28, q34: INTERSECT of zips, CASE buckets over
global aggregates, band stars, ROLLUP) against the JAX package. For each
query the optimized plan's ``structure()``, the rewrites fired, the
obligations, the fingerprint, every stage's kind and estimates, and the
result bits equal the reference's, and the port's rewrite is idempotent.
The JAX package's own tests hold these results to pandas and exact
``Fraction`` oracles, so parity inherits them. The sweep at the
reference's oracle scale (``PlanQueryDef.rows``) is slow. ``q3_plan``
and ``q55_plan`` are also held bit for bit to the port's hand-built
``q3`` / ``q55``."""

import pytest

from spark_rapids_jni_tpu.models import tpcds as jtpcds
from spark_rapids_jni_tpu.models import tpcds_plans as jtp

from spark_rapids_jni_tpu_torch import plan as PP
from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds
from spark_rapids_jni_tpu_torch.models import tpcds_plans as ptp
from test_torch_tpch import _assert_tables_equal
from torch_plan_parity import (_assert_tables_equal_port, check_registry_query, compile_both,
                               run_both)

QUERIES = ["q8", "q9", "q13", "q15", "q27", "q28", "q34"]
ROWS = 2000


# cases over 20 s alone run with -m slow; the faster cases of the same check stay in tier 1
SLOW = ['q8', 'q27', 'q28']


@pytest.mark.parametrize("name", [pytest.param(q, marks=pytest.mark.slow) if q in SLOW else q
                                  for q in QUERIES])
def test_plan_query_matches_reference(name):
    check_registry_query(name, ROWS)


@pytest.mark.slow
@pytest.mark.parametrize("name", QUERIES)
def test_plan_query_matches_reference_at_oracle_scale(name):
    check_registry_query(name, jtp.PLAN_QUERIES[name].rows)


@pytest.mark.parametrize("name,seed", [("q3", 11), ("q55", 12)])
def test_hand_built_greens_as_plans(name, seed):
    """``q3_plan`` / ``q55_plan`` compile and run as the reference's do,
    and give the port's hand-built ``q3`` / ``q55`` bit for bit, through
    one fused stage."""
    jt = jtpcds.gen_store(ROWS, seed=seed)
    pt = ptpcds.gen_store(ROWS, seed=seed, device="cpu")
    for t in jt:
        _assert_tables_equal(pt[t], jt[t])
    pcp, jcp = compile_both(getattr(jtp, f"{name}_plan")(), jt, pt, name=name)
    out = run_both(pcp, jcp)
    assert pcp.last_report["fused_stages"] == 1
    _assert_tables_equal_port(out, getattr(ptpcds, name)(pt))
    again = PP.compile_ir(getattr(ptp, f"{name}_plan")(), pt, name=name)()
    _assert_tables_equal_port(again, out)
