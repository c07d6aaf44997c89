"""Port: the plan tier's TPC-DS queries over ``gen_store_returns``,
``gen_catalog`` and ``gen_web`` (q1, q30: decorrelated subqueries; q20,
q26, q32: the catalog star and its window ratio; q92) against the JAX
package. For each query the optimized plan's ``structure()``, the
rewrites fired, the obligations, the fingerprint, every stage's kind and
estimates, and the result bits equal the reference's, and the port's
rewrite is idempotent. The JAX package's own tests hold these results to
pandas and exact ``Fraction`` oracles, so parity inherits them. The
sweep at the reference's oracle scale (``PlanQueryDef.rows``) is slow."""

import pytest

from spark_rapids_jni_tpu.models import tpcds_plans as jtp

from torch_plan_parity import check_registry_query

QUERIES = ["q1", "q20", "q26", "q30", "q32", "q92"]
ROWS = 2000


# cases over 20 s alone run with -m slow; the faster cases of the same check stay in tier 1
SLOW = ['q1']


@pytest.mark.parametrize("name", [pytest.param(q, marks=pytest.mark.slow) if q in SLOW else q
                                  for q in QUERIES])
def test_plan_query_matches_reference(name):
    check_registry_query(name, ROWS)


@pytest.mark.slow
@pytest.mark.parametrize("name", QUERIES)
def test_plan_query_matches_reference_at_oracle_scale(name):
    check_registry_query(name, jtp.PLAN_QUERIES[name].rows)
