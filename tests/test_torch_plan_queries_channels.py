"""Port: the plan tier's TPC-DS EXISTS / NOT EXISTS queries over
``gen_channels`` (q10, q35, q69) against the JAX package; the INTERSECT /
EXCEPT chains over the same generator are in
``test_torch_plan_queries_setops.py``. For each query the optimized
plan's ``structure()``, the rewrites fired, the obligations, the
fingerprint, every stage's kind and estimates, and the result bits equal
the reference's, and the port's rewrite is idempotent. The JAX package's
own tests hold these results to pandas and exact ``Fraction`` oracles,
so parity inherits them. The sweep at the reference's oracle scale
(``PlanQueryDef.rows``) is slow."""

import pytest

from spark_rapids_jni_tpu.models import tpcds_plans as jtp

from torch_plan_parity import check_registry_query

QUERIES = ["q10", "q35", "q69"]
ROWS = 2000


@pytest.mark.parametrize("name", QUERIES)
def test_plan_query_matches_reference(name):
    check_registry_query(name, ROWS)


@pytest.mark.slow
@pytest.mark.parametrize("name", QUERIES)
def test_plan_query_matches_reference_at_oracle_scale(name):
    check_registry_query(name, jtp.PLAN_QUERIES[name].rows)
