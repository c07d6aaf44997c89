"""Port: the plan tier's TPC-DS INTERSECT / EXCEPT chains over
``gen_channels`` (q38, q87) against the JAX package, checked as
``test_torch_plan_queries_channels.py`` checks the EXISTS family over
the same generator. The sweep at the reference's oracle scale
(``PlanQueryDef.rows``) is slow."""

import pytest

from spark_rapids_jni_tpu.models import tpcds_plans as jtp

from torch_plan_parity import check_registry_query

QUERIES = ["q38", "q87"]
ROWS = 2000


# q38 takes over 20 s alone: it runs with -m slow, q87's chain of the
# same set operations stays in tier 1
@pytest.mark.parametrize("name", [pytest.param("q38", marks=pytest.mark.slow), "q87"])
def test_plan_query_matches_reference(name):
    check_registry_query(name, ROWS)


@pytest.mark.slow
@pytest.mark.parametrize("name", QUERIES)
def test_plan_query_matches_reference_at_oracle_scale(name):
    check_registry_query(name, jtp.PLAN_QUERIES[name].rows)
