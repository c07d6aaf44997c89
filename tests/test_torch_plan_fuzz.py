"""Port: differential fuzzing of the plan tier through both compilers.
Seeded plans from the JAX package's ``analysis/planfuzz.gen_plan`` (star
joins with filters, projections, grouped / global / ROLLUP aggregates and
HAVING, correlated scalar-aggregate filters, INTERSECT / EXCEPT chains,
EXISTS / NOT EXISTS, UNION ALL of fused count stars, DISTINCT +
semi / anti operator-tier chains) are carried into the port with
``tests/torch_plan_carry.py`` and compiled and run by both packages over
the same ``gen_store_wide`` tables. Every result equals the reference's as
a multiset (``planfuzz.canon``, FLOAT64 compared exactly), and so does the
compilation itself (``tests/torch_plan_parity.compile_both``). A mismatch
would be bisected on the JAX side with ``planfuzz.bisect_mismatch`` and
recorded in ROADMAP.md section 3; none is known. The longer sweep is slow."""

import numpy as np
import pytest

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.analysis import planfuzz
from spark_rapids_jni_tpu.models.tpcds import gen_store_wide

from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds
from test_torch_tpch import _assert_tables_equal
from torch_plan_parity import compile_both

ROWS, TABLE_SEED = 160, 97  # the reference fuzzer's own tables
_TABLES = {}


def _tables():
    if not _TABLES:
        jt = gen_store_wide(ROWS, seed=TABLE_SEED)
        pt = ptpcds.gen_store_wide(ROWS, seed=TABLE_SEED, device="cpu")
        for t in jt:
            _assert_tables_equal(pt[t], jt[t])
        _TABLES["t"] = (jt, pt)
    return _TABLES["t"]


def _rows_of_port(t):
    """The port's result as planfuzz rows (FLOAT64 viewed back to float,
    validity folded to None), the reference's ``rel_of_table`` form."""
    cols = []
    for c in t.columns:
        arr = c.data.numpy().view(c.dtype.np_dtype)
        vals = arr.view(np.float64).tolist() if c.dtype.np_dtype == np.uint64 and \
            c.dtype.id.name == "FLOAT64" else arr.tolist()
        if c.validity is not None:
            vals = [v if ok else None for v, ok in zip(vals, c.validity.numpy().tolist())]
        cols.append(vals)
    return list(t.names), [tuple(r) for r in zip(*cols)] if cols else []


def _fuzz_one(plan_seed):
    jt, pt = _tables()
    ir, template = planfuzz.gen_plan(np.random.default_rng(plan_seed))
    pcp, jcp = compile_both(ir, jt, pt, name=f"fuzz_{plan_seed}")
    want_names, want_rows = planfuzz.rel_of_table(jcp())
    got_names, got_rows = _rows_of_port(pcp())
    assert got_names == want_names, template
    assert planfuzz.canon(got_rows) == planfuzz.canon(want_rows), (
        template, planfuzz.bisect_mismatch(
            ir, {t: planfuzz.rel_of_table(tb) for t, tb in jt.items()},
            {t: {n: c.dtype for n, c in zip(tb.names, tb.columns)} for t, tb in jt.items()}))
    return template


# base seed 1234, the reference fuzzer's first seed: plan i is 1234 * 100003 + i
SEEDS = [1234 * 100003 + i for i in range(24)]


# one seed over 20 s alone runs with -m slow; the other 23 stay in tier 1
SLOW_SEEDS = (1234 * 100003 + 16,)


def seed_params(seeds):
    return [pytest.param(s, marks=pytest.mark.slow) if s in SLOW_SEEDS else s for s in seeds]


# the first twelve plans here, the other twelve in test_torch_plan_fuzz_more.py
@pytest.mark.parametrize("plan_seed", seed_params(SEEDS[:12]))
def test_fuzzed_plan_matches_reference(plan_seed):
    _fuzz_one(plan_seed)


@pytest.mark.slow
@pytest.mark.parametrize("plan_seed", [7 * 100003 + i for i in range(50)])
def test_fuzzed_plan_matches_reference_longer_sweep(plan_seed):
    _fuzz_one(plan_seed)
