"""Test helper: hold one compiled plan of the port against the JAX
package's on the same plan and tables.

``compile_both`` carries a reference plan and its tables into the port,
compiles both and checks what compilation decides: the optimized plan's
``structure()``, the rewrites fired, the obligation ledger (rule and
fingerprints), the ``fingerprint``, the CBO's modeled costs, the inferred
schema, and every lowered stage's kind and row and byte estimates.
``run_both`` then runs both and holds the results bit for bit (integers
and counts exact, FLOAT64 by its IEEE bits, validity and names as well),
with the estimate-vs-actual report. The registry helpers cache one table
set per (generator, rows, seed) for a whole test module: compiling the
JAX reference for each new shape is what costs time.
"""

import numpy as np

import spark_rapids_jni_tpu  # noqa: F401  (x64 on before any other jax use)
from spark_rapids_jni_tpu import plan as JP
from spark_rapids_jni_tpu.models import tpcds_plans as jtp

from spark_rapids_jni_tpu_torch import plan as PP
from spark_rapids_jni_tpu_torch.models import tpcds_plans as ptp
from test_torch_tpch import _assert_tables_equal
from torch_plan_carry import carry_plan, carry_tables

__all__ = ["compile_both", "run_both", "registry_tables", "check_registry_query",
           "dtypes_key", "obligations_key", "stages_key"]


def dtypes_key(schema):
    return {n: (int(d.id), d.scale) for n, d in schema.items()}


def obligations_key(obligations):
    return [(o.rule, o.before_fp, o.after_fp,
             None if o.schema is None else dtypes_key(o.schema))
            for o in obligations]


def stages_key(cp):
    return [(s.kind, s.est_rows, s.est_bytes) for s in cp.stages]


def compile_both(jplan, jtables, ptables=None, name="plan"):
    """``(port CompiledPlan, reference CompiledPlan)`` of one plan, after
    holding everything compilation decides equal across the two."""
    ptables = carry_tables(jtables) if ptables is None else ptables
    pplan = carry_plan(jplan)
    assert PP.structure(pplan) == JP.structure(jplan)
    assert PP.fingerprint(pplan) == JP.fingerprint(jplan)
    jcp = JP.compile_ir(jplan, jtables, name=name)
    pcp = PP.compile_ir(pplan, ptables, name=name)
    assert type(pcp).__name__ == type(jcp).__name__ == "CompiledPlan"
    assert PP.structure(pcp.optimized) == JP.structure(jcp.optimized), name
    assert PP.fingerprint(pcp.optimized) == JP.fingerprint(jcp.optimized), name
    assert pcp.rewrites_fired == jcp.rewrites_fired, name
    assert obligations_key(pcp.obligations) == obligations_key(jcp.obligations), name
    assert pcp.modeled == jcp.modeled, name
    assert dtypes_key(pcp.schema) == dtypes_key(jcp.schema), name
    assert stages_key(pcp) == stages_key(jcp), name
    assert pcp.estimated_memory_bytes == jcp.estimated_memory_bytes, name
    return pcp, jcp


def run_both(pcp, jcp):
    """Run both compiled plans; hold the results and the reports equal.
    Returns the port's result."""
    jout, pout = jcp(), pcp()
    _assert_tables_equal(pout, jout)
    got = {n: (int(c.dtype.id), c.dtype.scale) for n, c in zip(pout.names, pout.columns)}
    assert got == dtypes_key(pcp.schema), "inferred schema != executed dtypes"
    assert pcp.last_report == jcp.last_report
    rep = pcp.last_report
    assert rep["memgov_admitted_bytes"] == 0
    assert rep["peak_blowup"] is None or rep["peak_blowup"] <= 2.5, rep
    return pout


_TABLES = {}


def registry_tables(name, rows, seed=None):
    """(reference tables, port tables on the CPU) of a registry query's
    generator, cached per (generator, rows, seed). The port's tables come
    from the port's generator and are held to the carried reference's."""
    jd, pd = jtp.PLAN_QUERIES[name], ptp.PLAN_QUERIES[name]
    key = (jd.gen.__code__.co_names, jd.gen.__defaults__, rows, seed)
    if key not in _TABLES:
        kw = {} if seed is None else {"s": seed}
        jt = jd.gen(rows, **kw)
        pt = pd.gen(rows, device="cpu", **kw)
        assert sorted(pt) == sorted(jt)
        for t in jt:
            _assert_tables_equal(pt[t], jt[t])
        _TABLES[key] = (jt, pt)
    return _TABLES[key]


def check_registry_query(name, rows, seed=None):
    """One registry query through both packages: compilation, the
    port-side rewrite idempotence, and the results bit for bit."""
    jt, pt = registry_tables(name, rows, seed)
    jplan = jtp.PLAN_QUERIES[name].plan()
    pcp, jcp = compile_both(jplan, jt, pt, name=name)
    catalog = {t: {n: c.dtype for n, c in zip(tb.names, tb.columns)} for t, tb in pt.items()}
    once = PP.rewrite(ptp.PLAN_QUERIES[name].plan(), catalog)
    twice = PP.rewrite(once.plan, catalog)
    assert PP.structure(twice.plan) == PP.structure(once.plan), name
    out = run_both(pcp, jcp)
    # the registry's own runner is the same plan through the same compiler
    again = ptp.PLAN_QUERIES[name].run(pt)
    _assert_tables_equal_port(again, out)
    return out


def _assert_tables_equal_port(a, b):
    assert a.names == b.names and a.num_rows == b.num_rows
    for ca, cb in zip(a.columns, b.columns):
        assert (ca.validity is None) == (cb.validity is None)
        np.testing.assert_array_equal(ca.data.numpy(), cb.data.numpy())
        if ca.validity is not None:
            np.testing.assert_array_equal(ca.validity.numpy(), cb.validity.numpy())
