"""Port: the plan tier's host half (``plan/exprs``, ``nodes``,
``rewrites``, ``verifier``, ``distribute``) and both lowering tiers on
small tables, against the JAX package. Plans are built with the
reference's API and carried into the port (``tests/torch_plan_carry.py``);
expression typing, schema inference, every rewrite's output, its
obligations and fingerprints, the parameterized fingerprint, literal
rebinding and pruning equal the reference's, each PLAN0xx verifier rule
fires with the same code and message on the same bad plan, and compiled
plans give the reference's result bits (the cases of the reference's
``tests/test_plan.py``, ``test_plancheck.py`` and
``test_ledger_rewrites.py``)."""

import json
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu import plan as JP
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.plan import exprs as jpex
from spark_rapids_jni_tpu.plan import nodes as jpn
from spark_rapids_jni_tpu.plan import rewrites as jrw

from spark_rapids_jni_tpu_torch import plan as PP
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.plan import distribute as pdist
from spark_rapids_jni_tpu_torch.plan import exprs as ppex
from spark_rapids_jni_tpu_torch.plan import nodes as ppn
from spark_rapids_jni_tpu_torch.plan import rewrites as prw
from test_torch_tpch import _assert_tables_equal
from torch_plan_carry import carry_plan, carry_table, carry_tables, catalog_of
from torch_plan_parity import compile_both, dtypes_key, obligations_key, run_both

REF = {"P": JP, "pn": jpn, "pex": jpex, "rw": jrw, "dt": jdt}
PORT = {"P": PP, "pn": ppn, "pex": ppex, "rw": prw, "dt": pdt}


def icol(a, d=jdt.INT32):
    return JColumn(d, data=jnp.asarray(np.asarray(a, np.dtype(d.np_dtype))))


def fcol(a):
    return JColumn(jdt.FLOAT64, data=jnp.asarray(np.asarray(a, np.float64).view(np.uint64)))


def small_tables(rng, n=400):
    fact = JTable(
        [icol(rng.integers(0, 30, n)), icol(rng.integers(0, 8, n)),
         fcol(rng.uniform(0, 50, n).round(2)),
         icol(rng.integers(1, 20, n), jdt.INT64)],
        ["f_dim_sk", "f_key", "f_price", "f_qty"],
    )
    dim = JTable(
        [icol(np.arange(30)), icol(1 + np.arange(30) % 12), icol(np.arange(30) % 3)],
        ["d_sk", "d_moy", "d_cls"],
    )
    return {"fact": fact, "dim": dim}


@pytest.fixture
def tabs(rng):
    jt = small_tables(rng)
    return jt, carry_tables(jt)


def _key(d):
    return None if d is None else (int(d.id), d.scale)


# -- expressions ----------------------------------------------------------------


def _exprs(P, dt):
    return [
        P.pcol("a"), P.pcol("a") + P.pcol("b"), P.pcol("a") + P.plit(3),
        P.pcol("x") * P.plit(1.5), P.pcol("x") / P.pcol("b"), P.pcol("a") > P.plit(5),
        (P.pcol("a") > P.plit(1)) & (P.pcol("b") < P.plit(2)), P.pcol("x").is_null(),
        P.pcol("a").cast(dt.INT64),
        P.pwhen(P.pcol("a") > P.plit(0), P.pcol("x"), P.plit(None, dt.FLOAT64)),
        P.plike(P.pcol("s"), "ab%"), P.prlike(P.pcol("s"), "b+"),
        P.plit(np.int32(7)), P.pcol("a") % P.plit(4), ~(P.pcol("a") == P.pcol("b")),
        P.pcol("u") + P.pcol("a"), P.pcol("f") + P.pcol("x"), P.pcol("f") * P.plit(2),
        P.ppart(("a", "b"), 4),
    ]


def test_expression_typing_refs_and_structure_match_reference():
    schema = {"a": "INT32", "b": "INT64", "x": "FLOAT64", "s": "STRING",
              "u": "UINT16", "f": "FLOAT32"}
    js = {k: getattr(jdt, v) for k, v in schema.items()}
    ps = {k: getattr(pdt, v) for k, v in schema.items()}
    jexprs = _exprs(JP, jdt)
    for je, pe in zip(jexprs, _exprs(PP, pdt)):
        assert pe.structure() == je.structure() == carry_plan(je).structure()
        assert pe.refs() == je.refs()
        assert _key(pe.dtype(ps)) == _key(je.dtype(js)), je.structure()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_expression_errors(pkg):
    P, dt = (PORT if pkg == "port" else REF)["P"], (PORT if pkg == "port" else REF)["dt"]
    cases = [
        lambda: P.pcol("zzz").dtype({"a": dt.INT32}),
        lambda: P.plit(None),
        lambda: P.pwhen(P.pcol("a") > P.plit(0), P.pcol("a"), P.pcol("x")).dtype(
            {"a": dt.INT32, "x": dt.FLOAT64}),
        lambda: P.plike(P.pcol("a"), "x%").dtype({"a": dt.INT32}),
        lambda: P.plike(P.pcol("a") + P.plit(1), "x%"),
        lambda: P.ppart((), 4),
        lambda: P.ppart(("a",), 1),
        lambda: (P.pcol("s") + P.plit(1)).dtype({"s": dt.STRING}),
    ]
    for case in cases:
        with pytest.raises(P.PlanError):
            case()


def test_like_and_rlike_lowering_match_reference():
    vals = ["alpha", "beta", "alphabet", None, "ALPHA", "xalpha", "", "a.b"]
    jcol = JColumn.from_pylist(vals, jdt.STRING)
    pcol = Column.from_pylist(vals, pdt.STRING, device="cpu")
    for pat, kind in (("alpha%", "plike"), ("%alpha", "plike"), ("a_b", "plike"),
                      ("a.b", "plike"), ("lph", "prlike"), ("^b", "prlike")):
        want = getattr(JP, kind)(JP.pcol("s"), pat).lower().evaluate(JTable([jcol], ["s"]))
        got = getattr(PP, kind)(PP.pcol("s"), pat).lower().evaluate(Table([pcol], ["s"]))
        assert got.to_pylist() == want.to_pylist(), (kind, pat)
    py = [None if v is None else bool(re.match(r"alpha.*$", v)) for v in vals]
    got = PP.plike(PP.pcol("s"), "alpha%").lower().evaluate(Table([pcol], ["s"])).to_pylist()
    assert [None if g is None else bool(g) for g in got] == py
    with pytest.raises(PP.PlanError, match="STRING"):
        PP.plike(PP.pcol("a"), "x%").lower().evaluate(
            Table([Column.from_numpy(np.arange(3, dtype=np.int32), device="cpu")], ["a"]))


def test_conjuncts_substitute_and_map_literals_match_reference():
    def build(P, pex):
        e = (P.pcol("a") > P.plit(1)) & (P.pcol("b") < P.plit(2)) & P.pcol("c").is_null()
        cs = pex.conjuncts(e)
        ren = pex.substitute(e, {"a": "z"})
        lit = pex.map_literals(e, lambda x: P.plit(x.value * 10, x.d))
        return ([c.structure() for c in cs], pex.conjoin(cs).structure() == e.structure(),
                ren.structure(), lit.structure(), pex.is_col(P.pcol("q")),
                pex.is_null_lit(P.plit(None, PORT["dt"].INT32 if pex is ppex else jdt.INT32)))
    assert build(PP, ppex) == build(JP, jpex)


def test_part_hash_predicate_matches_reference(tabs):
    """``ppart`` (B1's function on an int32 key; its plain version here)
    selects the reference's rows for every partition."""
    jt, pt = tabs
    for i in range(4):
        ir = JP.Filter(JP.Scan("fact"), JP.ppart(("f_key",), 4) == JP.plit(np.int32(i)))
        run_both(*compile_both(ir, jt, pt, name=f"ppart{i}"))
    proj = JP.Project(JP.Scan("fact"), (("p", JP.ppart(("f_key", "f_dim_sk"), 7)),
                                        ("q", JP.ppart(("f_qty",), 3))))
    run_both(*compile_both(proj, jt, pt, name="ppart_proj"))


# -- schema inference ----------------------------------------------------------------


def _schema_plans(P):
    w = P.Window(P.Scan("fact"), partition_by=("f_key",), order_by=(("f_price", True),),
                 aggs=(("f_price", "rank", "r"), ("f_qty", "sum", "qs"),
                       ("f_price", "cumsum", "cs"), ("f_qty", "count", "c")))
    return [
        P.Aggregate(P.Join(P.Scan("fact"), P.Filter(P.Scan("dim"),
                                                    P.pcol("d_moy") == P.plit(11)),
                           on=(("f_dim_sk", "d_sk"),)),
                    keys=("f_key",),
                    aggs=(P.AggSpec("f_price", "sum", "total"),
                          P.AggSpec("f_qty", "mean", "avg_qty"),
                          P.AggSpec(None, "count_all", "cnt"))),
        P.Join(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),), how="semi"),
        P.Join(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),), how="left"),
        P.Join(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),), how="full"),
        w,
        P.Project(P.Scan("fact"), (("k2", P.pcol("f_key") * P.plit(2)),
                                   ("n", P.plit(None, PORT["dt"].FLOAT64 if P is PP
                                                else jdt.FLOAT64)))),
        P.Aggregate(P.Scan("fact"), keys=("f_key", "f_dim_sk"),
                    aggs=(P.AggSpec("f_qty", "sum", "s"),),
                    grouping_sets=P.rollup("f_key", "f_dim_sk")),
        P.Limit(P.Sort(P.Scan("dim"), (("d_moy", False),)), 3),
    ]


def test_schema_inference_matches_reference(tabs):
    jt, pt = tabs
    jc, pc = catalog_of(jt), catalog_of(pt)
    for jplan, pplan in zip(_schema_plans(JP), _schema_plans(PP)):
        assert PP.structure(pplan) == JP.structure(jplan)
        assert dtypes_key(PP.infer_schema(pplan, pc)) == dtypes_key(JP.infer_schema(jplan, jc))
        assert dtypes_key(PP.infer_schema(carry_plan(jplan), pc)) == dtypes_key(
            JP.infer_schema(jplan, jc))


@pytest.mark.parametrize("bad", ["collision", "union", "table", "column"])
def test_schema_errors_raise_in_both(tabs, bad):
    jt, pt = tabs

    def plan(P):
        return {
            "collision": P.Join(P.Scan("fact"), P.Scan("fact"), on=(("f_key", "f_key"),)),
            "union": P.UnionAll((P.Scan("fact"), P.Scan("dim"))),
            "table": P.Scan("nope"),
            "column": P.Filter(P.Scan("fact"), P.pcol("zzz") > P.plit(1)),
        }[bad]
    with pytest.raises(JP.PlanError) as je:
        JP.infer_schema(plan(JP), catalog_of(jt))
    with pytest.raises(PP.PlanError) as pe:
        PP.infer_schema(plan(PP), catalog_of(pt))
    assert str(pe.value) == str(je.value)


# -- rewrites ---------------------------------------------------------------------------


def _composite(P):
    src = P.Scan("fact")
    corr = P.CorrelatedAggFilter(
        src, src, on=("f_key", "f_key"), agg=P.AggSpec("f_price", "mean", "avg_p"),
        predicate=P.pcol("f_price") > P.pcol("avg_p"))
    withdim = P.Filter(P.Join(corr, P.Scan("dim"), on=(("f_dim_sk", "d_sk"),)),
                       P.pcol("d_moy") == P.plit(11))
    ex = P.Exists(withdim, P.Scan("dim"), on=(("f_dim_sk", "d_sk"),))
    ru = P.Aggregate(ex, keys=("f_key", "d_cls"), aggs=(P.AggSpec("f_price", "sum", "s"),),
                     grouping_sets=P.rollup("f_key", "d_cls"))
    return P.Having(P.Aggregate(ru, keys=("f_key",), aggs=(P.AggSpec("s", "count", "c"),)),
                    P.pcol("c") > P.plit(0))


def _rewrite_plans(P):
    src = P.Scan("fact")
    a = P.Project(P.Scan("fact"), (("k", P.pcol("f_key")),))
    b = P.Project(P.Scan("dim"), (("k", P.pcol("d_cls")),))
    return {
        "decorrelate": P.CorrelatedAggFilter(
            src, src, on=("f_key", "f_key"), agg=P.AggSpec("f_price", "mean", "avg_p"),
            predicate=P.pcol("f_price") > P.pcol("avg_p")),
        "intersect": P.SetOp(a, b, "intersect"),
        "except": P.Filter(P.SetOp(a, b, "except"), P.pcol("k") > P.plit(0)),
        "anti_exists": P.Exists(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),),
                                negated=True),
        "having": P.Having(P.Aggregate(P.Scan("fact"), keys=("f_key",),
                                       aggs=(P.AggSpec(None, "count_all", "cnt"),)),
                           P.pcol("cnt") > P.plit(3)),
        "rollup": P.Aggregate(P.Scan("fact"), keys=("f_key", "f_dim_sk"),
                              aggs=(P.AggSpec("f_qty", "sum", "s"),),
                              grouping_sets=P.rollup("f_key", "f_dim_sk")),
        "pushdown": P.Filter(
            P.Join(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),)),
            (P.pcol("d_moy") == P.plit(11)) & (P.pcol("f_qty") > P.plit(3))),
        "union_push": P.Filter(P.UnionAll((P.Scan("fact"), P.Scan("fact"))),
                               P.pcol("f_key") > P.plit(2)),
        "prune": P.Aggregate(P.Join(P.Scan("fact"), P.Scan("dim"),
                                    on=(("f_dim_sk", "d_sk"),)),
                             keys=("f_key",), aggs=(P.AggSpec("f_price", "sum", "t"),)),
        "composite": _composite(P),
    }


@pytest.mark.parametrize("name", sorted(_rewrite_plans(JP)))
def test_rewrite_matches_reference(tabs, name):
    jt, pt = tabs
    jc, pc = catalog_of(jt), catalog_of(pt)
    jplan = _rewrite_plans(JP)[name]
    for pplan in (_rewrite_plans(PP)[name], carry_plan(jplan)):
        jres, pres = JP.rewrite(jplan, jc), PP.rewrite(pplan, pc)
        assert PP.structure(pres.plan) == JP.structure(jres.plan)
        assert pres.fired == jres.fired
        assert obligations_key(pres.obligations) == obligations_key(jres.obligations)
        assert PP.fingerprint(pres.plan) == JP.fingerprint(jres.plan)
        assert PP.verify_obligations(pres.obligations, pc) == []
        twice = PP.rewrite(pres.plan, pc)
        assert PP.structure(twice.plan) == PP.structure(pres.plan)
        for sugar in ("decorrelate_scalar_agg", "expand_grouping_sets", "setop_to_joins",
                      "exists_to_semijoin", "having_to_filter"):
            assert not twice.fired.get(sugar)
        pruned_p = PP.prune_columns(pres.plan, pc)
        pruned_j = JP.prune_columns(jres.plan, jc)
        assert PP.structure(pruned_p) == JP.structure(pruned_j)


def test_parameterized_fingerprint_and_rebind_match_reference():
    def plans(P):
        base = P.Aggregate(P.Filter(P.Scan("fact"), (P.pcol("f_key") > P.plit(3))
                                    & (P.pcol("f_price") < P.plit(20.5))),
                           keys=("f_key",), aggs=(P.AggSpec("f_price", "sum", "t"),))
        other = P.Aggregate(P.Filter(P.Scan("fact"), (P.pcol("f_key") > P.plit(5))
                                     & (P.pcol("f_price") < P.plit(11.25))),
                            keys=("f_key",), aggs=(P.AggSpec("f_price", "sum", "t"),))
        return base, other
    (jb, jo), (pb, po) = plans(JP), plans(PP)
    jfb, jfo = JP.parameterized_fingerprint(jb), JP.parameterized_fingerprint(jo)
    pfb, pfo = PP.parameterized_fingerprint(pb), PP.parameterized_fingerprint(po)
    assert (pfb.key, pfb.bindings) == (jfb.key, jfb.bindings)
    assert (pfo.key, pfo.bindings) == (jfo.key, jfo.bindings)
    assert pfb.key == pfo.key and pfb.values != pfo.values
    prb = PP.rebind_literals(pb, dict(zip(pfb.bindings, pfo.values)))
    jrb = JP.rebind_literals(jb, dict(zip(jfb.bindings, jfo.values)))
    assert PP.structure(prb) == JP.structure(jrb) == JP.structure(jo)


def test_ledger_rewrites_through_plans_match_reference(rng):
    """The executor expansions of QUERIES.md's rewrite claims (INTERSECT /
    EXCEPT as semi / anti joins on deduplicated keys, ROLLUP as a union of
    group-bys) compiled from plans in both packages."""
    a = JTable([JColumn.from_pylist(rng.integers(0, 50, 300).tolist(), jdt.INT64)], ["k"])
    b = JTable([JColumn.from_pylist(rng.integers(25, 75, 300).tolist(), jdt.INT64)], ["k"])
    n = 500
    t = JTable([icol(rng.integers(0, 4, n)), icol(rng.integers(0, 3, n)),
                icol(rng.integers(1, 100, n), jdt.INT64)], ["a", "b", "v"])
    jt = {"a": a, "b": b, "t": t}
    pt = carry_tables(jt)
    for kind in ("intersect", "except"):
        ir = JP.Sort(JP.SetOp(JP.Scan("a"), JP.Scan("b"), kind), (("k", True),))
        out = run_both(*compile_both(ir, jt, pt, name=kind))
        av = set(a.column("k").to_pylist())
        bv = set(b.column("k").to_pylist())
        want = sorted(av & bv) if kind == "intersect" else sorted(av - bv)
        assert out.column("k").to_pylist() == want
    ir = JP.Aggregate(JP.Scan("t"), keys=("a", "b"), aggs=(JP.AggSpec("v", "sum", "s"),),
                      grouping_sets=JP.rollup("a", "b"))
    out = run_both(*compile_both(ir, jt, pt, name="rollup"))
    av, bv = np.asarray(t.column("a").data), np.asarray(t.column("b").data)
    assert out.num_rows == len(set(zip(av, bv))) + len(set(av)) + 1


# -- execution on both tiers -----------------------------------------------------------


def _exec_plans(P):
    dedup = P.Aggregate(P.Scan("fact"), keys=("f_key",), aggs=())
    return {
        "op_tier": P.Limit(P.Sort(P.Join(dedup, P.Filter(P.Scan("dim"),
                                                         P.pcol("d_cls") == P.plit(0)),
                                         on=(("f_key", "d_sk"),), how="anti"),
                                  (("f_key", True),)), 5),
        "fused": P.Aggregate(
            P.Join(P.Scan("fact"), P.Filter(P.Scan("dim"), P.pcol("d_moy") == P.plit(11)),
                   on=(("f_dim_sk", "d_sk"),), bounded=True),
            keys=("f_key",),
            aggs=(P.AggSpec("f_price", "sum", "total"), P.AggSpec("f_qty", "min", "qmin"),
                  P.AggSpec(None, "count_all", "cnt"))),
        "fused_sort_merge": P.Aggregate(
            P.Project(P.Join(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),)),
                      (("f_key", P.pcol("f_key")), ("v", P.pcol("f_price") * P.plit(2.0)))),
            keys=("f_key",), aggs=(P.AggSpec("v", "mean", "m"), P.AggSpec("v", "max", "x"))),
        "global": P.Aggregate(P.Filter(P.Scan("fact"), P.pcol("f_qty") > P.plit(100)),
                              keys=(), aggs=(P.AggSpec("f_price", "sum", "s"),
                                             P.AggSpec(None, "count_all", "c"))),
        "normalize": P.Aggregate(P.Aggregate(P.Scan("fact"), keys=("f_key", "f_qty"),
                                             aggs=()),
                                 keys=("f_key",), aggs=(P.AggSpec("f_qty", "sum", "qsum"),
                                                        P.AggSpec("f_qty", "max", "qmax"),
                                                        P.AggSpec("f_qty", "var", "qv"),
                                                        P.AggSpec("f_qty", "nunique", "qn"))),
        "op_global_empty": P.Aggregate(
            P.Aggregate(P.Filter(P.Scan("fact"), P.pcol("f_qty") > P.plit(100)),
                        keys=("f_key",), aggs=()),
            keys=(), aggs=(P.AggSpec("f_key", "sum", "s"), P.AggSpec("f_key", "count", "c"))),
        "window": P.Sort(P.Window(P.Scan("fact"), partition_by=("f_key",),
                                  order_by=(("f_dim_sk", True), ("f_qty", True)),
                                  aggs=(("f_price", "rank", "r"), ("f_qty", "sum", "qs"),
                                        ("f_qty", "count", "c"))),
                         (("f_key", True), ("f_dim_sk", True), ("f_qty", True),
                          ("f_price", True))),
        "full_join": P.Sort(P.Join(P.Aggregate(P.Scan("fact"), keys=("f_key",), aggs=()),
                                   P.Filter(P.Scan("dim"), P.pcol("d_cls") == P.plit(1)),
                                   on=(("f_key", "d_sk"),), how="full"),
                            (("f_key", True),)),
        "composite": P.Sort(_composite(P), (("f_key", True),)),
    }


# "composite" takes over 20 s alone: it runs with -m slow, the other plans stay in tier 1
@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.slow) if n == "composite"
                                  else n for n in sorted(_exec_plans(JP))])
def test_compiled_plan_matches_reference(tabs, name):
    jt, pt = tabs
    pcp, jcp = compile_both(_exec_plans(JP)[name], jt, pt, name=name)
    run_both(pcp, jcp)
    if name in ("fused", "fused_sort_merge", "global"):
        assert pcp.last_report["fused_stages"] == 1
    if name == "normalize":
        assert pcp.last_report["fused_stages"] == 0


def test_rollup_float64_key_nulls_keep_dtype(rng):
    n = 300
    t = JTable([icol(rng.integers(0, 4, n)), fcol(rng.uniform(0, 3, n).round(0)),
                icol(rng.integers(1, 50, n), jdt.INT64)], ["a", "fkey", "v"])
    ir = JP.Aggregate(JP.Scan("t"), keys=("a", "fkey"), aggs=(JP.AggSpec("v", "sum", "s"),),
                      grouping_sets=JP.rollup("a", "fkey"))
    pcp, jcp = compile_both(ir, {"t": t}, name="f64rollup")
    out = run_both(pcp, jcp)
    assert out.column("fkey").dtype == pdt.FLOAT64


def test_plan_report_knob_appends_jsonl(tabs, tmp_path, monkeypatch):
    jt, pt = tabs
    ppath, jpath = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    monkeypatch.setenv("SRJTORCH_PLAN_REPORT", str(ppath))
    monkeypatch.setenv("SRJT_PLAN_REPORT", str(jpath))
    ir = JP.Aggregate(JP.Scan("fact"), keys=("f_key",), aggs=(JP.AggSpec("f_price", "sum", "t"),))
    run_both(*compile_both(ir, jt, pt, name="report_knob"))
    prow = [json.loads(s) for s in ppath.read_text().splitlines()]
    jrow = [json.loads(s) for s in jpath.read_text().splitlines()]
    assert prow == jrow and prow[-1]["query"] == "report_knob"


def test_compiled_plan_runs_where_its_tables_are(tabs):
    """A plan binds to its tables: over CPU tables every stage runs and
    every result column lies on the CPU."""
    jt, pt = tabs
    for name, plan in _exec_plans(JP).items():
        cp = PP.compile_ir(carry_plan(plan), pt, name=name)
        assert all(c.device == torch.device("cpu") for c in cp().columns), name


# -- the verifier ---------------------------------------------------------------------


def _rules(vs):
    return [(v.rule, v.message) for v in vs]


def _wellformed_corpus(P, dt):
    return {
        "clean": (P.Aggregate(P.Join(P.Scan("fact"),
                                     P.Filter(P.Scan("dim"), P.pcol("d_moy") == P.plit(11)),
                                     on=(("f_dim_sk", "d_sk"),)),
                              keys=("f_key",), aggs=(P.AggSpec("f_price", "sum", "t"),)), None),
        "unresolved": (P.Limit(P.Sort(P.Filter(P.Scan("fact"), P.pcol("zzz") > P.plit(1)),
                                      (("f_key", True),)), 5), None),
        "unknown_table": (P.Scan("nope"), None),
        "non_bool_pred": (P.Filter(P.Scan("fact"), P.pcol("f_key") + P.plit(1)), None),
        "union_mismatch": (P.UnionAll((P.Scan("fact"), P.Scan("dim"))), None),
        "payload_collision": (P.Join(P.Scan("fact"), P.Scan("fact"),
                                     on=(("f_key", "f_key"),)), None),
        "non_numeric_agg": (P.Aggregate(P.Project(P.Scan("fact"),
                                                  (("b", P.pcol("f_key") > P.plit(1)),)),
                                        keys=(), aggs=(P.AggSpec("b", "sum", "s"),)), None),
        "sugar_raw": (P.Exists(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),)),
                      False),
        "sugar_after_fixpoint": (P.Exists(P.Scan("fact"), P.Scan("dim"),
                                          on=(("f_dim_sk", "d_sk"),)), True),
        "negative_limit": (P.Limit(P.Scan("fact"), -1), None),
        "dup_outputs": (P.Project(P.Scan("fact"), (("k", P.pcol("f_key")),
                                                   ("k", P.pcol("f_qty")))), None),
        "join_dtype": (P.Join(P.Scan("fact"), P.Scan("dim"), on=(("f_qty", "d_sk"),)), None),
        "null_cast": (P.Project(P.Scan("fact"), (("n", P.plit(None, dt.INT64)),)), None),
    }


@pytest.mark.parametrize("name", sorted(_wellformed_corpus(JP, jdt)))
def test_verify_plan_codes_match_reference(tabs, name):
    jt, pt = tabs
    jplan, desugared = _wellformed_corpus(JP, jdt)[name]
    pplan, _ = _wellformed_corpus(PP, pdt)[name]
    kw = {} if desugared is None else {"desugared": desugared}
    want = _rules(JP.verify_plan(jplan, catalog_of(jt), **kw))
    assert _rules(PP.verify_plan(pplan, catalog_of(pt), **kw)) == want
    assert _rules(PP.verify_plan(carry_plan(jplan), catalog_of(pt), **kw)) == want
    expected = {"clean": [], "unresolved": ["PLAN001"], "unknown_table": ["PLAN001"],
                "non_bool_pred": ["PLAN002"], "union_mismatch": ["PLAN002"],
                "payload_collision": ["PLAN003"], "non_numeric_agg": ["PLAN002"],
                "sugar_raw": [], "sugar_after_fixpoint": ["PLAN004"]}
    if name in expected:
        assert [r for r, _ in want] == expected[name]


def _broken_rules(K):
    """The reference's gate-can-fail rewrite fixtures, over package ``K``'s
    node classes: each seeded broken rewrite fires exactly one PLAN006."""
    P, pn, pex = K["P"], K["pn"], K["pex"]

    def drop_last(node, catalog, memo):
        if isinstance(node, pn.Project) and len(node.exprs) == 2:
            return pn.Project(node.input, node.exprs[:-1])
        return None

    def bad_having(node, catalog, memo):
        if isinstance(node, pn.Having):
            return pn.Project(node.input, (("c", P.pcol("c")),))
        return None

    def bad_push(node, catalog, memo):
        if not (isinstance(node, pn.Filter) and isinstance(node.input, pn.Join)):
            return None
        j = node.input
        rs = set(P.infer_schema(j.right, catalog))
        to_right = [c for c in pex.conjuncts(node.predicate) if c.refs() <= rs]
        if not to_right or j.how == "inner":
            return None
        return pn.Join(j.left, pn.Filter(j.right, pex.conjoin(to_right)), on=j.on, how=j.how)

    return {
        "drop_last_output": (
            P.Project(P.Scan("fact"), (("k", P.pcol("f_key")), ("p", P.pcol("f_price")))),
            (("drop_last_output", drop_last),)),
        "having_to_filter": (
            P.Having(P.Aggregate(P.Scan("fact"), keys=("f_key",),
                                 aggs=(P.AggSpec(None, "count_all", "c"),)),
                     P.pcol("c") > P.plit(1)),
            (("having_to_filter", bad_having),)),
        "push_filter_into_join": (
            P.Filter(P.Join(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),),
                            how="left"), P.pcol("d_moy") == P.plit(11)),
            (("push_filter_into_join", bad_push),)),
        "crippled": (
            P.Exists(P.Scan("fact"), P.Scan("dim"), on=(("f_dim_sk", "d_sk"),)),
            tuple(r for r in K["rw"].RULES if r[0] != "exists_to_semijoin")),
    }


@pytest.mark.parametrize("name", sorted(_broken_rules(REF)))
def test_translation_validation_codes_match_reference(tabs, name):
    jt, pt = tabs
    got = []
    for K, cat in ((PORT, catalog_of(pt)), (REF, catalog_of(jt))):
        plan, rules = _broken_rules(K)[name]
        res = K["P"].rewrite(plan, cat, rules=rules, prune=False)
        vs = (K["P"].verify_plan(res.plan, cat, desugared=True) if name == "crippled"
              else K["P"].verify_obligations(res.obligations, cat))
        got.append((res.fired, _rules(vs)))
    assert got[0] == got[1]
    assert [r for r, _ in got[0][1]] == (["PLAN004"] if name == "crippled" else ["PLAN006"])


@pytest.mark.parametrize("tamper", ["inversion", "peak", "missing_bytes"])
def test_verify_estimates_codes_match_reference(tabs, tamper):
    jt, pt = tabs
    ir = JP.Limit(JP.Sort(JP.Scan("fact"), (("f_key", True),)), 5)
    pcp, jcp = compile_both(ir, jt, pt, name="est")
    assert PP.verify_estimates(pcp) == [] and JP.verify_estimates(jcp) == []
    for cp in (pcp, jcp):
        limit = next(s for s in cp.stages if s.kind == "limit")
        if tamper == "inversion":
            limit.est_rows = limit.inputs[0].est_rows + 7
            limit.est_bytes = limit.est_rows * 24
        elif tamper == "peak":
            cp.estimated_memory_bytes += 1
        else:
            limit.est_bytes = 0
    assert _rules(PP.verify_estimates(pcp)) == _rules(JP.verify_estimates(jcp))
    assert PP.verify_estimates(pcp) and all(v.rule == "PLAN005"
                                            for v in PP.verify_estimates(pcp))


# -- distribution ---------------------------------------------------------------------


def test_insert_exchanges_and_unbound_exchange_stage_match_reference(tabs):
    jt, pt = tabs
    ir = JP.Sort(_exec_plans(JP)["fused"], (("f_key", True),))
    plain = JP.compile_ir(ir, jt, name="plain")()  # the single-host result, run once
    for world in (1, 4):
        jx = JP.insert_exchanges(ir, world)
        px = PP.insert_exchanges(carry_plan(ir), world)
        assert PP.structure(px) == JP.structure(jx)
        # unbound, the exchange stage is the identity: the single-host result
        out = run_both(*compile_both(jx, jt, pt, name=f"x{world}"))
        _assert_tables_equal(out, plain)
    with pytest.raises(PP.PlanError):
        PP.insert_exchanges(carry_plan(ir), 0)


class _FakeExchange:
    """Records the exchange stage's call; returns its input unchanged."""

    def __init__(self):
        self.calls = []

    def exchange_table(self, t, keys, peers, epoch, cluster):
        self.calls.append((list(keys), dict(peers), epoch, cluster, t.num_rows))
        return t


def test_exchange_context_binds_the_stage(tabs):
    jt, pt = tabs
    ir = carry_plan(JP.insert_exchanges(_exec_plans(JP)["op_tier"].input.input.left, 2))
    cp = PP.compile_ir(ir, pt, name="bound")
    unbound = cp()
    fake = _FakeExchange()
    assert pdist.current_binding() is None
    with PP.exchange_context(fake, {1: "127.0.0.1:1"}, base_epoch=32):
        bound = cp()
        b = pdist.current_binding()
        # the plan's one stage took the base epoch; the next stage its own
        assert b.world == 2 and b.stage_epoch(-1) == 48
    assert pdist.current_binding() is None
    assert fake.calls == [(["f_key"], {1: "127.0.0.1:1"}, 32, None, pt["fact"].num_rows)]
    _assert_tables_equal(bound, JP.compile_ir(JP.insert_exchanges(
        _exec_plans(JP)["op_tier"].input.input.left, 2), jt, name="ref")())
    _assert_tables_equal(unbound, JP.compile_ir(JP.insert_exchanges(
        _exec_plans(JP)["op_tier"].input.input.left, 2), jt, name="ref")())
    with PP.exchange_context(fake, {1: "a", 2: "b"}):
        with pytest.raises(PP.PlanError, match="world 2"):
            cp()


def test_merge_partials_matches_reference(tabs):
    from spark_rapids_jni_tpu.plan import distribute as jdist

    jt, pt = tabs
    jparts = [JP.compile_ir(JP.Filter(JP.Scan("fact"), JP.pcol("f_key") == JP.plit(k)),
                            jt, name="p")() for k in (3, 1, 5)]
    pparts = [carry_table(t) for t in jparts]
    keys = (("f_price", False), ("f_dim_sk", True))
    _assert_tables_equal(pdist.merge_partials(pparts, keys), jdist.merge_partials(jparts, keys))
    _assert_tables_equal(pdist.merge_partials(pparts, ()), jdist.merge_partials(jparts, ()))
