"""Port: the plan tier's statistics (``plan/stats``: sketches, the cost
model, the generation-stamp cache) and the cost-based optimizer
(``plan/optimizer.py``) against the JAX package. Every sketch field, every
predicate selectivity, the estimator's row estimates, the plan costs and
the calibration factors equal the reference's on the same columns; the
optimizer fires the same rules, reaches the same plan and costs and
records the same obligations; a tampered reorder fails PLAN006 in both;
and the port's stamp cache and knobs behave as the reference's (the cases
of the reference's ``tests/test_stats.py`` and ``test_optimizer.py``)."""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu import plan as JP
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.plan import nodes as jpn
from spark_rapids_jni_tpu.plan import optimizer as jopt
from spark_rapids_jni_tpu.plan import stats as JS

from spark_rapids_jni_tpu_torch import plan as PP
from spark_rapids_jni_tpu_torch.plan import nodes as ppn
from spark_rapids_jni_tpu_torch.plan import optimizer as popt
from spark_rapids_jni_tpu_torch.plan import stats as PS
from torch_plan_carry import carry_plan, carry_table, carry_tables, catalog_of
from torch_plan_parity import compile_both, obligations_key, run_both


def icol(a, d=jdt.INT32):
    return JColumn(d, data=jnp.asarray(np.asarray(a, np.dtype(d.np_dtype))))


def fcol(a):
    return JColumn(jdt.FLOAT64, data=jnp.asarray(np.asarray(a, np.float64).view(np.uint64)))


def vcol(a, valid, d=jdt.INT32):
    return JColumn(d, data=jnp.asarray(np.asarray(a, np.dtype(d.np_dtype))),
                   validity=jnp.asarray(np.asarray(valid, bool)))


@pytest.fixture(autouse=True)
def _fresh_stats():
    PS.reset()
    JS.reset()
    yield
    PS.reset()
    JS.reset()


def _both_sketches(jc, **kw):
    pc = carry_table(JTable([jc], ["c"])).columns[0]
    return PS.sketch_column(pc, **kw), JS.sketch_column(jc, **kw)


def _fields(sk):
    return None if sk is None else dataclasses.asdict(sk)


def _columns(rng):
    n = 6000
    valid = rng.random(n) < 0.1
    dup = rng.permutation(1000)
    dup[500] = dup[3]
    nulls7 = np.ones(100, bool)
    nulls7[7] = False
    return {
        "uniform": icol(rng.integers(0, 5000, 20000)),
        "skewed_int64": icol(np.minimum(rng.zipf(1.3, 20000), np.int64(1) << 40), jdt.INT64),
        "null_heavy": vcol(rng.integers(0, 300, n), valid),
        "float64": fcol(rng.uniform(-10, 10, 5000).round(4)),
        "float32": JColumn(jdt.FLOAT32, data=jnp.asarray(rng.uniform(0, 1, 3000)
                                                          .astype(np.float32))),
        "empty": icol([]),
        "all_null": vcol(np.zeros(64), np.zeros(64, bool)),
        "permutation": icol(rng.permutation(1000)),
        "duplicate": icol(dup),
        "sampled": icol(rng.permutation(4096)),
        "one_null": vcol(np.arange(100), nulls7),
        "uint16": icol(rng.integers(0, 60000, 3000), jdt.UINT16),
        "uint32": icol(rng.integers(0, 1 << 32, 3000, dtype=np.uint64), jdt.UINT32),
        "uint64": icol(rng.integers(0, 1 << 63, 3000, dtype=np.uint64) * 2, jdt.UINT64),
        "int8": icol(rng.integers(-100, 100, 3000), jdt.INT8),
        "decimal64": icol(rng.integers(-10**12, 10**12, 3000), jdt.DType(jdt.TypeId.DECIMAL64, -2)),
        "bool8": icol(rng.integers(0, 2, 100), jdt.BOOL8),
        "string": JColumn.from_pylist(["a", "bb", None], jdt.STRING),
    }


@pytest.mark.parametrize("kw", [{}, {"bins": 4, "hll_bits": 6}, {"max_rows": 1024},
                                 {"bins": 32, "hll_bits": 14, "max_rows": 100}])
def test_sketches_match_reference(rng, kw):
    for name, jc in _columns(rng).items():
        p, j = _both_sketches(jc, **kw)
        assert _fields(p) == _fields(j), name
        if p is not None:
            for v in (-5.0, 0.0, 3.0, 50.0, 999.0):
                assert p.sel_eq(v) == j.sel_eq(v), name
                for op in ("lt", "le", "gt", "ge", "eq", "ne"):
                    assert p.sel_cmp(op, v) == j.sel_cmp(op, v), (name, op, v)
            assert p.null_fraction == j.null_fraction


def test_sketches_keep_the_reference_witnesses(rng):
    cols = _columns(rng)
    assert _both_sketches(cols["permutation"])[0].unique
    assert not _both_sketches(cols["duplicate"])[0].unique
    sk = _both_sketches(cols["sampled"], max_rows=1024)[0]
    assert not sk.unique and sk.rows == 4096
    assert not _both_sketches(cols["one_null"])[0].unique
    assert _both_sketches(cols["string"])[0] is None


def _pred_plans(P, np_int):
    a_half = P.pcol("a") < P.plit(np_int(500))
    b_half = P.pcol("b") >= P.plit(np_int(5))
    return [a_half, b_half, a_half & b_half, a_half | b_half, ~a_half,
            P.pcol("a").is_null(), P.pcol("a").is_not_null(),
            P.pcol("zzz") < P.plit(np_int(3)), P.pcol("a") == P.pcol("b"),
            P.plit(np_int(5)) > P.pcol("b"), (P.pcol("a") + P.plit(1)) < P.plit(3),
            P.pcol("b") != P.plit(np_int(2))]


def test_selectivity_matches_reference(rng):
    n = 6000
    jt = JTable([icol(rng.integers(0, 1000, n)),
                 vcol(rng.integers(0, 10, n), rng.random(n) < 0.8)], ["a", "b"])
    pt = carry_table(jt)
    js = {c: JS.sketch_column(jt.column(c)) for c in ("a", "b")}
    ps = {c: PS.sketch_column(pt.column(c)) for c in ("a", "b")}
    for je, pe in zip(_pred_plans(JP, np.int32), _pred_plans(PP, np.int32)):
        assert PS.selectivity(pe, ps.get) == JS.selectivity(je, js.get), je.structure()
        assert PS.selectivity(carry_plan(je), ps.get) == JS.selectivity(je, js.get)
    assert PS.DEFAULT_SELECTIVITY == JS.DEFAULT_SELECTIVITY


def test_hll_estimate_matches_reference(rng):
    for bits in (4, 9, 14):
        regs = rng.integers(0, 30, 1 << bits)
        assert PS.hll_estimate(regs) == JS.hll_estimate(regs)
    assert PS.hll_estimate(np.zeros(16, np.int64)) == JS.hll_estimate(np.zeros(16, np.int64))


# -- the stamp cache and the knobs (the port's own behavior) -------------------------


def _ptable(a):
    return carry_table(JTable([icol(a)], ["k"]))


def test_stamp_cache_hit_invalidate_and_reset():
    t = _ptable(np.arange(100))
    s1 = PS.table_stats(t)
    assert PS.table_stats(t) is s1
    PS.invalidate_table(t)
    s2 = PS.table_stats(t)
    assert s2 is not s1
    t.columns[0] = _ptable(2 * np.arange(100)).columns[0]
    PS.invalidate_table(t)
    assert PS.table_stats(t).sketch("k").max_val == 198.0
    a, b = _ptable(np.arange(10)), _ptable(np.arange(10))
    assert PS.table_stats(a) is not PS.table_stats(b)
    s3 = PS.table_stats(a)
    PS.reset()
    assert PS.table_stats(a) is not s3


def test_memory_bytes_bounded_and_equal_to_reference(rng):
    jt = JTable([icol(rng.integers(0, 1000, 50000)), fcol(rng.uniform(0, 1, 50000)),
                 icol(rng.integers(0, 5, 50000), jdt.INT64)], ["a", "b", "c"])
    ts = PS.table_stats(carry_table(jt))
    assert ts.memory_bytes == JS.table_stats(jt).memory_bytes
    assert 0 < ts.memory_bytes < 16 * 1024


def test_stats_knobs(monkeypatch, rng):
    monkeypatch.setenv("SRJTORCH_STATS_ENABLED", "0")
    assert PS.make_estimator({"t": _ptable(np.arange(10))}) is None
    monkeypatch.delenv("SRJTORCH_STATS_ENABLED")
    monkeypatch.setenv("SRJTORCH_STATS_HISTOGRAM_BINS", "4")
    assert len(PS.table_stats(_ptable(np.arange(1000))).sketch("k").edges) == 5
    monkeypatch.setenv("SRJTORCH_STATS_MAX_ROWS", "256")
    assert not PS.table_stats(_ptable(rng.permutation(2048))).sketch("k").unique


# -- the cost model -------------------------------------------------------------------


@pytest.fixture
def star(rng):
    n = 3000
    fact = JTable([icol(rng.integers(0, 300, n)), icol(rng.integers(0, 500, n)),
                   fcol(rng.uniform(0, 50, n).round(2))], ["f_d_sk", "f_i_sk", "f_val"])
    dates = JTable([icol(np.arange(300)), icol(1 + np.arange(300) % 12)], ["d_sk", "d_moy"])
    item = JTable([icol(np.arange(500)), icol(np.arange(500) % 7)], ["i_sk", "i_cls"])
    mini = JTable([icol(rng.integers(0, 300, 800)), icol(rng.integers(1, 9, 800), jdt.INT64)],
                  ["m_d_sk", "m_qty"])
    jt = {"fact": fact, "dates": dates, "item": item, "mini": mini}
    return jt, carry_tables(jt)


def _star_ir(P, pn):
    j1 = pn.Join(pn.Scan("fact"), pn.Scan("item"), on=(("f_i_sk", "i_sk"),), how="inner")
    j2 = pn.Join(j1, pn.Filter(pn.Scan("dates"), P.pcol("d_moy") == P.plit(np.int32(3))),
                 on=(("f_d_sk", "d_sk"),), how="inner")
    return pn.Sort(pn.Aggregate(j2, keys=("i_cls",),
                                aggs=(pn.AggSpec("f_val", "sum", "total"),
                                      pn.AggSpec(None, "count_all", "cnt"))),
                   keys=(("i_cls", True),))


def test_estimator_and_plan_cost_match_reference(star):
    jt, pt = star
    je, pe = JS.make_estimator(jt), PS.make_estimator(pt)
    for args in ((3000, JP.pcol("d_moy") == JP.plit(np.int32(3))),
                 (500, JP.pcol("f_val") > JP.plit(25.0))):
        assert pe.filter_rows(args[0], carry_plan(args[1])) == je.filter_rows(*args)
    for how in ("inner", "left", "semi", "anti", "full"):
        on = (("f_d_sk", "d_sk"),)
        assert pe.join_rows(how, 3000, 300, on) == je.join_rows(how, 3000, 300, on)
    for keys in ((), ("i_cls",), ("f_d_sk", "f_i_sk"), ("zzz",)):
        assert pe.agg_rows(3000, keys) == je.agg_rows(3000, keys)
    jplan = _star_ir(JP, jpn)
    assert PS.plan_cost(carry_plan(jplan), pe, catalog_of(pt)) == JS.plan_cost(
        jplan, je, catalog_of(jt))
    assert PS.row_width(catalog_of(pt)["fact"]) == JS.row_width(catalog_of(jt)["fact"])


def test_calibration_matches_reference(tmp_path, monkeypatch):
    path = tmp_path / "plan_compile.jsonl"
    rows = [{"stages": [{"kind": "filter", "est_bytes": 100, "actual_bytes": 150},
                        {"kind": "join", "est_bytes": 100, "actual_bytes": 30},
                        {"kind": "aggregate", "est_bytes": 0, "actual_bytes": 10},
                        {"kind": "filter", "est_bytes": 100, "actual_bytes": 170}]},
            {"stages": [{"kind": "scan", "est_bytes": 10, "actual_bytes": None}]}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\nnot json\n")
    monkeypatch.setenv("SRJTORCH_CBO_CALIBRATION", str(path))
    monkeypatch.setenv("SRJT_CBO_CALIBRATION", str(path))
    PS.reset_calibration()
    JS.reset_calibration()
    try:
        assert PS.load_calibration(str(path)) == JS.load_calibration(str(path))
        for kind in ("filter", "join", "aggregate", "scan", "fused_aggregate"):
            assert PS.calibration_factor(kind) == JS.calibration_factor(kind)
    finally:
        PS.reset_calibration()
        JS.reset_calibration()


# -- the optimizer ------------------------------------------------------------------


def _opt_plans(P, pn):
    return {
        "star": _star_ir(P, pn),
        "build_side": pn.Sort(pn.Aggregate(
            pn.Join(pn.Scan("dates"), pn.Scan("fact"), on=(("d_sk", "f_d_sk"),), how="inner"),
            keys=("d_moy",), aggs=(pn.AggSpec("f_val", "sum", "total"),)),
            keys=(("d_moy", True),)),
        "no_commute": pn.Aggregate(
            pn.Join(pn.Scan("mini"), pn.Scan("fact"), on=(("m_d_sk", "f_d_sk"),), how="inner"),
            keys=("m_d_sk",), aggs=(pn.AggSpec("f_val", "sum", "total"),)),
        "strategy": pn.Aggregate(
            pn.Join(pn.Scan("fact"), pn.Scan("item"), on=(("f_i_sk", "i_sk"),), how="inner",
                    bounded=None),
            keys=("i_cls",), aggs=(pn.AggSpec("f_val", "sum", "total"),)),
    }


@pytest.mark.parametrize("name", ["star", "build_side", "no_commute", "strategy"])
def test_optimizer_matches_reference(star, name):
    jt, pt = star
    jplan = _opt_plans(JP, jpn)[name]
    for pplan in (_opt_plans(PP, ppn)[name], carry_plan(jplan)):
        jres = jopt.optimize(jplan, catalog_of(jt), jt)
        pres = popt.optimize(pplan, catalog_of(pt), pt)
        assert PP.structure(pres.plan) == JP.structure(jres.plan)
        assert pres.fired == jres.fired
        assert (pres.author_cost, pres.chosen_cost, pres.join_count) == (
            jres.author_cost, jres.chosen_cost, jres.join_count)
        assert obligations_key(pres.obligations) == obligations_key(jres.obligations)
        assert PP.verify_obligations(pres.obligations, catalog_of(pt)) == []
        again = popt.optimize(pres.plan, catalog_of(pt), pt, est=pres.estimator)
        assert again.fired == {}
    expect = {"star": "cbo_reorder_joins", "build_side": "cbo_build_side",
              "no_commute": None, "strategy": "cbo_join_strategy"}[name]
    if expect:
        assert pres.fired.get(expect, 0) >= 1
    else:
        assert "cbo_build_side" not in pres.fired
    # compiled through both packages: the same fires, stages and result bits
    pcp, jcp = compile_both(jplan, jt, pt, name=name)
    if name == "no_commute":  # duplicate build keys: both refuse the dense map
        with pytest.raises(ValueError) as je:
            jcp()
        with pytest.raises(ValueError) as pe:
            pcp()
        assert str(pe.value) == str(je.value)
    else:
        run_both(pcp, jcp)


def test_cbo_off_gives_the_same_result(star, monkeypatch):
    jt, pt = star
    ir = carry_plan(_star_ir(JP, jpn))
    on = PP.compile_ir(ir, pt, name="cbo_on")
    assert on.rewrites_fired.get("cbo_reorder_joins", 0) >= 1
    assert on.modeled is not None and on.modeled["chosen"] <= on.modeled["author"]
    got_on = on()
    monkeypatch.setenv("SRJTORCH_CBO_ENABLED", "0")
    off = PP.compile_ir(ir, pt, name="cbo_off")
    assert "cbo_reorder_joins" not in off.rewrites_fired and off.modeled is None
    got_off = off()
    assert got_on.names == got_off.names
    for a, b in zip(got_on.columns, got_off.columns):
        assert a.data.numpy().tobytes() == b.data.numpy().tobytes()
    monkeypatch.setenv("SRJTORCH_STATS_ENABLED", "0")
    monkeypatch.delenv("SRJTORCH_CBO_ENABLED")
    res = popt.optimize(ir, catalog_of(pt), pt)
    assert res.fired == {} and res.author_cost is None


def _tampered(P, pn, opt):
    def tampered(node, catalog, memo):
        if not (isinstance(node, pn.Join) and node.how == "inner"):
            return None
        base, chain = opt.collect_chain(node, catalog)
        if len(chain) < 2 or any(j.bounded for j in chain):
            return None
        rebuilt = base
        for j in reversed(chain):
            rebuilt = pn.Join(rebuilt, j.right, on=j.on, how="inner", bounded=True)
        names = tuple(P.infer_schema(node, catalog))
        return pn.Project(rebuilt, tuple((n, P.pcol(n)) for n in names))
    return tampered


def test_tampered_reorder_fails_plan006_in_both(star):
    jt, pt = star
    got = []
    for P, pn, opt, tabs in ((PP, ppn, popt, pt), (JP, jpn, jopt, jt)):
        cat = catalog_of(tabs)
        res = P.rewrite(_star_ir(P, pn), cat,
                        rules=(("cbo_reorder_joins", _tampered(P, pn, opt)),), prune=False)
        got.append((res.fired, [(v.rule, v.message)
                                for v in P.verify_obligations(res.obligations, cat)]))
    assert got[0] == got[1]
    assert [r for r, _ in got[0][1]] == ["PLAN006"]
    assert "multiset not preserved" in got[0][1][0][1]
