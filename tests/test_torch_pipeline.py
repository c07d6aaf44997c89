"""Port: pipeline.py (PlanSpec / CompiledPipeline) against the JAX
package's compiled pipelines on the same seeded tables: global and
grouped plans, filters, projections, dense and sort-merge joins (inner
with payload, semi, anti, build filters), and the plans that must raise
(duplicate build keys, build and group keys outside their declared
domain). Each JAX pipeline is built once per module.

Exact (bits and validity): counts, FLOAT64 and integer sums and means,
min/max, joined payloads. Aggregates of FLOAT32 sources sum in float32 in
another order than the reference's: rtol 2e-6 / atol 1e-3."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax.numpy as jnp
from spark_rapids_jni_tpu import pipeline as jp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import expressions as jx

from spark_rapids_jni_tpu_torch import pipeline as pp
from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table, table_to_numpy
from spark_rapids_jni_tpu_torch.ops import expressions as px

N = 600
RTOL32, ATOL32 = 2e-6, 1e-3
INT64_MAX = 2**63 - 1


def _tables(specs):
    jcols, arrays, valids, dts = [], [], [], []
    for _, tn, a, v in specs:
        jcols.append(JColumn(getattr(jdt, tn), data=jnp.asarray(a),
                             validity=None if v is None else jnp.asarray(v)))
        arrays.append(a)
        valids.append(v)
        dts.append(getattr(pdt, tn))
    names = [s[0] for s in specs]
    return JTable(jcols, names), Table(carry_table(arrays, dts, valids, device="cpu").columns, names)


def _make_inputs(seed=3):
    rng = np.random.default_rng(seed)
    nv = lambda p=0.85: rng.random(N) < p  # noqa: E731
    dim_keys = rng.permutation(50)[:40].astype(np.int32)
    sk = rng.choice(2**62, 40, replace=False).astype(np.int64)
    sk[0] = INT64_MAX
    fact = [
        ("k1", "INT32", rng.integers(0, 4, N).astype(np.int32), nv()),
        ("k2", "INT8", rng.integers(0, 3, N).astype(np.int8), None),
        ("f64", "FLOAT64", (rng.standard_normal(N) * 10.0 ** rng.integers(-6, 9, N))
         .view(np.uint64), nv()),
        ("f32", "FLOAT32", (rng.standard_normal(N) * 50).astype(np.float32), nv()),
        ("i32", "INT32", rng.integers(-10**6, 10**6, N).astype(np.int32), None),
        ("i64", "INT64", rng.integers(-(2**50), 2**50, N), nv()),
        ("u64", "UINT64", rng.integers(2**63 - 2**40, 2**63 + 2**40, N, dtype=np.uint64), nv()),
        ("ship", "TIMESTAMP_DAYS", rng.integers(0, 2557, N).astype(np.int32), None),
        ("fk", "INT32", rng.integers(-2, 55, N).astype(np.int32), nv(0.9)),
        ("fk64", "INT64", np.where(rng.random(N) < 0.7, sk[rng.integers(0, 40, N)],
                                   rng.integers(0, 2**62, N)), nv(0.9)),
    ]
    dim = [
        ("dk", "INT32", dim_keys, None),
        ("dp", "FLOAT64", rng.standard_normal(40).view(np.uint64), rng.random(40) < 0.9),
        ("di", "INT32", rng.integers(0, 1000, 40).astype(np.int32), None),
        ("dflag", "INT8", rng.integers(0, 2, 40).astype(np.int8), rng.random(40) < 0.9),
    ]
    sdim = [
        ("sk", "INT64", sk, rng.random(40) < 0.95),
        ("sp", "FLOAT64", rng.standard_normal(40).view(np.uint64), None),
        ("si", "INT64", rng.integers(-100, 100, 40), rng.random(40) < 0.8),
    ]
    return _tables(fact), _tables(dim), _tables(sdim)


(JF, PF), (JD, PD), (JS, PS) = _make_inputs()


def _plan(m, name):
    """The named plan built with one package's pipeline and expressions."""
    P, A, G, J, col, lit = (m[0].PlanSpec, m[0].Agg, m[0].GroupKey, m[0].JoinSpec, m[1].col,
                            m[1].lit)
    every = tuple(A(s, h, f"{s}_{h}") for s in ("f64", "f32", "i32", "i64", "u64")
                  for h in ("sum", "mean", "min", "max", "count")) + (A("f64", "count_all", "n"),)
    if name == "global":
        return P(aggregates=every)
    if name == "global_filter":
        return P(filter=(col("ship") >= lit(np.int32(731))) & (col("f64") < 10.0),
                 aggregates=every)
    if name == "global_empty_filter":
        return P(filter=col("i32") > 10**7, aggregates=every)
    if name == "grouped":
        return P(filter=col("ship") <= lit(np.int32(2436)),
                 project=(("x", col("f64") * (lit(1.0) - col("f64"))),
                          ("y", col("i32") + col("i64"))),
                 group_by=(G("k1", 4), G("k2", 3)),
                 aggregates=every + (A("x", "sum"), A("x", "mean"), A("y", "sum"),
                                     A("y", "mean")))
    if name == "grouped_one_key":
        return P(group_by=(G("k2", 3),), aggregates=every)
    if name == "dense_inner":
        return P(joins=(J("dim", "fk", "dk", num_keys=50, payload=("dp", "di")),),
                 group_by=(G("k2", 3),),
                 aggregates=(A("dp", "sum"), A("dp", "mean"), A("di", "sum"), A("di", "max"),
                             A("f64", "sum"), A("dp", "count"), A("f64", "count_all")))
    if name == "dense_inner_build_filter":
        return P(joins=(J("dim", "fk", "dk", num_keys=50, payload=("dp",),
                          build_filter=col("dflag") == 1),),
                 aggregates=(A("dp", "sum"), A("f64", "sum"), A("f64", "count_all")))
    if name == "dense_semi":
        return P(joins=(J("dim", "fk", "dk", num_keys=50, how="semi"),),
                 group_by=(G("k1", 4),), aggregates=(A("f64", "sum"), A("i64", "count_all")))
    if name == "dense_anti":
        return P(joins=(J("dim", "fk", "dk", num_keys=50, how="anti"),),
                 aggregates=(A("f64", "sum"), A("i64", "mean"), A("i64", "count_all")))
    if name == "sorted_inner":
        return P(joins=(J("sdim", "fk64", "sk", payload=("sp", "si")),),
                 filter=col("i32") > 0,
                 group_by=(G("k2", 3),),
                 aggregates=(A("sp", "sum"), A("si", "sum"), A("si", "min"), A("sp", "max"),
                             A("sp", "count"), A("f64", "count_all")))
    if name == "sorted_semi":
        return P(joins=(J("sdim", "fk64", "sk", how="semi"),),
                 aggregates=(A("f64", "sum"), A("f64", "count_all")))
    if name == "sorted_anti_build_filter":
        return P(joins=(J("sdim", "fk64", "sk", how="anti", build_filter=col("si") > 0),),
                 aggregates=(A("f64", "mean"), A("f64", "count_all")))
    if name == "two_joins":
        return P(joins=(J("dim", "fk", "dk", num_keys=50, payload=("di",)),
                        J("sdim", "fk64", "sk", how="semi")),
                 project=(("z", col("di") * 2),),
                 group_by=(G("k1", 4),), aggregates=(A("z", "sum"), A("f64", "mean")))
    raise ValueError(name)


PLANS = ["global", "global_filter", "global_empty_filter", "grouped", "grouped_one_key",
         "dense_inner", "dense_inner_build_filter", "dense_semi", "dense_anti", "sorted_inner",
         "sorted_semi", "sorted_anti_build_filter", "two_joins"]
_JAX_OUT = {}


def _builds(plan, pkg):
    names = {js.build for js in plan.joins}
    tabs = {"dim": (JD, PD), "sdim": (JS, PS)}
    return {k: tabs[k][0 if pkg == "jax" else 1] for k in names}


def _run(name):
    if name not in _JAX_OUT:
        jplan = _plan((jp, jx), name)
        _JAX_OUT[name] = jp.compile_plan(jplan)(JF, _builds(jplan, "jax"))
    pplan = _plan((pp, px), name)
    return _JAX_OUT[name], pp.compile_plan(pplan)(PF, _builds(pplan, "port")), pplan


@pytest.mark.parametrize("name", PLANS)
def test_plan_matches_jax(name):
    want, got, plan = _run(name)
    assert got.names == want.names and got.num_rows == want.num_rows
    f32_outputs = {a.out_name for a in plan.aggregates
                   if a.source == "f32" and a.how in ("sum", "mean")}
    arrays, valids = table_to_numpy(got)
    for cname, pc, jc, a, v in zip(got.names, got.columns, want.columns, arrays, valids):
        assert int(pc.dtype.id) == int(jc.dtype.id), cname
        np.testing.assert_array_equal(pc.valid_mask().numpy(), np.asarray(jc.valid_mask()),
                                      err_msg=cname)
        w = np.asarray(jc.data)
        if cname in f32_outputs:
            np.testing.assert_allclose(a.view(np.float64), w.view(np.float64), rtol=RTOL32,
                                       atol=ATOL32, err_msg=cname)
        else:
            np.testing.assert_array_equal(a.view(np.uint8), w.view(np.uint8), err_msg=cname)


def test_a_plan_gives_the_same_bits_twice():
    # the plan is stateless: a second call gives the same bits
    plan = _plan((pp, px), "grouped")
    pipe = pp.compile_plan(plan)
    a, _ = table_to_numpy(pipe(PF))
    b, _ = table_to_numpy(pipe(PF))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _dup_dim():
    keys = PD.column("dk").data.clone()
    keys[1] = keys[0]
    return Table([Column(pdt.INT32, data=keys)] + PD.columns[1:], PD.names)


def test_dense_duplicate_build_keys_raise():
    plan = pp.PlanSpec(joins=(pp.JoinSpec("dim", "fk", "dk", num_keys=50, payload=("dp",)),),
                       aggregates=(pp.Agg("dp", "sum"),))
    with pytest.raises(ValueError, match="duplicate build keys"):
        pp.compile_plan(plan)(PF, {"dim": _dup_dim()})
    # the reference raises on the same table
    jdim_keys = np.asarray(JD.column("dk").data).copy()
    jdim_keys[1] = jdim_keys[0]
    jdim = JTable([JColumn(jdt.INT32, data=jnp.asarray(jdim_keys))] + JD.columns[1:], JD.names)
    jplan = jp.PlanSpec(joins=(jp.JoinSpec("dim", "fk", "dk", num_keys=50, payload=("dp",)),),
                        aggregates=(jp.Agg("dp", "sum"),))
    with pytest.raises(ValueError, match="duplicate build keys"):
        jp.compile_plan(jplan)(JF, {"dim": jdim})


def test_sorted_duplicate_build_keys_raise():
    keys = PS.column("sk").data.clone()
    keys[2] = keys[3]
    sdim = Table([Column(pdt.INT64, data=keys)] + PS.columns[1:], PS.names)
    plan = pp.PlanSpec(joins=(pp.JoinSpec("sdim", "fk64", "sk", payload=("sp",)),),
                       aggregates=(pp.Agg("sp", "sum"),))
    with pytest.raises(ValueError, match="duplicate build keys"):
        pp.compile_plan(plan)(PF, {"sdim": sdim})


def test_semi_join_tolerates_duplicate_build_keys():
    plan = pp.PlanSpec(joins=(pp.JoinSpec("dim", "fk", "dk", num_keys=50, how="semi"),),
                       aggregates=(pp.Agg("f64", "count_all"),))
    pp.compile_plan(plan)(PF, {"dim": _dup_dim()})


def test_build_keys_outside_the_domain_raise():
    plan = pp.PlanSpec(joins=(pp.JoinSpec("dim", "fk", "dk", num_keys=30, payload=("dp",)),),
                       aggregates=(pp.Agg("dp", "sum"),))
    with pytest.raises(ValueError, match="outside the declared bounded domain"):
        pp.compile_plan(plan)(PF, {"dim": PD})


def test_group_keys_outside_the_domain_raise():
    plan = pp.PlanSpec(group_by=(pp.GroupKey("k1", 3),), aggregates=(pp.Agg("f64", "sum"),))
    with pytest.raises(ValueError, match="group keys outside"):
        pp.compile_plan(plan)(PF)
    jplan = jp.PlanSpec(group_by=(jp.GroupKey("k1", 3),), aggregates=(jp.Agg("f64", "sum"),))
    with pytest.raises(ValueError, match="group keys outside"):
        jp.compile_plan(jplan)(JF)


def test_filtered_out_of_domain_group_keys_do_not_raise():
    plan = pp.PlanSpec(filter=px.col("k1") < 3, group_by=(pp.GroupKey("k1", 3),),
                       aggregates=(pp.Agg("f64", "count_all"),))
    out = pp.compile_plan(plan)(PF)
    assert out.column("k1").to_numpy().max() < 3


def test_missing_build_table_raises():
    plan = _plan((pp, px), "dense_semi")
    with pytest.raises(ValueError, match="build tables"):
        pp.compile_plan(plan)(PF)


def test_plan_spec_validation():
    with pytest.raises(ValueError, match="at least one aggregate"):
        pp.PlanSpec()
    with pytest.raises(ValueError, match="unknown aggregate"):
        pp.PlanSpec(aggregates=(pp.Agg("x", "median"),))
    with pytest.raises(ValueError, match="unknown join"):
        pp.JoinSpec("b", "p", "k", how="outer")
    with pytest.raises(ValueError, match="payload"):
        pp.JoinSpec("b", "p", "k", how="semi", payload=("x",))


def test_spillable_builds_not_ported():
    """Spillable build tables ride the memory governor's catalog: a
    registered build fills in for ``builds=``, demotes to host and to disk
    between calls and re-materializes bit for bit, and
    ``unregister_builds`` drops its entry and its spill file."""
    from spark_rapids_jni_tpu_torch import memgov

    want, _, _ = _run("dense_inner")
    pipe = pp.compile_plan(_plan((pp, px), "dense_inner"))
    before = memgov.catalog().snapshot()["entries"]
    pipe.register_build("dim", PD)
    handle = pipe._build_handles["dim"]
    tiers = []
    for to_disk in (None, False, True):
        if to_disk is not None:
            handle.spill(to_disk=to_disk)
            tiers.append(handle.tier)
        got = pipe(PF)
        for pc, jc in zip(got.columns, want.columns):
            np.testing.assert_array_equal(pc.data.numpy().view(np.asarray(jc.data).dtype),
                                          np.asarray(jc.data))
        assert handle.tier == "device" and not handle.pinned
    assert tiers == ["host", "disk"]
    pipe.unregister_builds()
    assert memgov.catalog().snapshot()["entries"] == before


def test_int64_group_keys_narrow_like_the_reference():
    # a reference fault kept for parity (ROADMAP.md, section 3): the group
    # key narrows to int32 before its domain check, so 2^32 + 1 groups
    # with 1 instead of raising
    keys = np.array([0, 1, 2**32 + 1], np.int64)
    vals = np.array([5, 6, 7], np.int64)
    jt = JTable([JColumn(jdt.INT64, data=jnp.asarray(keys)), JColumn(jdt.INT64,
                                                                     data=jnp.asarray(vals))],
                ["k", "v"])
    pt = Table(carry_table([keys, vals], [pdt.INT64, pdt.INT64], device="cpu").columns, ["k", "v"])
    want = jp.compile_plan(jp.PlanSpec(group_by=(jp.GroupKey("k", 3),),
                                       aggregates=(jp.Agg("v", "sum"),)))(jt)
    got = pp.compile_plan(pp.PlanSpec(group_by=(pp.GroupKey("k", 3),),
                                      aggregates=(pp.Agg("v", "sum"),)))(pt)
    assert got.column("k").to_numpy().tolist() == [0, 1]
    np.testing.assert_array_equal(got.column("v_sum").to_numpy(), np.asarray(want.column("v_sum").data))
    assert got.column("v_sum").to_numpy().view(np.float64).tolist() == [5.0, 13.0]
