"""Port: ``parallel.table_ops.distributed_groupby_table`` against the JAX
package on the same seeded inputs, on conftest's 8 forced host devices
and a port mesh of 8 CPU shards: INT and STRING keys, INT32 / INT64 /
UINT64 / FLOAT64 values with an all-null group, capacity escalation and
the refusals. Every output table bit for bit, overflow flags exactly, as
``test_torch_table_ops.py`` holds the rest of the tier."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.parallel import table_ops as jops
from spark_rapids_jni_tpu.utils import errors as jerr

from spark_rapids_jni_tpu_torch.parallel import table_ops as pops
from test_torch_table_ops import N, _tables, _values, meshes  # noqa: F401  (the module's fixture)
from test_torch_tpch import _assert_tables_equal


# -- distributed_groupby_table --------------------------------------------------------------

AGGS = ("sum", "count", "min", "max", "mean")


@pytest.mark.parametrize("val_tn", ["INT32", "INT64", "UINT64", "FLOAT64"])
@pytest.mark.parametrize("keys", ["int", "string"])
def test_distributed_groupby_table_matches_reference(meshes, rng, keys, val_tn):
    jm, pm = meshes
    k1 = rng.integers(0, 13, N)
    if keys == "int":
        key_specs = [("k1", "INT64", k1.astype(np.int64), None),
                     ("k2", "INT32", rng.integers(0, 3, N).astype(np.int32), rng.random(N) > 0.1)]
    else:
        key_specs = [("k1", "STRING", [f"grp_{int(k)}" for k in k1], None)]
    vvalid = rng.random(N) > 0.25
    vvalid[k1 == 12] = False  # group 12's values are all null
    jt, pt = _tables(key_specs + [("v", val_tn, _values(rng, val_tn, N), vvalid)])
    key_names = [s[0] for s in key_specs]
    aggs = [("v", how, f"v_{how}") for how in AGGS]
    # the reference cannot take UINT64's min: its fill, 2^64 - 1, overflows
    # the jitted call's argument (ROADMAP.md section 3); the port's min is
    # held against numpy below instead
    jaggs = [a for a in aggs if not (val_tn == "UINT64" and a[1] == "min")]
    jout, jovf = jops.distributed_groupby_table(jt, key_names, jaggs, jm)
    pout, povf = pops.distributed_groupby_table(pt, key_names, aggs, pm)
    assert povf is jovf is False
    _assert_tables_equal(pout.select(key_names + [a[2] for a in jaggs]), jout)
    if val_tn == "UINT64":
        with pytest.raises(jerr.DeviceError, match="overflow"):
            jops.distributed_groupby_table(jt, key_names, [("v", "min", "m")], jm)
        vals = pt.column("v").to_numpy().view(np.uint64)
        kcols = [pt.column(k).to_pylist() for k in key_names]
        want = {}
        for i, key in enumerate(zip(*kcols)):
            if vvalid[i]:
                want[key] = min(want.get(key, vals[i]), vals[i])
        got = dict(zip(zip(*[pout.column(k).to_pylist() for k in key_names]),
                       pout.column("v_min").to_pylist()))
        assert {k: v for k, v in got.items() if v is not None} == {
            k: int(v) for k, v in want.items()}
    # Spark: an all-null group's aggregates are null, its count 0
    d = pout.to_pydict()
    all_null = [i for i, k in enumerate(d["k1"]) if k in (12, "grp_12")]
    assert all_null and all(d["v_count"][i] == 0 for i in all_null)
    for how in ("sum", "min", "max", "mean"):
        assert all(d[f"v_{how}"][i] is None for i in all_null)


def test_distributed_groupby_table_escalates_capacity(meshes, rng):
    jm, pm = meshes
    # one hot key: the skew-aware default capacity overflows, and the
    # defaulted call re-runs once at the capacity that cannot
    keys = np.where(rng.random(N) < 0.7, 5, rng.integers(0, 50, N)).astype(np.int64)
    jt, pt = _tables([("k", "INT64", keys, None),
                      ("v", "INT32", rng.integers(0, 100, N).astype(np.int32), None)])
    aggs = [("v", "sum", "s"), ("v", "max", "mx")]
    jout, jovf = jops.distributed_groupby_table(jt, ["k"], aggs, jm)
    pout, povf = pops.distributed_groupby_table(pt, ["k"], aggs, pm)
    assert povf is jovf is False
    _assert_tables_equal(pout, jout)
    # an explicit capacity does not escalate: the flag comes back
    jout, jovf = jops.distributed_groupby_table(jt, ["k"], aggs, jm, capacity=16)
    pout, povf = pops.distributed_groupby_table(pt, ["k"], aggs, pm, capacity=16)
    assert povf is jovf is True


def test_distributed_groupby_table_refusals(meshes):
    _, pm = meshes
    _, pt = _tables([("k", "INT32", np.arange(16, dtype=np.int32), None),
                     ("s", "STRING", ["a"] * 16, None)])
    with pytest.raises(ValueError, match="unknown agg"):
        pops.distributed_groupby_table(pt, ["k"], [("k", "median", "m")], pm)
    with pytest.raises(ValueError, match="STRING"):
        pops.distributed_groupby_table(pt, ["k"], [("s", "sum", "x")], pm)
