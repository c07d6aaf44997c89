"""Port: ``parallel.table_ops.distributed_join_table`` against the JAX
package on the same seeded inputs, on conftest's 8 forced host devices
and a port mesh of 8 CPU shards: an inner join on two keys with null
keys, semi and anti joins, a STRING key through one shared dictionary,
and the output capacity's escalation. Every output table bit for bit,
overflow flags exactly, as ``test_torch_table_ops.py`` holds the rest of
the tier."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.parallel import table_ops as jops

from spark_rapids_jni_tpu_torch.parallel import table_ops as pops
from test_torch_table_ops import _tables, meshes  # noqa: F401  (the module's fixture)
from test_torch_tpch import _assert_tables_equal


# -- distributed_join_table -----------------------------------------------------------------


def test_distributed_join_inner_multikey(meshes, rng):
    jm, pm = meshes
    nl, nr = 700, 300
    jl, pl = _tables([("a", "INT32", rng.integers(0, 20, nl).astype(np.int32), None),
                      ("b", "INT64", rng.integers(0, 4, nl).astype(np.int64), None),
                      ("lv", "FLOAT64", rng.standard_normal(nl), rng.random(nl) > 0.1)])
    jr, pr = _tables([("a", "INT32", rng.integers(0, 20, nr).astype(np.int32),
                       rng.random(nr) > 0.1),  # null keys never match
                      ("b", "INT64", rng.integers(0, 4, nr).astype(np.int64), None),
                      ("rv", "INT32", rng.integers(0, 1000, nr).astype(np.int32), None),
                      ("lv", "INT32", rng.integers(0, 9, nr).astype(np.int32), None)])
    jout, jovf = jops.distributed_join_table(jl, jr, on=["a", "b"], mesh=jm, how="inner")
    pout, povf = pops.distributed_join_table(pl, pr, on=["a", "b"], mesh=pm, how="inner")
    assert povf is jovf is False
    assert pout.names == ["a", "b", "lv", "rv", "lv_right"]
    _assert_tables_equal(pout, jout)


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_distributed_join_semi_anti(meshes, rng, how):
    jm, pm = meshes
    nl, nr = 500, 120
    lk = rng.integers(0, 40, nl).astype(np.int64)
    rk = rng.integers(0, 25, nr).astype(np.int64)
    jl, pl = _tables([("k", "INT64", lk, None),
                      ("v", "INT32", rng.integers(0, 1000, nl).astype(np.int32), None)])
    jr, pr = _tables([("k", "INT64", rk, None)])
    jout, jovf = jops.distributed_join_table(jl, jr, on=["k"], mesh=jm, how=how)
    pout, povf = pops.distributed_join_table(pl, pr, on=["k"], mesh=pm, how=how)
    assert povf is jovf is False
    _assert_tables_equal(pout, jout)
    keep = np.isin(lk, rk) if how == "left_semi" else ~np.isin(lk, rk)
    assert sorted(pout.column("k").to_pylist()) == sorted(lk[keep].tolist())


def test_distributed_join_string_key(meshes, rng):
    jm, pm = meshes
    lk = [f"u{int(x)}" for x in rng.integers(0, 15, 200)]
    rk = [f"u{int(x)}" for x in rng.integers(0, 9, 60)]
    jl, pl = _tables([("k", "STRING", lk, None),
                      ("v", "INT32", np.arange(200, dtype=np.int32), None)])
    jr, pr = _tables([("k", "STRING", rk, None)])
    # one shared dictionary for both sides' keys, decoded on the way out
    jout, jovf = jops.distributed_join_table(jl, jr, on=["k"], mesh=jm, how="inner")
    pout, povf = pops.distributed_join_table(pl, pr, on=["k"], mesh=pm, how="inner")
    assert povf is jovf is False
    _assert_tables_equal(pout, jout)
    assert sorted(zip(pout.column("k").to_pylist(), pout.column("v").to_pylist())) == sorted(
        (lkey, i) for i, lkey in enumerate(lk) for r in rk if r == lkey)
    with pytest.raises(ValueError, match="not supported"):
        pops.distributed_join_table(pl, pr, on=["k"], mesh=pm, how="full")


def test_distributed_join_escalates_out_capacity(meshes):
    jm, pm = meshes
    # every left row matches every right row: the default output capacity
    # overflows and the defaulted join re-runs 4x larger
    jl, pl = _tables([("k", "INT32", np.zeros(64, np.int32), None),
                      ("v", "INT32", np.arange(64, dtype=np.int32), None)])
    jr, pr = _tables([("k", "INT32", np.zeros(24, np.int32), None),
                      ("w", "INT32", np.arange(24, dtype=np.int32), None)])
    jout, jovf = jops.distributed_join_table(jl, jr, on=["k"], mesh=jm)
    pout, povf = pops.distributed_join_table(pl, pr, on=["k"], mesh=pm)
    assert povf is jovf
    _assert_tables_equal(pout, jout)
