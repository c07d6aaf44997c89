"""Port: models/tpcds's queries over gen_web (q94, q95) against the JAX
package: the order count and the two float64 totals bit for bit, at
default and other parameters, including one that selects nothing; and
q95_distributed against the JAX package's (slow). The tables are
``test_torch_tpcds.py``'s."""

import numpy as np
import pytest

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.models import tpcds as jtpcds

from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds
from test_torch_tpcds import _query, _tables
from test_torch_tpcds_wide import _assert_same_result, _mesh8


_Q95_CASES = [
    (13, {}),
    (14, {}),
    (13, {"ship_lo": 2000, "ship_hi": 2100}),  # past every ship date: nothing selected
]
# two cases over 20 s alone run with -m slow; the rest stay in tier 1
_Q95_SLOW = {("q94", 0), ("q94", 1)}


@pytest.mark.parametrize("name,seed,params", [
    pytest.param(name, seed, params, id=f"{seed}-params{i}-{name}",
                 marks=[pytest.mark.slow] if (name, i) in _Q95_SLOW else [])
    for name in ("q94", "q95") for i, (seed, params) in enumerate(_Q95_CASES)])
def test_q95_family_identical(name, seed, params):
    got, want = _query("gen_web", name, seed, params)
    assert got.keys() == want.keys()
    assert got["order_count"] == want["order_count"]
    for k in ("total_shipping_cost", "total_net_profit"):
        assert np.float64(got[k]).view(np.uint64) == np.float64(want[k]).view(np.uint64), k


@pytest.mark.slow  # ~25 s: the JAX side compiles its four shard_map programs
def test_q95_distributed_matches_reference():
    """The port's q95_distributed against the JAX package's on conftest's
    8 host devices, the same tables: count and float bits identical."""
    from spark_rapids_jni_tpu.parallel.mesh import make_mesh as jmake_mesh

    jt, pt = _tables("gen_web", 13)
    got = ptpcds.q95_distributed(pt, _mesh8())
    want = jtpcds.q95_distributed(jt, jmake_mesh({"data": 8}))
    _assert_same_result(got, want)
