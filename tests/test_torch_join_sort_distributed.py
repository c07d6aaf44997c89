"""Port: the distributed join and sort (spark_rapids_jni_tpu_torch.parallel
join_distributed and sort_distributed) against the JAX package on the same
seeded inputs. The JAX side runs on conftest's 8 forced host devices, the
port on a mesh of 8 shards repeating the ``cpu`` device. Every comparison
is exact: pair indices, masks, overflow flags, the joined (key, left,
right) rows in the reference's order, and the sorted keys."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel.join_distributed import (
    distributed_inner_join as j_join,
    shard_join_pairs as j_pairs,
)
from spark_rapids_jni_tpu.parallel.sort_distributed import distributed_sort as j_sort

from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel.join_distributed import (
    distributed_inner_join as p_join,
    shard_join_pairs as p_pairs,
)
from spark_rapids_jni_tpu_torch.parallel.sort_distributed import distributed_sort as p_sort

P = 8
N = P * 128  # one row count for the file: the JAX side compiles per shape and capacity


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == P
    return (jmesh.make_mesh({"data": P}),
            pmesh.make_mesh({"data": P}, devices=[torch.device("cpu")] * P))


def _jput(a, m):
    return jax.device_put(jnp.asarray(a), jmesh.row_sharding(m))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


PAIR_CASES = {
    # 1 matches once; each left 2 matches right rows {0, 2}; 3 matches none
    "basic": ([1, 2, 3, 2], [1, 1, 1, 1], [2, 9, 2, 1], [1, 1, 1, 1], 16,
              [(1, 1), (2, 2), (2, 2), (2, 2), (2, 2)], False),
    # the middle left row and the last right row are exchange padding
    "absent_and_empty_runs": ([5, 5, 7], [1, 0, 1], [5, 7, 7], [1, 1, 0], 8,
                              [(5, 5), (7, 7)], False),
    # 16 pairs > 8: capped and flagged
    "overflow_flag": ([0] * 4, [1] * 4, [0] * 4, [1] * 4, 8, [(0, 0)] * 8, True),
    # a real max-valued key must not match the padding's max sentinel
    "max_key": ([2**63 - 1, 4], [1, 1], [2**63 - 1, 3, 2**63 - 1], [1, 1, 0], 8,
                [(2**63 - 1, 2**63 - 1)], False),
}


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_shard_join_pairs(case):
    lk, lp, rk, rp, cap, want, want_ovf = PAIR_CASES[case]
    lk, rk = np.array(lk, np.int64), np.array(rk, np.int64)
    lp, rp = np.array(lp, bool), np.array(rp, bool)
    got = p_pairs(_t(lk), _t(lp), _t(rk), _t(rp), cap)
    ref = j_pairs(jnp.asarray(lk), jnp.asarray(lp), jnp.asarray(rk), jnp.asarray(rp), cap)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    li, ri, pv, ovf = (g.numpy() for g in got)
    assert sorted((int(lk[a]), int(rk[b])) for a, b in zip(li[pv], ri[pv])) == sorted(want)
    assert bool(ovf) is want_ovf


@pytest.mark.parametrize("case", ["matches", "disjoint_keys", "int32_small_capacity"])
def test_distributed_inner_join(meshes, rng, case):
    jm, pm = meshes
    if case == "matches":
        lk = rng.integers(0, 50, N).astype(np.int64)
        rk = rng.integers(0, 50, N).astype(np.int64)
        kw = {"capacity": N, "out_capacity": 64 * N // P}
    elif case == "disjoint_keys":
        lk = np.arange(N, dtype=np.int64)
        rk = np.arange(N, 2 * N, dtype=np.int64)  # no overlap
        kw = {}
    else:  # int32 keys, a capacity the join's output passes: flagged
        lk = rng.integers(0, 50, N).astype(np.int32)
        rk = rng.integers(0, 50, N).astype(np.int32)
        kw = {"capacity": N // P, "out_capacity": 64}
    lv = rng.integers(0, 1000, N).astype(np.int64)
    rv = rng.integers(-1000, 0, N).astype(np.int32)
    want = j_join(_jput(lk, jm), _jput(lv, jm), _jput(rk, jm), _jput(rv, jm), jm, **kw)
    got = p_join(_t(lk), _t(lv), _t(rk), _t(rv), pm, **kw)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[3] is want[3]
    if case == "matches":
        assert not got[3]
        expect = sorted((a, x, b, y) for a, x in zip(lk.tolist(), lv.tolist())
                        for b, y in zip(rk.tolist(), rv.tolist()) if a == b)
        assert sorted(zip(got[0].tolist(), got[1].tolist(), got[0].tolist(), got[2].tolist())) \
            == expect
    elif case == "disjoint_keys":
        assert len(got[0]) == 0 and not got[3]
    else:
        assert got[3]


@pytest.mark.parametrize("case", ["uniform", "skewed", "descending", "extreme_skew_capacity"])
def test_distributed_sort(meshes, rng, case):
    jm, pm = meshes
    kw = {}
    if case == "uniform":
        keys = rng.integers(-(10**9), 10**9, N).astype(np.int64)
    elif case == "skewed":  # many duplicates of one key stress the splitters
        keys = np.where(rng.random(N) < 0.6, 7, rng.integers(0, 1000, N)).astype(np.int64)
    elif case == "descending":
        keys = rng.integers(0, 100, N).astype(np.int64)
        kw = {"descending": True}
    else:  # one value: every row routes to one shard, past the capacity
        keys = np.zeros(N, np.int64)
        kw = {"capacity": 32}
    out, ovf = p_sort(_t(keys), pm, **kw)
    jout, jovf = j_sort(_jput(keys, jm), jm, **kw)
    np.testing.assert_array_equal(out, jout)
    assert ovf is jovf
    if case == "extreme_skew_capacity":
        assert ovf  # detected, not silent
    else:
        assert not ovf
        want = np.sort(keys)
        np.testing.assert_array_equal(out, want[::-1] if kw.get("descending") else want)
