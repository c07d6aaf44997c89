"""Port: the in-mesh distribution tier (spark_rapids_jni_tpu_torch.parallel
mesh, device, shuffle's all-to-all exchange, distributed) against the JAX
package on the same seeded inputs. The JAX side runs on conftest's 8
forced host devices, the port on a mesh of 8 shards repeating the ``cpu``
device. Every comparison is exact: received buckets, masks, validity,
overflow flags, group keys (and their order) and integer sums are
integers and bits; the checksum is the reference's to the bit."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import hashing as jhash
from spark_rapids_jni_tpu.parallel import distributed as jdist
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import hashing as phash
from spark_rapids_jni_tpu_torch.parallel import device as pdevice
from spark_rapids_jni_tpu_torch.parallel import distributed as pdist
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel import shuffle as pshuffle
from spark_rapids_jni_tpu_torch.utils import errors as perr

P = 8
N = P * 64  # one row count for the whole file: the JAX side compiles per shape
CPU8 = [torch.device("cpu")] * P


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == P, "conftest must force the 8-device CPU mesh"
    return jmesh.make_mesh({"data": P}), pmesh.make_mesh({"data": P}, devices=CPU8)


def _jput(a, m):
    return jax.device_put(jnp.asarray(a), jmesh.row_sharding(m))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got).dtype == np.asarray(want).dtype


# -- the mesh and executor binding ---------------------------------------------------


def test_make_mesh_shapes_and_refusals(monkeypatch):
    m8 = pmesh.make_mesh({"data": P}, devices=CPU8)
    assert m8.shape == {"data": P} and m8.size == P
    m2 = pmesh.make_mesh({"dcn": 2, "data": 4}, devices=CPU8)
    assert m2.shape == {"dcn": 2, "data": 4}
    assert len(m2.axis_devices("data")) == 4 and len(m2.axis_devices("dcn")) == 2
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_mesh({"data": 3}, devices=CPU8)
    # the default is every CUDA device, and there is no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh({"data": 1})


def test_default_mesh_is_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = pmesh.make_mesh()
    assert m.shape == {"data": 4}
    assert m.axis_devices() == [torch.device("cuda", i) for i in range(4)]


def test_executor_binding(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    d0, d1 = pdevice.device_for_executor(0), pdevice.device_for_executor(1)
    assert d0 == torch.device("cuda", 0) and d1 == torch.device("cuda", 1)
    assert pdevice.device_for_executor(3) == d1  # round robin by ordinal
    with pdevice.bind_executor(3) as dev:
        assert dev == d1 and pdevice.current_device() == d1
        with pdevice.bind_executor(2) as inner:
            assert pdevice.current_device() == inner == d0
        assert pdevice.current_device() == d1
    assert pdevice.current_device() == d0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: pdevice.device_for_executor(0), pdevice.current_device):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_shard_rows_and_collectives():
    m = pmesh.make_mesh({"data": 4}, devices=CPU8[:4])
    x = torch.arange(24).reshape(12, 2)
    blocks = pmesh.shard_rows(x, m)
    assert [b.tolist() for b in blocks] == [x[3 * i:3 * i + 3].tolist() for i in range(4)]
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_rows(torch.arange(10), m)
    parts = [torch.arange(4 * 3).reshape(4, 3) + 100 * s for s in range(4)]
    recv = pmesh.all_to_all(parts)
    for d in range(4):
        assert recv[d].tolist() == [parts[s][d].tolist() for s in range(4)]
    gathered = pmesh.all_gather([torch.full((2,), s) for s in range(4)])
    assert all(g.tolist() == [[s, s] for s in range(4)] for g in gathered)
    # a mesh with a replica axis computes the first replica
    m2 = pmesh.make_mesh({"dcn": 2, "data": 4}, devices=CPU8)
    assert len(pmesh.shard_rows(x, m2)) == 4
    assert [b.tolist() for b in pmesh.row_sharding(m).shard(x)] == [b.tolist() for b in blocks]
    copies = pmesh.replicated(m2).shard(x)
    assert len(copies) == 8 and all(torch.equal(c, x) for c in copies)


# -- the exchange -----------------------------------------------------------------------


def test_all_to_all_rows_land_on_dest_shard(meshes, rng):
    jm, pm = meshes
    vals = rng.integers(0, 1_000_000, N).astype(np.int64)
    dest = rng.integers(0, P, N).astype(np.int32)
    (jr,), jmask, jovf = jshuffle.all_to_all_exchange([_jput(vals, jm)], _jput(dest, jm), jm)
    (pr,), pmask, povf = pshuffle.all_to_all_exchange([_t(vals)], _t(dest), pm)
    _same(pr, jr)
    _same(pmask, jmask)
    _same(povf, jovf)
    cap = N // P
    r, msk = _np(pr).reshape(P, P, cap), _np(pmask).reshape(P, P, cap)
    for s in range(P):  # every row on its destination shard
        assert sorted(r[s][msk[s]].tolist()) == sorted(vals[dest == s].tolist())


@pytest.mark.parametrize("on_overflow", ["raise", "flag", "retry"])
def test_exchange_overflow_contracts(meshes, on_overflow):
    jm, pm = meshes
    vals = np.arange(N, dtype=np.int64)
    dest = np.zeros((N,), np.int32)  # everything to shard 0
    cap = 4
    if on_overflow == "raise":
        with pytest.raises(perr.RetryableError, match="capacity=4"):
            pshuffle.all_to_all_exchange([_t(vals)], _t(dest), pm, capacity=cap)
        return
    (jr,), jmask, jovf = jshuffle.all_to_all_exchange(
        [_jput(vals, jm)], _jput(dest, jm), jm, capacity=cap, on_overflow=on_overflow)
    (pr,), pmask, povf = pshuffle.all_to_all_exchange(
        [_t(vals)], _t(dest), pm, capacity=cap, on_overflow=on_overflow)
    _same(povf, jovf)
    _same(pr, jr)
    _same(pmask, jmask)
    if on_overflow == "flag":
        assert bool(povf.any())
    else:  # the capacity doubled until every row landed
        assert not bool(povf.any())
        assert sorted(_np(pr)[_np(pmask)].tolist()) == list(range(N))


def test_bucketize_overflow_drops_not_corrupts():
    vals = np.array([10, 20, 30], np.int64)
    dest = np.zeros((3,), np.int32)
    jb, jmask, jovf = jshuffle._bucketize(jnp.asarray(vals), jnp.asarray(dest), n_parts=2,
                                          capacity=2)
    pb, pmask, povf = pshuffle._bucketize(_t(vals), _t(dest), n_parts=2, capacity=2)
    assert bool(povf) and bool(jovf)
    _same(pb, jb)
    _same(pmask, jmask)
    b, m = _np(pb), _np(pmask)
    assert m[0].sum() == 2 and m[1].sum() == 0
    assert sorted(b[0][m[0]].tolist()) == [10, 20]


def test_exchange_by_key_carries_validity(meshes):
    jm, pm = meshes
    keys = np.arange(N, dtype=np.int64) % 13
    vals = np.arange(N, dtype=np.int32) - 100
    validity = np.arange(N) % 3 != 0
    jt = JTable([JColumn(jdt.INT64, data=jnp.asarray(keys)),
                 JColumn(jdt.INT32, data=jnp.asarray(vals), validity=jnp.asarray(validity))],
                ["k", "v"])
    pt = Table([Column.from_numpy(keys, pdt.INT64, device="cpu"),
                Column.from_numpy(vals, pdt.INT32, validity, device="cpu")], ["k", "v"])
    jpairs, jmask, jovf = jshuffle.exchange_by_key(jmesh.shard_table_rows(jt, jm), ["k"], jm)
    ppairs, pmask, povf = pshuffle.exchange_by_key(pmesh.shard_table_rows(pt, pm), ["k"], pm)
    _same(pmask, jmask)
    _same(povf, jovf)
    (pk, pkv), (pv, pvv) = ppairs
    (jk, jkv), (jv, jvv) = jpairs
    assert pkv is None and jkv is None and pvv is not None
    for got, want in ((pk, jk), (pv, jv), (pvv, jvv)):
        _same(got, want)
    m = _np(pmask).reshape(-1)
    got = sorted(zip(_np(pv).reshape(-1)[m].tolist(), _np(pvv).reshape(-1)[m].tolist()))
    assert got == sorted(zip(vals.tolist(), validity.tolist()))


def test_exchange_by_key_refuses_strings(meshes):
    _, pm = meshes
    t = Table([Column.from_pylist(["a", "b"] * (N // 2), pdt.STRING, device="cpu")], ["s"])
    with pytest.raises(ValueError, match="exchange_table"):
        pshuffle.exchange_by_key(t, ["s"], pm)
    with pytest.raises(ValueError, match="on_overflow"):
        pshuffle.exchange_by_key(t, ["s"], pm, on_overflow="drop")


# -- the integrity check --------------------------------------------------------------


def test_exchange_checksum_matches_reference(rng):
    n = 257
    arrays = [
        rng.integers(-2**31, 2**31, n).astype(np.int32),  # negative values zero-extend
        rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
        rng.integers(-128, 128, n).astype(np.int8),
        rng.integers(-2**15, 2**15, n).astype(np.int16),
        rng.integers(0, 2, n).astype(bool),
        rng.standard_normal(n).astype(np.float32),
        rng.integers(-2**31, 2**31, (n, 4)).astype(np.int32),  # DECIMAL128 limbs
    ]
    want = jshuffle._exchange_checksum([jnp.asarray(a) for a in arrays])
    assert pshuffle._exchange_checksum([_t(a) for a in arrays]) == want
    assert pshuffle._exchange_checksum([_t(np.full(4, -1, np.int32))]) == 4 * 0xFFFFFFFF


@pytest.mark.parametrize("value", ["int64", "negative_int32"])
def test_corrupted_bucket_raises_data_corruption(meshes, monkeypatch, value):
    _, pm = meshes
    if value == "int64":
        vals = np.arange(N, dtype=np.int64)
    else:
        vals = -np.arange(1, N + 1, dtype=np.int32)  # every value negative
    dest = (np.arange(N) % P).astype(np.int32)
    real = pmesh.all_to_all
    calls = []

    def corrupting(parts):
        out = real(parts)
        calls.append(1)
        if len(calls) == 1:  # the payload lane: flip the low bit of one occupied slot
            out[3][2, 0] ^= 1
        return out

    monkeypatch.setattr(pmesh, "all_to_all", corrupting)
    with pytest.raises(perr.DataCorruption, match="shuffle.exchange"):
        pshuffle.all_to_all_exchange([_t(vals)], _t(dest), pm)
    # with checks off the same corruption passes unverified
    from spark_rapids_jni_tpu_torch.utils import integrity

    calls.clear()
    with integrity.disabled():
        pshuffle.all_to_all_exchange([_t(vals)], _t(dest), pm)


# -- the distributed group-by ------------------------------------------------------------


def _sgs(mod, keys, vals, present, capacity, conv):
    k, s, valid, ovf = mod.shard_groupby_sum(conv(keys), conv(vals), conv(present), capacity)
    return _np(k), _np(s), _np(valid), bool(_np(ovf))


@pytest.mark.parametrize("case", ["basic", "max_key_sentinel", "int32_no_wrap", "overflow"])
def test_shard_groupby_sum(case):
    if case == "basic":
        keys = np.array([5, 3, 5, 3, 9, 5, 0], np.int64)
        vals = np.array([1, 2, 3, 4, 5, 6, 100], np.int64)
        present = np.array([1, 1, 1, 1, 1, 1, 0], bool)
        cap, want = 8, {3: 6, 5: 10, 9: 5}
    elif case == "max_key_sentinel":  # a real iinfo.max key must not meet the padding
        big = np.iinfo(np.int64).max
        keys = np.array([big, 3, big, 3], np.int64)
        vals = np.array([1, 2, 4, 8], np.int64)
        present = np.array([1, 1, 0, 1], bool)
        cap, want = 4, {3: 10, big: 1}
    elif case == "int32_no_wrap":  # integral sums accumulate in int64
        keys = np.zeros((4,), np.int32)
        vals = np.full((4,), 2_000_000_000, np.int32)
        present = np.ones((4,), bool)
        cap, want = 2, {0: 8_000_000_000}
    else:
        keys = np.arange(6, dtype=np.int64)
        vals = np.ones((6,), np.int64)
        present = np.ones((6,), bool)
        cap, want = 4, None
    got = _sgs(pdist, keys, vals, present, cap, _t)
    ref = _sgs(jdist, keys, vals, present, cap, jnp.asarray)
    for g, w in zip(got[:3], ref[:3]):
        _same(g, w)
    assert got[3] == ref[3] == (want is None)
    if want is not None:
        k, s, valid, _ = got
        assert dict(zip(k[valid].tolist(), s[valid].tolist())) == want


@pytest.mark.parametrize("capacity", [None, N // P])
def test_distributed_groupby_sum_matches_reference(meshes, rng, capacity):
    jm, pm = meshes
    keys = rng.integers(0, 97, N).astype(np.int64)
    vals = rng.integers(-1000, 1000, N).astype(np.int64)
    jk, js, jovf = jdist.distributed_groupby_sum(_jput(keys, jm), _jput(vals, jm), jm,
                                                 capacity=capacity)
    pk, ps, povf = pdist.distributed_groupby_sum(_t(keys), _t(vals), pm, capacity=capacity)
    _same(pk, jk)  # keys in the same shard order
    _same(ps, js)
    assert povf is jovf is False
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = want.get(k, 0) + v
    assert dict(zip(pk.tolist(), ps.tolist())) == want
    assert len(pk) == len(set(pk.tolist()))  # each key reduced on exactly one shard


def test_distributed_groupby_sum_flags_group_overflow(meshes, rng):
    jm, pm = meshes
    keys = np.arange(N, dtype=np.int32)
    vals = np.ones((N,), np.int32)
    jk, js, jovf = jdist.distributed_groupby_sum(_jput(keys, jm), _jput(vals, jm), jm,
                                                 group_capacity=16)
    pk, ps, povf = pdist.distributed_groupby_sum(_t(keys), _t(vals), pm, group_capacity=16)
    assert povf is jovf is True


def test_distributed_groupby_multi_key_matches_reference(meshes, rng):
    jm, pm = meshes
    k1 = rng.integers(0, 9, N).astype(np.int64)
    k2 = rng.integers(0, 7, N).astype(np.int32)
    vals = rng.integers(-1000, 1000, N).astype(np.int64)
    (j1, j2), js, jovf = jdist.distributed_groupby_sum_multi(
        [_jput(k1, jm), _jput(k2, jm)], _jput(vals, jm), jm)
    (p1, p2), ps, povf = pdist.distributed_groupby_sum_multi([_t(k1), _t(k2)], _t(vals), pm)
    for g, w in ((p1, j1), (p2, j2), (ps, js)):
        _same(g, w)
    assert povf is jovf is False
    want = {}
    for a, b, v in zip(k1.tolist(), k2.tolist(), vals.tolist()):
        want[(a, b)] = want.get((a, b), 0) + v
    assert {(int(a), int(b)): int(s) for a, b, s in zip(p1, p2, ps)} == want


@pytest.mark.parametrize("np_dt,d", [(np.int32, pdt.INT32), (np.int64, pdt.INT64)])
def test_hash_dest_parity_with_partitioner(rng, np_dt, d):
    keys = rng.integers(-1000, 1000, 200).astype(np_dt)
    want = _np(phash.hash_partition_map([Column.from_numpy(keys, d, device="cpu")], P))
    got = pdist._hash_dest(_t(keys), P)
    _same(got, want)
    _same(got, jdist._hash_dest(jnp.asarray(keys), P))


def test_hash_dest_multi_parity_with_partitioner(rng):
    k1 = rng.integers(-(10**9), 10**9, 200).astype(np.int64)
    k2 = rng.integers(-1000, 1000, 200).astype(np.int32)
    k3 = rng.integers(0, 2, 200).astype(np.int32)
    want = _np(phash.hash_partition_map([Column.from_numpy(k1, pdt.INT64, device="cpu"),
                                         Column.from_numpy(k2, pdt.INT32, device="cpu")], P))
    got = pdist._hash_dest_multi([_t(k1), _t(k2)], P)
    _same(got, want)
    _same(got, jdist._hash_dest_multi([jnp.asarray(k1), jnp.asarray(k2)], P))
    _same(pdist._hash_dest_multi([_t(k1), _t(k2), _t(k3)], P),
          jdist._hash_dest_multi([jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(k3)], P))
    # a lone int16 lane is not B1's: it chains murmur3 as the reference does
    k4 = rng.integers(-1000, 1000, 200).astype(np.int16)
    _same(pdist._hash_dest_multi([_t(k4)], P), jdist._hash_dest_multi([jnp.asarray(k4)], P))
    _same(jhash.hash_partition_map([JColumn(jdt.INT64, data=jnp.asarray(k1))], P),
          pdist._hash_dest(_t(k1), P))
