"""Port: the distributed Table tier (spark_rapids_jni_tpu_torch.parallel
.table_ops), the memory budget (utils.memory) and the error taxonomy
(utils.errors) against the JAX package on the same seeded inputs. The JAX
side runs on conftest's 8 forced host devices, the port on a mesh of 8
shards repeating the ``cpu`` device. Every output table is held bit for
bit (names, types, data bits, validity, row order, STRING offsets and
chars), overflow flags exactly: the group-by's FLOAT64 sums, means and
extrema go through the exact accumulator, so they are bit-identical too.
No FLOAT32 value is aggregated here. ``distributed_groupby_table`` is in
``test_torch_table_ops_groupby.py``, ``distributed_join_table`` in
``test_torch_table_ops_join.py``; both take the meshes, the inputs and
the checks from here."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import table_ops as jops
from spark_rapids_jni_tpu.utils import errors as jerr

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel import table_ops as pops
from spark_rapids_jni_tpu_torch.utils import errors as perr
from spark_rapids_jni_tpu_torch.utils import memory as pmem
from test_torch_tpch import _assert_tables_equal

P = 8
N = 1000  # one row count for most cases: the JAX side compiles per shape


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == P
    return (jmesh.make_mesh({"data": P}),
            pmesh.make_mesh({"data": P}, devices=[torch.device("cpu")] * P))


def _dtype(mod, tn):
    return mod.decimal128(-2) if tn == "DECIMAL128" else getattr(mod, tn)


def _tables(specs):
    """specs: (name, type name, values, validity or None) -> (JAX table,
    port table on the CPU) with the same bits; STRING values are a list
    of str or None."""
    jcols, pcols, names = [], [], []
    for name, tn, vals, valid in specs:
        if tn == "STRING":
            jcols.append(JColumn.from_pylist(vals, jdt.STRING))
            pcols.append(Column.from_pylist(vals, pdt.STRING, device="cpu"))
        else:
            jcols.append(JColumn.from_numpy(vals, _dtype(jdt, tn), valid))
            pcols.append(Column.from_numpy(vals, _dtype(pdt, tn), valid, device="cpu"))
        names.append(name)
    return JTable(jcols, names), Table(pcols, names)


def _values(rng, tn, n):
    if tn == "INT32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if tn == "INT64":
        return rng.integers(-2**62, 2**62, n, dtype=np.int64)
    if tn == "UINT64":  # values past 2^63: unsigned order and sums
        return rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    return (rng.standard_normal(n) * 1e3).astype(np.float64)


# -- capacity and the dictionary ------------------------------------------------------


def test_default_capacity_scales():
    for per, p in ((1 << 20, 64), (32, 8), (1024, 8), (1, 8), (100_001, 7)):
        assert pops.default_capacity(per, p) == jops.default_capacity(per, p)
    assert pops.default_capacity(1 << 20, 64) == 4 * (1 << 20) // 64
    assert pops.default_capacity(32, 8) == 32  # tiny shards: the floor wins


@pytest.mark.parametrize("vals", [
    ["apple", "pear", None, "apple", "", "Ünïcode", "pear"],
    ["same"] * 5,
    ["", ""],
])
def test_dict_roundtrip_matches_reference(vals):
    jcodes, jd = jops.dict_encode(JColumn.from_pylist(vals, jdt.STRING))
    pcodes, pd = pops.dict_encode(Column.from_pylist(vals, pdt.STRING, device="cpu"))
    np.testing.assert_array_equal(pcodes.data.numpy(), np.asarray(jcodes.data))
    np.testing.assert_array_equal(pd.lens.numpy(), np.asarray(jd.lens))
    np.testing.assert_array_equal(pd.chars.numpy(), np.asarray(jd.chars))
    out = pops.dict_decode(pcodes.data, pd, validity=pcodes.validity)
    assert out.to_pylist() == vals
    with pytest.raises(ValueError, match="STRING"):
        pops.dict_encode(Column.from_numpy(np.arange(3, dtype=np.int32), device="cpu"))


# -- exchange_table -------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [None, 4])
def test_exchange_table_matches_reference(meshes, rng, capacity):
    jm, pm = meshes
    keys = rng.integers(0, 37, N).astype(np.int64)
    strs = [f"name_{int(k) % 11}" if k % 5 else None for k in keys]
    jt, pt = _tables([("k", "INT64", keys, None),
                      ("v", "INT32", rng.integers(-100, 100, N).astype(np.int32),
                       rng.random(N) > 0.2),
                      ("s", "STRING", strs, None),
                      ("d", "DECIMAL128", rng.integers(-2**31, 2**31, (N, 4)).astype(np.uint32),
                       None)])
    jout, jovf = jops.exchange_table(jt, ["k"], jm, capacity=capacity)
    pout, povf = pops.exchange_table(pt, ["k"], pm, capacity=capacity)
    assert povf is jovf is (capacity is not None)
    _assert_tables_equal(pout, jout)
    if capacity is None:  # a permutation of the rows
        assert sorted(map(str, zip(*pout.to_pydict().values()))) == \
            sorted(map(str, zip(*pt.to_pydict().values())))


def test_exchange_table_nullable_string_key(meshes, rng):
    jm, pm = meshes
    strs = [None if i % 7 == 0 else f"u{int(x)}" for i, x in enumerate(rng.integers(0, 40, N))]
    jt, pt = _tables([("s", "STRING", strs, None),
                      ("v", "INT64", np.arange(N, dtype=np.int64), None)])
    jout, jovf = jops.exchange_table(jt, ["s"], jm)
    pout, povf = pops.exchange_table(pt, ["s"], pm)
    assert povf is jovf is False
    _assert_tables_equal(pout, jout)


# -- the memory budget ----------------------------------------------------------------------


def test_memory_budget_split_retry(meshes, monkeypatch):
    """A skewed key whose escalation would pass the device budget splits
    the batch and merges the halves, as the reference does."""
    jm, pm = meshes
    rng = np.random.default_rng(3)
    n = 4096
    keys = np.where(rng.integers(0, 10, n) < 9, 0, rng.integers(0, 50, n)).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    jt, pt = _tables([("k", "INT64", keys, None), ("v", "INT64", vals, None)])
    aggs = [("v", "sum", "v_sum"), ("v", "mean", "v_mean")]
    # sized so that the first escalation (capacity 512) passes it, and each
    # half's fits
    monkeypatch.setenv("SRJT_DEVICE_MEMORY_BUDGET", "300000")
    jout, jovf = jops.distributed_groupby_table(jt, ["k"], aggs, jm)
    before = pmem.split_retry_count()
    with pmem.budget(300000):
        pout, povf = pops.distributed_groupby_table(pt, ["k"], aggs, pm)
    assert pmem.split_retry_count() > before, "expected a memory-driven split"
    assert povf is jovf is False
    _assert_tables_equal(pout, jout)
    want = {k: int(vals[keys == k].sum()) for k in np.unique(keys)}
    assert dict(zip(pout.column("k").to_pylist(), pout.column("v_sum").to_pylist())) == want


def test_exchange_over_budget_raises_retryable(meshes):
    _, pm = meshes
    _, pt = _tables([("k", "INT64", np.arange(64, dtype=np.int64), None)])
    with pmem.budget(1000):
        with pytest.raises(pmem.MemoryBudgetExceeded) as ei:
            pops.exchange_table(pt, ["k"], pm)
    assert isinstance(ei.value, perr.RetryableError)  # Spark's task-retry class
    # a split cannot go below one row: that is fatal, not retryable
    one = Table([Column.from_numpy(np.arange(1, dtype=np.int64), device="cpu")], ["k"])
    with pytest.raises(perr.FatalDeviceError, match="single-row"):
        pops._groupby_split_retry(one, ["k"], [("k", "sum", "s")], pm, "data")


def test_memory_budget_resolution(monkeypatch):
    assert pmem.device_memory_budget("cpu") == 4 << 30  # the reference's CPU default
    with pmem.budget(0):  # an explicit 0 is a real budget
        assert pmem.device_memory_budget("cpu") == 0
        with pmem.budget(None):
            assert pmem.device_memory_budget("cpu") == 4 << 30
        assert pmem.device_memory_budget("cpu") == 0
    assert pmem.device_memory_budget("cpu") == 4 << 30
    assert pmem.exchange_bytes_estimate(16, 8, 100) == 2 * 8 * 100 * 16
    assert pmem.exchange_bytes_estimate(0, 8, 100) == 2 * 8 * 100
    from spark_rapids_jni_tpu.utils import memory as jmem

    for args in ((16, 8, 100), (0, 8, 100), (40, 64, 1 << 20)):
        assert pmem.exchange_bytes_estimate(*args) == jmem.exchange_bytes_estimate(*args)
    # on a card: half the total less the live bytes, floored at 64 MiB
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (10 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 1 << 30)
    monkeypatch.setattr(pmem, "_TOTAL", {})
    assert pmem.device_memory_budget("cuda:0") == (40 << 30) - (1 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 79 << 30)
    assert pmem.device_memory_budget("cuda:0") == 64 << 20
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmem.device_memory_budget()


# -- the error taxonomy ---------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "RESOURCE_EXHAUSTED: out of HBM", "INTERNAL: Accelerator device halted", "DEAD client",
    "DEADLINE_EXCEEDED: rpc", "Connection reset by peer", "CRC mismatch in frame",
    "something unknown", "INTERNAL: Accelerator ... channel UNAVAILABLE", "Overloaded: shed",
])
def test_classify_matches_reference(text):
    got, want = perr.classify(RuntimeError(text)), jerr.classify(RuntimeError(text))
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)


def test_classify_torch_oom_is_retryable():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert type(perr.classify(oom)) is perr.RetryableError
    assert type(perr.classify(RuntimeError("CUDA error: an illegal memory access"))) \
        is perr.FatalDeviceError
    e = perr.DataCorruption("x")
    assert perr.classify(e) is e
    with pytest.raises(ValueError):
        perr.classify(ValueError("bad input"))


def test_error_hierarchy():
    assert issubclass(pmem.MemoryBudgetExceeded, perr.RetryableError)
    assert issubclass(perr.Overloaded, perr.RetryableError)
    assert not issubclass(perr.DeadlineExceeded, perr.RetryableError)
    assert issubclass(perr.DeadlineExceeded, perr.DeviceError)
    assert issubclass(perr.FatalDeviceError, perr.DeviceError)
    o = perr.Overloaded("full", retry_after_s=2, cause="queue_full")
    assert o.retry_after_s == 2.0 and o.cause == "queue_full"
