"""Port: the runtime core around the slice as a whole. Both packages run
convert_to_rows -> convert_from_rows -> groupby_sum_bounded, then
inner_join and the 8-shard exchange_by_key, with metrics and tracing
armed, retry armed under one seed and one seeded fault profile. The
results are equal, and so are the boundary crossings, the fault fires
and the counters (``op.*``, ``retry.*``, ``shuffle.*``,
``memory.split_retries`` and ``dispatch.tier.*`` under the documented
tier-name map)."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import Table as JTable
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.ops import row_conversion as jrc
from spark_rapids_jni_tpu.parallel import mesh as jmesh
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle
from spark_rapids_jni_tpu.utils import faultinj as jfi
from spark_rapids_jni_tpu.utils import metrics as jmet
from spark_rapids_jni_tpu.utils import retry as jretry
from spark_rapids_jni_tpu.utils import trace_sink as jsink
from spark_rapids_jni_tpu.utils import tracing as jtr

from spark_rapids_jni_tpu_torch.columnar import Column, Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.interop import carry_table
from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from spark_rapids_jni_tpu_torch.parallel import mesh as pmesh
from spark_rapids_jni_tpu_torch.parallel import shuffle as pshuffle
from spark_rapids_jni_tpu_torch.utils import dispatch as pdisp
from spark_rapids_jni_tpu_torch.utils import faultinj as pfi
from spark_rapids_jni_tpu_torch.utils import metrics as pmet
from spark_rapids_jni_tpu_torch.utils import retry as pretry
from spark_rapids_jni_tpu_torch.utils import trace_sink as psink
from spark_rapids_jni_tpu_torch.utils import tracing as ptr

P = 8
N = 256  # one row count: the JAX side compiles once per shape
K = 16
FAULTS = {"seed": 20260, "faults": {
    "convert_from_rows": {"type": "retryable", "percent": 50},
    "inner_join": {"type": "retryable", "percent": 40, "after": 1},
    "all_to_all_exchange": {"type": "retryable", "percent": 30},
}}
RETRY = dict(max_attempts=6, base_delay_ms=1.0, seed=77)
WATCH = ("op.", "retry.", "shuffle.", "memory.split_retries", "dispatch.tier.",
         "sidecar.integrity.")


def _inputs():
    rng = np.random.default_rng(14)
    k = rng.integers(0, K, N).astype(np.int32)
    v = rng.standard_normal(N).astype(np.float32)
    x = rng.integers(-2**40, 2**40, N).astype(np.int64)
    enc = [bytes(rng.integers(97, 123, int(rng.integers(1, 12)), dtype=np.uint8)) for _ in range(N)]
    offs = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(np.int32)
    chars = np.frombuffer(b"".join(enc), np.uint8).copy()
    valid = rng.random(N) < 0.9
    dk = np.arange(K, dtype=np.int32)
    dp = (rng.integers(0, 1000, K)).astype(np.int64)
    return k, v, x, (offs, chars), valid, dk, dp


def _run_reference(inp, mesh):
    k, v, x, (offs, chars), valid, dk, dp = inp
    t = JTable([JColumn(jdt.INT32, data=jnp.asarray(k)),
                JColumn(jdt.FLOAT32, data=jnp.asarray(v), validity=jnp.asarray(valid)),
                JColumn(jdt.INT64, data=jnp.asarray(x)),
                JColumn.strings_from_parts(offs, chars)], ["k", "v", "x", "s"])
    rows = jrc.convert_to_rows(t)
    back = jrc.convert_from_rows(rows[0], [c.dtype for c in t.columns])
    sums, counts = jagg.groupby_sum_bounded(back.columns[0].data, back.columns[1].data, K)
    back = JTable(back.columns, ["k", "v", "x", "s"])
    dim = JTable([JColumn(jdt.INT32, data=jnp.asarray(dk)),
                  JColumn(jdt.INT64, data=jnp.asarray(dp))], ["k", "p"])
    joined = jjoin.inner_join(back.select(["k", "x"]), dim, ["k"])
    ft = jmesh.shard_table_rows(JTable(t.columns[:3], ["k", "v", "x"]), mesh)
    pairs, mask, ovf = jshuffle.exchange_by_key(ft, ["k"], mesh, capacity=4, on_overflow="retry")
    return {
        "rows": np.asarray(rows[0].child.data).view(np.uint8),
        "back": [np.asarray(c.data) for c in back.columns[:3]],
        "back_s": (np.asarray(back.columns[3].offsets), np.asarray(back.columns[3].chars)),
        "sums": np.asarray(sums), "counts": np.asarray(counts),
        "joined": [np.asarray(c.data) for c in joined.columns],
        "ex": [np.asarray(d) for d, _ in pairs] + [np.asarray(mask), np.asarray(ovf)],
    }


def _run_port(inp, mesh):
    k, v, x, (offs, chars), valid, dk, dp = inp
    t = carry_table([k, v, x, (offs, chars)], [pdt.INT32, pdt.FLOAT32, pdt.INT64, pdt.STRING],
                    [None, valid, None, None], device="cpu")
    t = Table(t.columns, ["k", "v", "x", "s"])
    rows = prc.convert_to_rows(t)
    back = prc.convert_from_rows(rows[0], t.dtypes())
    sums, counts = pagg.groupby_sum_bounded(back.columns[0].data, back.columns[1].data, K)
    back = Table(back.columns, ["k", "v", "x", "s"])
    dim = carry_table([dk, dp], [pdt.INT32, pdt.INT64], device="cpu")
    dim = Table(dim.columns, ["k", "p"])
    joined = pjoin.inner_join(back.select(["k", "x"]), dim, ["k"])
    ft = pmesh.shard_table_rows(Table(t.columns[:3], ["k", "v", "x"]), mesh)
    pairs, mask, ovf = pshuffle.exchange_by_key(ft, ["k"], mesh, capacity=4, on_overflow="retry")
    return {
        "rows": rows[0].child.data.numpy().view(np.uint8),
        "back": [c.data.numpy() for c in back.columns[:3]],
        "back_s": (back.columns[3].offsets.numpy(), back.columns[3].chars.numpy()),
        "sums": sums.numpy(), "counts": counts.numpy(),
        "joined": [c.data.numpy() for c in joined.columns],
        "ex": [d.numpy() for d, _ in pairs] + [mask.numpy(), ovf.numpy()],
    }


def _armed(met, tr, retry, fi, sink, run):
    met.reset()
    retry.reset_stats()
    sink.reset_for_tests()
    fi.configure(FAULTS)
    try:
        with met.enabled(), tr.enabled(), retry.enabled(**RETRY):
            out = run()
    finally:
        fi.disable()
    snap = met.snapshot()
    # names other tests registered survive metrics.reset() at 0: only what
    # this run counted is compared
    counters = {n: c for n, c in snap["counters"].items() if n.startswith(WATCH) and c}
    hist_counts = {n: h["count"] for n, h in snap["histograms"].items()
                   if n.startswith(("op.", "shuffle.", "retry.")) and h["count"]}
    traces = [(r["name"], r["status"], _shape(r)) for r in sink.recorder().last(64)]
    met.reset()
    return out, counters, hist_counts, retry.stats(), traces


def _shape(rec):
    by_id = {s["span"]: s for s in rec["spans"]}

    def path(s):
        out = [s["name"]]
        while s.get("parent") in by_id:
            s = by_id[s["parent"]]
            out.append(s["name"])
        return tuple(reversed(out))
    return sorted((path(s), s["status"], tuple(sorted((s.get("annotations") or {}).items())))
                  for s in rec["spans"])


def _tier_mapped(counters):
    out = {}
    for n, c in counters.items():
        if n.startswith("dispatch.tier."):
            n = "dispatch.tier." + pdisp.TIER_NAMES.get(n.rsplit(".", 1)[1], n.rsplit(".", 1)[1])
        out[n] = c
    return out


@pytest.fixture(scope="module")
def runs():
    assert len(jax.devices()) == P
    inp = _inputs()
    jm = jmesh.make_mesh({"data": P})
    pm = pmesh.make_mesh({"data": P}, devices=[torch.device("cpu")] * P)
    ref = _armed(jmet, jtr, jretry, jfi, jsink, lambda: _run_reference(inp, jm))
    port = _armed(pmet, ptr, pretry, pfi, psink, lambda: _run_port(inp, pm))
    return ref, port, inp


def test_results_are_equal(runs):
    (ref, *_), (port, *_), inp = runs
    np.testing.assert_array_equal(port["rows"], ref["rows"])
    for a, b in zip(port["back"], ref["back"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port["back_s"], ref["back_s"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port["back"][0], inp[0])
    np.testing.assert_array_equal(port["counts"], ref["counts"])
    # the reference's float32 group-by bound (tests/test_pallas_kernels.py:65-66)
    np.testing.assert_allclose(port["sums"], ref["sums"], rtol=2e-6, atol=1e-3)
    for a, b in zip(port["joined"], ref["joined"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port["ex"], ref["ex"]):
        np.testing.assert_array_equal(a, b)


def test_counters_are_equal(runs):
    (_, rc, rh, rs, _), (_, pc, ph, ps, _), _ = runs
    assert pc == _tier_mapped(rc)
    assert ph == rh
    assert ps == rs


def test_the_faults_fired_and_were_retried(runs):
    (_, rc, _, rs, _), (_, pc, _, ps, _), _ = runs
    assert ps["retries"] > 0 and ps["exhausted"] == 0 and ps["fatal"] == 0
    assert pc.get("retry.retries.RetryableError", 0) == ps["retries"]
    assert ps["capacity_retries"] > 0 and pc["shuffle.capacity_retries"] == ps["capacity_retries"]
    for op in ("convert_to_rows", "convert_from_rows", "inner_join", "exchange_by_key",
               "all_to_all_exchange"):
        assert pc[f"op.{op}.calls"] >= 1
    assert pc["dispatch.tier.torch"] == 2  # the string decode and the join


def test_boundary_crossings_and_span_trees_are_equal(runs):
    (*_, rt), (*_, pt), _ = runs
    assert [t[0] for t in pt] == [t[0] for t in rt] == [
        "op.convert_to_rows", "op.convert_from_rows", "op.inner_join", "op.exchange_by_key"]
    mapped = [(n, s, [(p, st, tuple((k, pdisp.TIER_NAMES.get(v, v) if k == "tier" else v)
                                    for k, v in ann)) for p, st, ann in shape])
              for n, s, shape in rt]
    assert pt == mapped
