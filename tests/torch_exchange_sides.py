"""Shared by the cross-process exchange parity files: one namespace a
package (the JAX reference and the port), so that a case runs the same
steps on each side and compares what they observed. Every port tensor
lies on the CPU. Tables cross between the sides as numpy arrays."""

import contextlib
import threading
import types

import numpy as np

import spark_rapids_jni_tpu  # noqa: F401  (turns on x64 before any jax use)
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as RColumn, Table as RTable
from spark_rapids_jni_tpu.columnar import dtype as rdt
from spark_rapids_jni_tpu.ops import copying as rcopying
from spark_rapids_jni_tpu.parallel import cluster as rcluster, shuffle as rshuffle
from spark_rapids_jni_tpu.utils import (deadline as rdeadline, errors as rerrors,
                                        faultinj as rfaultinj, metrics as rmetrics,
                                        retry as rretry, tracing as rtracing)

import torch
from spark_rapids_jni_tpu_torch.columnar import Column as PColumn, Table as PTable
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import copying as pcopying
from spark_rapids_jni_tpu_torch.parallel import cluster as pcluster, shuffle as pshuffle
from spark_rapids_jni_tpu_torch.utils import (deadline as pdeadline, errors as perrors,
                                              faultinj as pfaultinj, knobs as pknobs,
                                              metrics as pmetrics, retry as pretry,
                                              tracing as ptracing)

REF = types.SimpleNamespace(
    name="reference", prefix="SRJT_", shuffle=rshuffle, cluster=rcluster, copying=rcopying,
    deadline=rdeadline, errors=rerrors, faultinj=rfaultinj, metrics=rmetrics, retry=rretry,
    tracing=rtracing, kw={},
    int64_table=lambda a, names: RTable([RColumn(rdt.INT64, data=jnp.asarray(x)) for x in a],
                                        names),
    host=lambda col: np.asarray(col.data),
    valid=lambda col: None if col.validity is None else np.asarray(col.validity).astype(bool),
)
PORT = types.SimpleNamespace(
    name="port", prefix=pknobs.PREFIX, shuffle=pshuffle, cluster=pcluster, copying=pcopying,
    deadline=pdeadline, errors=perrors, faultinj=pfaultinj, metrics=pmetrics, retry=pretry,
    tracing=ptracing, kw={"device": "cpu"},
    int64_table=lambda a, names: PTable([PColumn(pdt.INT64, data=torch.from_numpy(np.asarray(x)))
                                         for x in a], names),
    host=lambda col: col.data.cpu().numpy(),
    valid=lambda col: None if col.validity is None else col.validity.cpu().numpy().astype(bool),
)
SIDES = (REF, PORT)


def counter(side, name):
    return side.metrics.registry().value(name)


def demo(side, rows, seed):
    return side.shuffle._demo_table(rows, seed, **side.kw)


def shard(side, full, rows, world, rank):
    lo, hi = side.shuffle._shard_bounds(rows, world, rank)
    return side.copying.slice_table(full, lo, hi)


def dense(side, table, names=None):
    """A table as {name: (host data, host validity or None)}."""
    names = table.names if names is None else names
    return {n: (side.host(c), side.valid(c)) for n, c in zip(names, table.columns)}


def same_dense(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert np.array_equal(a[n][0], b[n][0]), n
        assert (a[n][1] is None) == (b[n][1] is None), n
        if a[n][1] is not None:
            assert np.array_equal(a[n][1], b[n][1]), n


def run_ranks(fns, timeout=120):
    """Run ``fns[rank]()`` each in its own thread; returns {rank: result}
    and re-raises the first error."""
    out, errs = {}, []

    def run(r, fn):
        try:
            out[r] = fn()
        except BaseException as e:  # surfaced below, after every join
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r, fn)) for r, fn in fns.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a rank never finished"
    if errs:
        raise errs[0]
    return out


def exchange_world(sides, rows, seed, epoch=0, topology=None, arm=None, scope=None):
    """One in-process world, rank r served by ``sides[r]``: every rank
    exchanges its shard of the seeded demo table on ``k``. ``arm(ex)``
    runs on each exchange before the round, and each rank runs inside
    ``scope(side)`` when one is given. Returns {rank: dense received
    table}."""
    world = len(sides)
    exs = [s.shuffle.TcpExchange(r, **s.kw) for r, s in enumerate(sides)]
    try:
        addrs = {r: ex.address for r, ex in enumerate(exs)}
        fulls = {s.name: demo(s, rows, seed) for s in sides}
        for ex in exs:
            if arm is not None:
                arm(ex)

        def rank_fn(r):
            s = sides[r]
            peers = {q: a for q, a in addrs.items() if q != r}
            with (scope(s) if scope is not None else contextlib.nullcontext()):
                local = exs[r].exchange_table(shard(s, fulls[s.name], rows, world, r), ["k"],
                                              peers, epoch=epoch, topology=topology)
            return dense(s, local)

        with REF.retry.enabled(max_attempts=40, base_delay_ms=5, max_delay_ms=50), \
                PORT.retry.enabled(max_attempts=40, base_delay_ms=5, max_delay_ms=50):
            return run_ranks({r: (lambda r=r: rank_fn(r)) for r in range(world)})
    finally:
        for ex in exs:
            ex.close()


def groupby_matches_single_host(side, results, full):
    """The concatenated per-rank ``_local_groupby_sum`` results, sorted by
    key, against the single-host one."""
    ref = side.shuffle._local_groupby_sum(full)
    got = side.copying.concatenate([results[r] for r in sorted(results)])
    order = np.argsort(side.host(got.column("k")), kind="stable")
    for name in ("k", "s", "c"):
        assert np.array_equal(side.host(got.column(name))[order], side.host(ref.column(name))), \
            f"{name} diverged from the single-host result"
