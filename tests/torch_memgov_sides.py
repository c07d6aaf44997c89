"""Shared by the memory-governor parity files: one namespace a package (the
JAX reference and the port), so that a case runs the same steps on each
side and compares what it observed. Every port tensor lies on the CPU.

Counters are compared as deltas with zero-valued entries dropped on both
sides: ``metrics.reset()`` keeps registered names at 0 in both packages,
so which files ran earlier in a worker must not decide a comparison."""

import sys
import types

import numpy as np

import spark_rapids_jni_tpu  # noqa: F401  (turns on x64 before any jax use)
import jax
import jax.numpy as jnp
from spark_rapids_jni_tpu import memgov as rmemgov
from spark_rapids_jni_tpu.columnar import Column as RColumn, Table as RTable
from spark_rapids_jni_tpu.columnar import dtype as rdt
from spark_rapids_jni_tpu.columnar import frames as rframes
from spark_rapids_jni_tpu.memgov import persist as rpersist
from spark_rapids_jni_tpu.utils import (deadline as rdeadline, dispatch as rdispatch,
                                        errors as rerrors, faultinj as rfaultinj, integrity as rintegrity,
                                        memory as rmemory, metrics as rmetrics,
                                        retry as rretry)

import torch
from spark_rapids_jni_tpu_torch import memgov as pmemgov
from spark_rapids_jni_tpu_torch.columnar import Column as PColumn, Table as PTable
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar import frames as pframes
from spark_rapids_jni_tpu_torch.memgov import persist as ppersist
from spark_rapids_jni_tpu_torch.utils import (deadline as pdeadline, dispatch as pdispatch,
                                              errors as perrors, faultinj as pfaultinj, integrity as pintegrity,
                                              knobs as pknobs, memory as pmemory,
                                              metrics as pmetrics, retry as pretry)


# the package's ``catalog()`` accessor shadows the submodule's name
pcatalog = sys.modules["spark_rapids_jni_tpu_torch.memgov.catalog"]


def _r_table(cols, names):
    """[(dtype name, numpy data, numpy validity or None)] -> reference Table."""
    return RTable([RColumn(getattr(rdt, d), data=jnp.asarray(a),
                           validity=None if v is None else jnp.asarray(v))
                   for d, a, v in cols], names)


def _p_table(cols, names):
    """The same in the port: ``data`` is the reference's storage (FLOAT64
    as uint64 bits), carried bit for bit."""
    from spark_rapids_jni_tpu_torch.columnar.column import _host_to_tensor

    cpu = torch.device("cpu")
    out = []
    for d, a, v in cols:
        dtype = getattr(pdt, d)
        host = np.asarray(a).astype(dtype.np_dtype, copy=False)
        out.append(PColumn(dtype, data=_host_to_tensor(host, dtype.torch_dtype, cpu),
                           validity=None if v is None else torch.from_numpy(np.asarray(v))))
    return PTable(out, names)


def _r_bytes(tree):
    return [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(tree)]


def _p_bytes(tree):
    leaves = pcatalog.tree_leaves(tree)
    _, defs = pcatalog.flatten(tree)
    return [pcatalog._to_host(t, d).tobytes()
            for t, d in zip(leaves, pcatalog._leaf_defs(defs))]


REF = types.SimpleNamespace(
    name="reference", prefix="SRJT_", memgov=rmemgov, persist=rpersist, frames=rframes,
    deadline=rdeadline, dispatch=rdispatch, errors=rerrors, faultinj=rfaultinj, integrity=rintegrity,
    memory=rmemory, metrics=rmetrics, retry=rretry,
    zeros=lambda n: jnp.zeros(n, jnp.float64),
    arange=lambda n: jnp.arange(n),
    array=jnp.asarray,
    table=_r_table,
    tree_bytes=_r_bytes,
    host=lambda col: np.asarray(col.data),
)
PORT = types.SimpleNamespace(
    name="port", prefix=pknobs.PREFIX, memgov=pmemgov, persist=ppersist, frames=pframes,
    deadline=pdeadline, dispatch=pdispatch, errors=perrors, faultinj=pfaultinj, integrity=pintegrity,
    memory=pmemory, metrics=pmetrics, retry=pretry,
    zeros=lambda n: torch.zeros(n, dtype=torch.float64),
    arange=lambda n: torch.arange(n),
    array=lambda a: torch.from_numpy(np.asarray(a).copy()),
    table=_p_table,
    tree_bytes=_p_bytes,
    host=lambda col: col.to_numpy() if col.dtype.is_fixed_width else col.data.cpu().numpy(),
)
SIDES = (REF, PORT)


def counters(side, prefix=("memgov.",)):
    return {k: v for k, v in side.metrics.counters_snapshot().items()
            if k.startswith(prefix)}


def delta(before, after):
    """Counter deltas with zero-valued entries dropped."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def setenv(monkeypatch, side, suffix, value):
    monkeypatch.setenv(side.prefix + suffix, str(value))


def both(case, prefix=("memgov.",)):
    """Run ``case(side)`` on the reference and on the port; hold the port's
    observations and its counter deltas (zeros dropped) to the reference's."""
    seen = []
    for s in SIDES:
        c0 = counters(s, prefix)
        obs = case(s)
        seen.append((obs, delta(c0, counters(s, prefix))))
    assert seen[1] == seen[0]
    return seen[0]


def clean(side):
    side.faultinj.disable()
    side.retry.disable()
    side.retry.reset_stats()
    side.memgov.reset()
    side.memgov._enabled = side.memgov._env_enabled()
