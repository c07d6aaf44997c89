"""Test helper: carry a JAX-package logical plan into the port.

``carry_plan`` rebuilds a reference plan tree as the port's, by class
name: every node and ``AggSpec`` by its dataclass fields, every ``PExpr``
by its attributes, every ``DType`` by its type id and scale. A subtree
the reference shares (a CTE used twice) stays shared, because the
compiler evaluates a shared node once. ``carry_tables`` moves the
reference's bound tables to the port's CPU tables through
``interop.carry_table``. Beyond ``plan`` and ``interop`` this imports
nothing of the port, and nothing of the JAX package: the caller hands
over the reference's objects.
"""

import dataclasses

import numpy as np

from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.plan import exprs as PX
from spark_rapids_jni_tpu_torch.plan import nodes as PN

__all__ = ["carry_plan", "carry_table", "carry_tables", "carry_dtype", "catalog_of"]


def carry_dtype(d):
    """A reference ``DType`` as the port's (same type id, same scale)."""
    return PX.DType(PX.TypeId(int(d.id)), d.scale)


def _port_class(obj):
    name = type(obj).__name__
    for mod in (PN, PX):
        cls = getattr(mod, name, None)
        if isinstance(cls, type):
            return cls
    raise TypeError(f"no port class named {name!r}")


def carry_plan(obj, _memo=None):
    """The port's copy of a reference plan node, expression or value."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)][1]
    if obj is None or isinstance(obj, (str, bool, int, float, np.generic)):
        return obj
    if isinstance(obj, tuple):
        return tuple(carry_plan(x, memo) for x in obj)
    if isinstance(obj, list):
        return [carry_plan(x, memo) for x in obj]
    if isinstance(obj, dict):
        return {k: carry_plan(v, memo) for k, v in obj.items()}
    if type(obj).__name__ == "DType":
        return carry_dtype(obj)
    cls = _port_class(obj)
    if dataclasses.is_dataclass(obj):
        out = cls(**{f.name: carry_plan(getattr(obj, f.name), memo)
                     for f in dataclasses.fields(obj)})
    else:  # a PExpr: same attributes, no constructor checks to replay
        out = object.__new__(cls)
        for k, v in vars(obj).items():
            setattr(out, k, carry_plan(v, memo))
    memo[id(obj)] = (obj, out)  # keep obj alive so its id is not reused
    return out


def _host_column(c):
    v = None if c.validity is None else np.asarray(c.validity)
    if c.dtype.id == PX.TypeId.STRING:
        return (np.asarray(c.offsets), np.asarray(c.chars)), carry_dtype(c.dtype), v
    return np.asarray(c.data), carry_dtype(c.dtype), v


def carry_table(t, device="cpu"):
    """One reference Table as the port's, same bits and names."""
    arrays, dtypes, valids = zip(*[_host_column(c) for c in t.columns]) if t.columns \
        else ((), (), ())
    out = interop.carry_table(list(arrays), list(dtypes), list(valids), device=device)
    out.names = list(t.names)
    return out


def carry_tables(tables, device="cpu"):
    """A reference catalog ``{name: Table}`` as the port's."""
    return {name: carry_table(t, device) for name, t in tables.items()}


def catalog_of(tables):
    return {t: {n: c.dtype for n, c in zip(tbl.names, tbl.columns)}
            for t, tbl in tables.items()}

