"""Typed expression tree for the logical-plan IR (port of the JAX
package's ``plan/exprs.py``; the class names and attributes of the
``PExpr`` tree are the reference's).

The run-time expression tier (``ops/expressions.py``) is evaluation-only:
it answers "what are the values" given a Table, but a *plan* needs two
things a closure cannot give — the output DTYPE before any data exists
(schema inference, the contract memgov estimates and UNION validation
hang on) and the REFERENCED column set (predicate/projection pushdown).
This module is that static layer: a small AST mirroring the runtime
surface (arithmetic, comparisons, 3VL and/or/not, is_null, cast, CASE
WHEN, LIKE/RLIKE) where every node can

- ``dtype(schema)``     -> the output DType under a name->DType schema,
- ``refs()``            -> the column names it reads,
- ``lower()``           -> the equivalent ``ops.expressions.Expression``,
- ``structure()``       -> a canonical nested tuple (structural equality
                           for the rewrite-idempotence contract).

Null/3VL semantics are entirely the runtime tier's; this layer only
types and routes. Aggregate-output and division typing follow the fused
pipeline's materialization contract (``pipeline._wrap_result``):
divisions and floating arithmetic land in FLOAT64.
"""

from __future__ import annotations

import re as _re
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from ..ops import expressions as rt

__all__ = ["PExpr", "pcol", "plit", "pwhen", "plike", "prlike", "ppart",
           "PlanError", "map_literals"]


class PlanError(ValueError):
    """A plan failed validation (unknown column, dtype mismatch, an
    unreducible sugar node at lowering time)."""


Schema = Dict[str, DType]

_INT_RANK = {
    TypeId.INT8: 1, TypeId.UINT8: 1, TypeId.INT16: 2, TypeId.UINT16: 2,
    TypeId.INT32: 3, TypeId.UINT32: 3, TypeId.INT64: 4, TypeId.UINT64: 4,
}


def _is_numeric(d: DType) -> bool:
    return d.is_integral or d.is_floating


def _promote(a: DType, b: DType) -> DType:
    """Binary arithmetic result type: floats dominate (FLOAT64 over
    FLOAT32), otherwise the wider integer (signed wins a width tie,
    mirroring the reference's promotion lattice for the lanes this tier uses)."""
    if a.id == b.id:
        return DType(a.id)
    if dt.FLOAT64.id in (a.id, b.id):
        return dt.FLOAT64
    if a.is_floating or b.is_floating:
        if a.is_floating and b.is_floating:
            return dt.FLOAT64
        return dt.FLOAT64 if (a if a.is_floating else b).id == TypeId.FLOAT64 else dt.FLOAT32
    if a.is_integral and b.is_integral:
        ra, rb = _INT_RANK[a.id], _INT_RANK[b.id]
        if ra == rb:
            return a if a.is_signed else b
        return a if ra > rb else b
    raise PlanError(f"no arithmetic promotion between {a!r} and {b!r}")


class PExpr:
    """Base plan expression. Operator sugar mirrors the runtime tier so
    plans read like the hand-built pipelines they replace."""

    def dtype(self, schema: Schema) -> DType:
        raise NotImplementedError

    def refs(self) -> FrozenSet[str]:
        raise NotImplementedError

    def lower(self) -> rt.Expression:
        raise NotImplementedError

    def structure(self) -> tuple:
        raise NotImplementedError

    # -- operator sugar (mirrors ops/expressions.py) -------------------------
    def _bin(self, other, op):
        return _PBin(op, self, _wrap(other))

    def __add__(self, o):
        return self._bin(o, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __mod__(self, o):
        return self._bin(o, "mod")

    def __eq__(self, o):  # noqa: A003 - comparison builds a node, like the runtime tier
        return self._bin(o, "eq")

    def __ne__(self, o):
        return self._bin(o, "ne")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __le__(self, o):
        return self._bin(o, "le")

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __ge__(self, o):
        return self._bin(o, "ge")

    def __and__(self, o):
        return _PBin("and", self, _wrap(o))

    def __or__(self, o):
        return _PBin("or", self, _wrap(o))

    def __invert__(self):
        return _PNot(self)

    def is_null(self):
        return _PIsNull(self, True)

    def is_not_null(self):
        return _PIsNull(self, False)

    def cast(self, d: DType):
        return _PCast(self, d)

    __hash__ = None


_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
_BOOL_OPS = ("and", "or")
_ARITH_OPS = ("add", "sub", "mul", "mod")


class _PCol(PExpr):
    def __init__(self, name: str):
        self.name = name

    def dtype(self, schema: Schema) -> DType:
        if self.name not in schema:
            raise PlanError(
                f"column {self.name!r} not in schema {sorted(schema)}"
            )
        return schema[self.name]

    def refs(self):
        return frozenset({self.name})

    def lower(self):
        return rt.col(self.name)

    def structure(self):
        return ("col", self.name)


class _PLit(PExpr):
    """Literal. ``value=None`` is the typed SQL NULL — a dtype is
    required so CASE/UNION schemas stay inferable."""

    def __init__(self, value, d: Optional[DType] = None):
        if value is None and d is None:
            raise PlanError("null literal needs an explicit dtype")
        self.value = value
        self.d = d

    def dtype(self, schema: Schema) -> DType:
        if self.d is not None:
            return self.d
        if isinstance(self.value, bool):
            return dt.BOOL8
        if isinstance(self.value, (int, np.integer)):
            return dt.INT64 if not isinstance(self.value, np.int32) else dt.INT32
        if isinstance(self.value, (float, np.floating)):
            return dt.FLOAT64
        raise PlanError(f"untypable literal {self.value!r}")

    def refs(self):
        return frozenset()

    def lower(self):
        return rt.lit(self.value)

    def structure(self):
        d = None if self.d is None else (int(self.d.id), self.d.scale)
        return ("lit", self.value, d)


class _PBin(PExpr):
    def __init__(self, op: str, a: PExpr, b: PExpr):
        self.op, self.a, self.b = op, a, b

    def dtype(self, schema: Schema) -> DType:
        da, db = self.a.dtype(schema), self.b.dtype(schema)
        if self.op in _CMP_OPS:
            return dt.BOOL8
        if self.op in _BOOL_OPS:
            return dt.BOOL8
        if self.op == "div":
            return dt.FLOAT64  # SQL divide is always floating
        if not (_is_numeric(da) and _is_numeric(db)):
            raise PlanError(f"{self.op} needs numeric operands, got {da!r}, {db!r}")
        # a weak (host-scalar) literal adopts the column operand's dtype,
        # matching the runtime tier's promotion
        if isinstance(self.a, _PLit) and self.a.d is None and da.is_integral:
            return db
        if isinstance(self.b, _PLit) and self.b.d is None and db.is_integral:
            return da
        return _promote(da, db)

    def refs(self):
        return self.a.refs() | self.b.refs()

    def lower(self):
        la, lb = self.a.lower(), self.b.lower()
        return {
            "add": lambda: la + lb, "sub": lambda: la - lb,
            "mul": lambda: la * lb, "div": lambda: la / lb,
            "mod": lambda: la % lb,
            "eq": lambda: la == lb, "ne": lambda: la != lb,
            "lt": lambda: la < lb, "le": lambda: la <= lb,
            "gt": lambda: la > lb, "ge": lambda: la >= lb,
            "and": lambda: la & lb, "or": lambda: la | lb,
        }[self.op]()

    def structure(self):
        return ("bin", self.op, self.a.structure(), self.b.structure())


class _PNot(PExpr):
    def __init__(self, a: PExpr):
        self.a = a

    def dtype(self, schema: Schema) -> DType:
        self.a.dtype(schema)  # validates refs
        return dt.BOOL8

    def refs(self):
        return self.a.refs()

    def lower(self):
        return ~self.a.lower()

    def structure(self):
        return ("not", self.a.structure())


class _PIsNull(PExpr):
    def __init__(self, a: PExpr, want_null: bool):
        self.a, self.want_null = a, want_null

    def dtype(self, schema: Schema) -> DType:
        self.a.dtype(schema)
        return dt.BOOL8

    def refs(self):
        return self.a.refs()

    def lower(self):
        la = self.a.lower()
        return la.is_null() if self.want_null else la.is_not_null()

    def structure(self):
        return ("is_null", self.want_null, self.a.structure())


class _PCast(PExpr):
    def __init__(self, a: PExpr, d: DType):
        self.a, self.d = a, d

    def dtype(self, schema: Schema) -> DType:
        self.a.dtype(schema)
        return self.d

    def refs(self):
        return self.a.refs()

    def lower(self):
        return self.a.lower().cast(self.d)

    def structure(self):
        return ("cast", (int(self.d.id), self.d.scale), self.a.structure())


class _PWhen(PExpr):
    """CASE WHEN cond THEN a ELSE b END; the result dtype follows the
    first branch with a known (non-null-literal) dtype, and both
    branches must agree when both are typed."""

    def __init__(self, cond: PExpr, then: PExpr, other: PExpr):
        self.cond, self.then, self.other = cond, then, other

    def dtype(self, schema: Schema) -> DType:
        self.cond.dtype(schema)
        dthen, dother = self.then.dtype(schema), self.other.dtype(schema)
        t_null = isinstance(self.then, _PLit) and self.then.value is None
        o_null = isinstance(self.other, _PLit) and self.other.value is None
        if t_null and not o_null:
            return dother
        if o_null and not t_null:
            return dthen
        if dthen.id != dother.id or dthen.scale != dother.scale:
            raise PlanError(
                f"CASE branches disagree on dtype: {dthen!r} vs {dother!r}"
            )
        return dthen

    def refs(self):
        return self.cond.refs() | self.then.refs() | self.other.refs()

    def lower(self):
        return rt.when(self.cond.lower(), self.then.lower(), self.other.lower())

    def structure(self):
        return ("when", self.cond.structure(), self.then.structure(),
                self.other.structure())


class _RegexEval(rt.Expression):
    """Runtime bridge: read a STRING column and run the DFA matcher
    (ops/regex). ``full=True`` anchors the whole value (SQL LIKE);
    ``full=False`` is substring search (RLIKE). Reads the column
    directly — STRING lanes (offsets/chars) don't flow through the
    fixed-width expression evaluator."""

    def __init__(self, name: str, pattern: str, full: bool):
        self.name, self.pattern, self.full = name, pattern, full

    def _eval(self, table):
        from ..ops import regex

        c = table.column(self.name)
        if c.dtype.id != TypeId.STRING:
            raise PlanError(f"LIKE/RLIKE needs a STRING input, got {c.dtype!r}")
        fn = regex.matches_re if self.full else regex.contains_re
        r = fn(c, self.pattern)
        return rt._Value(r.data.to(torch.bool), r.validity, None)


def _like_to_regex(pattern: str) -> str:
    """SQL LIKE pattern -> anchored regex: % -> .*, _ -> ., everything
    else literal (regex metacharacters escaped)."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(_re.escape(ch))
    return "".join(out) + "$"


class _PLike(PExpr):
    def __init__(self, a: PExpr, pattern: str, kind: str):
        if kind not in ("like", "rlike"):
            raise PlanError(f"unknown pattern-match kind {kind!r}")
        if not isinstance(a, _PCol):
            raise PlanError("LIKE/RLIKE applies to a column reference")
        self.a, self.pattern, self.kind = a, pattern, kind

    def dtype(self, schema: Schema) -> DType:
        d = self.a.dtype(schema)
        if d.id != TypeId.STRING:
            raise PlanError(f"{self.kind.upper()} needs a STRING column, got {d!r}")
        return dt.BOOL8

    def refs(self):
        return self.a.refs()

    def lower(self):
        if self.kind == "like":
            return _RegexEval(self.a.name, _like_to_regex(self.pattern), True)
        return _RegexEval(self.a.name, self.pattern, False)

    def structure(self):
        return ("like", self.kind, self.pattern, self.a.structure())


class _PartHashEval(rt.Expression):
    """Runtime bridge for ``_PPartHash``: the murmur3-pmod partition map
    over the key columns (``ops/hashing.hash_partition_map``) — the same
    partitioner the physical shuffle uses, so a plan-level partition
    predicate selects *exactly* the rows the executor's
    ``hash_partition`` would route to that partition. On card tables
    the map is B1 (``hopper_kernels.partition_map``) for one int32 or
    int64 key, the plain version on CPU tables."""

    def __init__(self, names: Tuple[str, ...], parts: int):
        self.names, self.parts = names, parts

    def _eval(self, table):
        from ..ops.hashing import hash_partition_map

        ids = hash_partition_map(
            [table.column(n) for n in self.names], self.parts
        )
        return rt._Value(ids, None, None)


class _PPartHash(PExpr):
    """``part_hash(keys, K)`` — the INT32 partition id (murmur3 pmod K)
    of each row's key tuple. The out-of-core rewrite's partition
    predicate is ``ppart(keys, K) == plit(i)``; because every row of a
    group hashes identically, each group lands whole in one branch."""

    def __init__(self, names: Tuple[str, ...], parts: int):
        names = tuple(names)
        if not names:
            raise PlanError("part_hash needs at least one key column")
        if int(parts) < 2:
            raise PlanError(f"part_hash needs >= 2 partitions, got {parts}")
        self.names, self.parts = names, int(parts)

    def dtype(self, schema: Schema) -> DType:
        for n in self.names:
            if n not in schema:
                raise PlanError(
                    f"column {n!r} not in schema {sorted(schema)}"
                )
        return dt.INT32

    def refs(self):
        return frozenset(self.names)

    def lower(self):
        return _PartHashEval(self.names, self.parts)

    def structure(self):
        return ("part_hash", self.names, self.parts)


def _wrap(v) -> PExpr:
    if isinstance(v, PExpr):
        return v
    return _PLit(v)


def pcol(name: str) -> PExpr:
    """Reference a column of the node's input schema."""
    return _PCol(name)


def plit(value, d: Optional[DType] = None) -> PExpr:
    """A literal; ``plit(None, dt.INT32)`` is the typed SQL NULL."""
    return _PLit(value, d)


def pwhen(cond, then, otherwise) -> PExpr:
    """SQL ``CASE WHEN cond THEN then ELSE otherwise END``."""
    return _PWhen(_wrap(cond), _wrap(then), _wrap(otherwise))


def plike(expr: PExpr, pattern: str) -> PExpr:
    """SQL ``LIKE`` (``%``/``_`` wildcards, whole-value anchored)."""
    return _PLike(expr, pattern, "like")


def prlike(expr: PExpr, pattern: str) -> PExpr:
    """Spark ``RLIKE`` — regex substring search."""
    return _PLike(expr, pattern, "rlike")


def ppart(names, parts: int) -> PExpr:
    """Row partition id: murmur3-pmod of the key tuple into ``parts``
    buckets — bit-matches the physical shuffle partitioner."""
    return _PPartHash(tuple(names), parts)


def conjuncts(e: PExpr) -> Tuple[PExpr, ...]:
    """Split a predicate into its top-level AND conjuncts (pushdown
    works conjunct-at-a-time; splitting an AND across a Filter is sound
    under 3VL — a row passes iff every conjunct is TRUE either way)."""
    if isinstance(e, _PBin) and e.op == "and":
        return conjuncts(e.a) + conjuncts(e.b)
    return (e,)


def conjoin(es) -> PExpr:
    """Re-AND a non-empty conjunct list."""
    es = list(es)
    if not es:
        raise PlanError("conjoin needs at least one conjunct")
    out = es[0]
    for e in es[1:]:
        out = out & e
    return out


def substitute(e: PExpr, mapping: Dict[str, str]) -> PExpr:
    """Rebuild ``e`` with column references renamed through ``mapping``
    (pushdown through a renaming Project). Names not in the mapping are
    kept."""
    if isinstance(e, _PCol):
        return _PCol(mapping.get(e.name, e.name))
    if isinstance(e, _PLit):
        return e
    if isinstance(e, _PBin):
        return _PBin(e.op, substitute(e.a, mapping), substitute(e.b, mapping))
    if isinstance(e, _PNot):
        return _PNot(substitute(e.a, mapping))
    if isinstance(e, _PIsNull):
        return _PIsNull(substitute(e.a, mapping), e.want_null)
    if isinstance(e, _PCast):
        return _PCast(substitute(e.a, mapping), e.d)
    if isinstance(e, _PWhen):
        return _PWhen(substitute(e.cond, mapping), substitute(e.then, mapping),
                      substitute(e.other, mapping))
    if isinstance(e, _PLike):
        return _PLike(substitute(e.a, mapping), e.pattern, e.kind)
    if isinstance(e, _PPartHash):
        return _PPartHash(tuple(mapping.get(n, n) for n in e.names), e.parts)
    raise PlanError(f"unknown expression node {type(e).__name__}")


def map_literals(e: PExpr, fn) -> PExpr:
    """Rebuild ``e`` with every literal leaf mapped through ``fn``
    (``_PLit -> PExpr``) — the literal-rebinding walker the plan cache
    uses to bind fresh parameter values into a cached
    optimized plan. Non-literal leaves are kept."""
    if isinstance(e, _PLit):
        return fn(e)
    if isinstance(e, _PCol):
        return e
    if isinstance(e, _PBin):
        return _PBin(e.op, map_literals(e.a, fn), map_literals(e.b, fn))
    if isinstance(e, _PNot):
        return _PNot(map_literals(e.a, fn))
    if isinstance(e, _PIsNull):
        return _PIsNull(map_literals(e.a, fn), e.want_null)
    if isinstance(e, _PCast):
        return _PCast(map_literals(e.a, fn), e.d)
    if isinstance(e, _PWhen):
        return _PWhen(map_literals(e.cond, fn), map_literals(e.then, fn),
                      map_literals(e.other, fn))
    if isinstance(e, _PLike):
        return _PLike(map_literals(e.a, fn), e.pattern, e.kind)
    if isinstance(e, _PPartHash):
        # partition structure is never a cache parameter — K and the key
        # set are part of the plan's shape, not its literals
        return e
    raise PlanError(f"unknown expression node {type(e).__name__}")


def is_col(e: PExpr) -> Optional[str]:
    """The referenced name when ``e`` is a bare column ref, else None."""
    return e.name if isinstance(e, _PCol) else None


def is_null_lit(e: PExpr) -> bool:
    """True when ``e`` is the typed SQL NULL literal (``plit(None, d)``)
    — the compiler materializes those directly at the declared dtype
    (the runtime literal tier always evaluates NULL as INT32 lanes)."""
    return isinstance(e, _PLit) and e.value is None
