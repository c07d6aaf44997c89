"""Expression evaluation over Tables (port of the JAX package's
``ops/expressions.py``, cudf AST / the Spark expression tier).

A small composable AST (column references, literals, arithmetic,
comparisons, boolean logic, null predicates, CASE WHEN, casts) evaluated
column at a time with Spark SQL null semantics: null propagates through
operators, AND/OR follow three-valued logic, and a divide by zero gives
null. Each node is one torch op over [N] tensors, run eagerly: no node
fuses a multiply and an add, so float64 results carry the bits of one
IEEE operation per node, as the reference's do on the CPU.

Example::

    e = col("qty") * col("price")
    pred = (col("qty") > lit(5)) & ~col("returned").is_null()
    revenue = e.evaluate(table)

FLOAT64 columns evaluate as real float64 (the reference's
``backend_has_f64`` branches). Operand types follow the reference's
promotion, where it differs from torch's own: a Python float meeting an
integer column computes in float64, and a literal given as a numpy
scalar (``lit(np.int32(5))``) promotes as a typed array does. UINT16,
UINT32 and UINT64 columns are held in signed torch storage and are not
taken by this tier yet.
"""

from __future__ import annotations

import operator
from typing import Optional

import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from . import bitutils

__all__ = ["col", "lit", "when", "Expression"]

_UNSIGNED_WIDE = (TypeId.UINT16, TypeId.UINT32, TypeId.UINT64)


class _Value:
    """Evaluated expression: floating data carried as arithmetic values
    (``float_view``), re-stored as bits only at column materialization.
    ``data`` is a tensor or a host Python scalar (a literal)."""

    __slots__ = ("data", "valid", "dtype")

    def __init__(self, data, valid, dtype: Optional[DType]):
        self.data = data
        self.valid = valid  # None == all valid
        self.dtype = dtype


def _to_value(col_: Column) -> _Value:
    d = col_.dtype
    if d.id in _UNSIGNED_WIDE:
        raise NotImplementedError(
            f"{d!r} columns in expressions are not ported yet (ROADMAP.md, Open items, "
            "section 1, item 5)")
    if d.id == TypeId.FLOAT64:
        return _Value(bitutils.float_view(col_.data, d), col_.validity, d)
    if d.id == TypeId.BOOL8:
        return _Value(col_.data.to(torch.bool), col_.validity, d)
    return _Value(col_.data, col_.validity, d)


def _is_scalar(x) -> bool:
    return isinstance(x, (bool, int, float))


def _scalar_tensor(x, device) -> torch.Tensor:
    """A host scalar as the reference's jnp.asarray makes it (x64 on)."""
    t = torch.bool if isinstance(x, bool) else torch.int64 if isinstance(x, int) else torch.float64
    return torch.tensor(x, dtype=t, device=device)


def _tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return _scalar_tensor(x, None if like is None else like.device)


def _promote(a, b):
    """Both operands of a binary node, typed as the reference's promotion
    types them: two tensors (0-d literals included) meet at
    ``promote_types``; a Python float meeting an integer or bool tensor
    makes it float64; other host scalars take the tensor's type, as
    torch and the reference agree."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        t = torch.promote_types(a.dtype, b.dtype)
        return a.to(t), b.to(t)
    if isinstance(a, float) and isinstance(b, torch.Tensor) and not b.is_floating_point():
        return a, b.to(torch.float64)
    if isinstance(b, float) and isinstance(a, torch.Tensor) and not a.is_floating_point():
        return a.to(torch.float64), b
    return a, b


def _both_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _infer(t: torch.dtype) -> DType:
    return {
        torch.int8: dt.INT8, torch.int16: dt.INT16, torch.int32: dt.INT32, torch.int64: dt.INT64,
        torch.uint8: dt.UINT8, torch.float32: dt.FLOAT32, torch.float64: dt.FLOAT64,
        torch.bool: dt.BOOL8,
    }[t]


class Expression:
    def evaluate(self, table: Table) -> Column:
        v = self._eval(table)
        data = v.data
        if _is_scalar(data):  # a bare literal
            data = _scalar_tensor(data, _device(table))
        if data.dtype == torch.bool:
            return Column(dt.BOOL8, data=data.to(torch.uint8), validity=v.valid)
        if data.is_floating_point() and (v.dtype is None or v.dtype.id == TypeId.FLOAT64):
            return Column(dt.FLOAT64, data=bitutils.float_store(data, dt.FLOAT64), validity=v.valid)
        out_d = v.dtype if v.dtype is not None else _infer(data.dtype)
        if out_d.id == TypeId.FLOAT32:
            # the reference keeps a float64 buffer under a FLOAT32 type
            # here (a FLOAT32 operand meeting a FLOAT64 one, or a cast);
            # the port stores the type's own width
            data = data.to(torch.float32)
        return Column(out_d, data=data, validity=v.valid)

    def _eval(self, table: Table) -> _Value:
        raise NotImplementedError

    # -- operator sugar -----------------------------------------------------
    def _bin(self, other, fn, bool_out=False):
        return _BinOp(self, _wrap(other), fn, bool_out)

    def __add__(self, o):
        return self._bin(o, operator.add)

    def __sub__(self, o):
        return self._bin(o, operator.sub)

    def __mul__(self, o):
        return self._bin(o, operator.mul)

    def __truediv__(self, o):
        return _Div(self, _wrap(o))

    def __mod__(self, o):
        return self._bin(o, operator.mod)

    def __eq__(self, o):  # noqa: A003
        return self._bin(o, operator.eq, bool_out=True)

    def __ne__(self, o):
        return self._bin(o, operator.ne, bool_out=True)

    def __lt__(self, o):
        return self._bin(o, operator.lt, bool_out=True)

    def __le__(self, o):
        return self._bin(o, operator.le, bool_out=True)

    def __gt__(self, o):
        return self._bin(o, operator.gt, bool_out=True)

    def __ge__(self, o):
        return self._bin(o, operator.ge, bool_out=True)

    def __and__(self, o):
        return _And(self, _wrap(o))

    def __or__(self, o):
        return _Or(self, _wrap(o))

    def __invert__(self):
        return _Not(self)

    def is_null(self):
        return _IsNull(self, True)

    def is_not_null(self):
        return _IsNull(self, False)

    def cast(self, d: DType):
        return _Cast(self, d)

    __hash__ = None


def _device(table: Table):
    return table.columns[0].device if table.columns else None


class _ColumnRef(Expression):
    def __init__(self, name: str):
        self.name = name

    def _eval(self, table: Table) -> _Value:
        return _to_value(table.column(self.name))


class _Literal(Expression):
    def __init__(self, value):
        self.value = value

    def _eval(self, table: Table) -> _Value:
        dev = _device(table)
        if self.value is None:
            n = table.num_rows
            return _Value(torch.zeros((n,), dtype=torch.int32, device=dev),
                          torch.zeros((n,), dtype=torch.bool, device=dev), None)
        if isinstance(self.value, (int, float)) and not isinstance(self.value, bool):
            # a host scalar: it takes its peer's type, as in the reference
            return _Value(self.value, None, None)
        return _Value(torch.as_tensor(self.value, device=dev), None, None)


class _BinOp(Expression):
    def __init__(self, a, b, fn, bool_out):
        self.a, self.b, self.fn, self.bool_out = a, b, fn, bool_out

    def _eval(self, table):
        va, vb = self.a._eval(table), self.b._eval(table)
        data = self.fn(*_promote(va.data, vb.data))
        d = None if self.bool_out else (va.dtype if va.dtype is not None else vb.dtype)
        if d is not None and not d.is_fixed_width:
            d = None
        # the arithmetic output keeps the input's type only where the
        # storage type did not change
        if d is not None and not self.bool_out and isinstance(data, torch.Tensor):
            if data.dtype != d.torch_dtype and not d.is_floating:
                d = None
        return _Value(data, _both_valid(va.valid, vb.valid), d)


class _Div(Expression):
    """SQL divide: always floating point, null on divide-by-zero."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def _eval(self, table):
        va, vb = self.a._eval(table), self.b._eval(table)
        den = _tensor(vb.data, va.data if isinstance(va.data, torch.Tensor) else None)
        zero = den == 0
        # the denominator is a typed float64 array in the reference, so a
        # float32 numerator divides in float64
        data = operator.truediv(*_promote(va.data, torch.where(zero, 1.0, den.to(torch.float64))))
        valid = _both_valid(_both_valid(va.valid, vb.valid), ~zero)
        return _Value(data, valid, dt.FLOAT64)


def _bool_and_valid(v: _Value):
    a = _tensor(v.data).to(torch.bool)
    return a, torch.ones_like(a) if v.valid is None else v.valid


class _And(Expression):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def _eval(self, table):
        va, vb = self.a._eval(table), self.b._eval(table)
        a, av = _bool_and_valid(va)
        b, bv = _bool_and_valid(vb)
        valid = (av & bv) | (av & ~a) | (bv & ~b)  # 3VL: false dominates null
        return _Value(a & b, valid, None)


class _Or(Expression):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def _eval(self, table):
        va, vb = self.a._eval(table), self.b._eval(table)
        a, av = _bool_and_valid(va)
        b, bv = _bool_and_valid(vb)
        valid = (av & bv) | (av & a) | (bv & b)  # 3VL: true dominates null
        return _Value(a | b, valid, None)


class _Not(Expression):
    def __init__(self, a):
        self.a = a

    def _eval(self, table):
        v = self.a._eval(table)
        return _Value(~_tensor(v.data).to(torch.bool), v.valid, None)


class _IsNull(Expression):
    def __init__(self, a, want_null):
        self.a, self.want_null = a, want_null

    def _eval(self, table):
        v = self.a._eval(table)
        if v.valid is None:
            shape = _tensor(v.data).shape[:1]
            fill = torch.zeros if self.want_null else torch.ones
            res = fill(shape, dtype=torch.bool, device=_device(table))
        else:
            res = ~v.valid if self.want_null else v.valid
        return _Value(res, None, None)


class _When(Expression):
    """SQL CASE WHEN cond THEN a ELSE b END. A NULL condition selects the
    ELSE branch; the result's validity follows the branch chosen per row.
    Both branches evaluate for every row before the select (no per-row
    lazy branch), as in the reference."""

    def __init__(self, cond, then, other):
        self.cond, self.then, self.other = cond, then, other

    def _eval(self, table):
        vc = self.cond._eval(table)
        c = _tensor(vc.data).to(torch.bool)
        if vc.valid is not None:
            c = c & vc.valid
        vt, vo = self.then._eval(table), self.other._eval(table)
        t_, o_ = vt.data, vo.data
        if _is_scalar(t_) and _is_scalar(o_):
            t_, o_ = _tensor(t_, c), _tensor(o_, c)
        data = torch.where(c, *_promote(t_, o_))
        if vt.valid is None and vo.valid is None:
            valid = None
        else:
            tvb = torch.ones_like(c) if vt.valid is None else vt.valid
            ovb = torch.ones_like(c) if vo.valid is None else vo.valid
            valid = torch.where(c, tvb, ovb)
        d = vt.dtype if vt.dtype is not None else vo.dtype
        return _Value(data, valid, d)


class _Cast(Expression):
    def __init__(self, a, d: DType):
        self.a, self.d = a, d

    def _eval(self, table):
        v = self.a._eval(table)
        data = _tensor(v.data)
        if self.d.id in _UNSIGNED_WIDE:
            raise NotImplementedError(f"casts to {self.d!r} are not ported yet "
                                      "(ROADMAP.md, Open items, section 1, item 5)")
        if self.d.is_floating:
            return _Value(data.to(torch.float64), v.valid, self.d)
        return _Value(data.to(self.d.torch_dtype), v.valid, self.d)


def _wrap(v) -> Expression:
    return v if isinstance(v, Expression) else _Literal(v)


def col(name: str) -> Expression:
    return _ColumnRef(name)


def lit(value) -> Expression:
    return _Literal(value)


def when(cond, then, otherwise) -> Expression:
    """SQL ``CASE WHEN cond THEN then ELSE otherwise END``; ``then`` and
    ``otherwise`` may be expressions or literals, and chained arms nest:
    ``when(c1, a, when(c2, b, c))``."""
    return _When(_wrap(cond), _wrap(then), _wrap(otherwise))
