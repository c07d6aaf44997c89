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
scalar (``lit(np.int32(5))``) promotes as a typed array does.

UINT16, UINT32 and UINT64 values (columns, numpy literals, casts) are
carried as ``_U``: their unsigned value (the u64's bits) in an int64
lane. Any operation that meets one takes the reference's promotion
lattice (jnp's, not torch's: u32 with an int literal stays u32 and
wraps, u32 with i32 gives int64, u64 with i64 gives float64); unsigned
results wrap at their width, and UINT64 compares and ``%`` are the
unsigned ones.
"""

from __future__ import annotations

import functools
import operator
from typing import Optional

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import DType, TypeId
from . import bitutils
from .uword import SIGN64, shr_u64, to_signed_bits, u64_bits, ucmp64

__all__ = ["col", "lit", "when", "Expression"]

_UNSIGNED_WIDE = {TypeId.UINT16: 16, TypeId.UINT32: 32, TypeId.UINT64: 64}
_U_BITS = {"u16": 16, "u32": 32, "u64": 64}  # the kinds carried as _U


class _U:
    """A UINT16/UINT32/UINT64 value: ``t`` is an int64 tensor holding the
    unsigned value (for UINT64, its bits), ``bits`` the width."""

    __slots__ = ("t", "bits")

    def __init__(self, t: torch.Tensor, bits: int):
        self.t, self.bits = t, bits

    @property
    def kind(self) -> str:
        return f"u{self.bits}"


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
        bits = _UNSIGNED_WIDE[d.id]
        t = col_.data if bits == 64 else (col_.data.to(torch.int64) & ((1 << bits) - 1))
        return _Value(_U(t, bits), col_.validity, d)
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
    if isinstance(x, _U):
        return x.t
    return _scalar_tensor(x, None if like is None else like.device)


# The reference's promotion lattice (jax.numpy's type promotion, x64 on)
# over the kinds this tier meets: each kind's direct successors. A Python
# int is the weak "i*", a Python float the weak "f*".
_LATTICE = {"bool": ("i*",), "i*": ("u8", "i8"), "u8": ("u16", "i16"), "u16": ("u32", "i32"),
            "u32": ("u64", "i64"), "u64": ("f*",), "i8": ("i16",), "i16": ("i32",),
            "i32": ("i64",), "i64": ("f*",), "f*": ("f32",), "f32": ("f64",), "f64": ()}
_KIND_OF_TORCH = {torch.bool: "bool", torch.uint8: "u8", torch.int8: "i8", torch.int16: "i16",
                  torch.int32: "i32", torch.int64: "i64", torch.float32: "f32",
                  torch.float64: "f64"}
_TORCH_OF_KIND = {v: k for k, v in _KIND_OF_TORCH.items()}
_TORCH_OF_KIND.update({"i*": torch.int64, "f*": torch.float64})


def _above(kind: str) -> set:
    out, todo = set(), [kind]
    while todo:
        k = todo.pop()
        if k not in out:
            out.add(k)
            todo.extend(_LATTICE[k])
    return out


@functools.lru_cache(maxsize=None)
def _join(a: str, b: str) -> str:
    """The least upper bound of two kinds in the lattice."""
    common = _above(a) & _above(b)
    return next(k for k in common if common <= _above(k))


def _kind(x) -> str:
    if isinstance(x, _U):
        return x.kind
    if isinstance(x, torch.Tensor):
        return _KIND_OF_TORCH[x.dtype]
    return "bool" if isinstance(x, bool) else "i*" if isinstance(x, int) else "f*"


def _u_to_float(u: _U, t: torch.dtype) -> torch.Tensor:
    """An unsigned value as float, rounded once: a UINT64 at or above 2^63
    converts its halved bits (the dropped bit kept as a sticky bit) and
    doubles."""
    if u.bits < 64:
        return u.t.to(t)
    half = shr_u64(u.t, 1) | (u.t & 1)
    return torch.where(u.t >= 0, u.t.to(t), half.to(t) * 2)


def _as_kind(x, kind: str):
    """An operand converted to the representation of ``kind``: an int64
    tensor (or int) holding the unsigned value for u16/u32/u64, a torch
    tensor of the kind otherwise. A Python scalar meeting an unsigned
    kind takes its value mod 2^bits, as the reference converts it."""
    bits = _U_BITS.get(kind)
    if bits is not None:
        if isinstance(x, _U):
            return x.t
        if isinstance(x, (bool, int)):
            return u64_bits(int(x) % 2**bits)
        return x.to(torch.int64) & (2**bits - 1) if bits < 64 else x.to(torch.int64)
    t = _TORCH_OF_KIND[kind]
    if isinstance(x, _U):
        return _u_to_float(x, t) if t.is_floating_point else x.t.to(t)
    return x.to(t) if isinstance(x, torch.Tensor) else x


def _unify(a, b):
    """Both operands of a binary node, converted to their joined kind in
    the reference's lattice: (a, b, kind). A host scalar meeting a tensor
    of its kind or above stays a host scalar."""
    k = _join(_kind(a), _kind(b))
    if k in ("i*", "f*"):
        k = "i64" if k == "i*" else "f64"
    return _as_kind(a, k), _as_kind(b, k), k


def _wrap_u(x, kind: str):
    """An int64 result of ``kind``: wrapped to its width as a ``_U``."""
    bits = _U_BITS.get(kind)
    if bits is None:
        return x
    return _U(x if bits == 64 else x & (2**bits - 1), bits)


_COMPARES = (operator.eq, operator.ne, operator.lt, operator.le, operator.gt, operator.ge)


def _unsigned_op(fn, a, b, kind: str):
    """``fn`` on two operands of an unsigned kind (int64 lanes): UINT64
    compares with the sign bit flipped on both sides, ``%`` is the
    unsigned remainder (0 for a zero divisor, as the reference's), and
    arithmetic wraps at the kind's width."""
    bits = _U_BITS[kind]
    if fn in _COMPARES:
        return ucmp64(fn, a, b) if bits == 64 else fn(a, b)
    if fn is operator.mod:
        dev = (a if isinstance(a, torch.Tensor) else b).device
        a, b = torch.broadcast_tensors(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev))
        zero = b == 0
        if bits < 64:
            return _wrap_u(torch.where(zero, 0, a % torch.where(zero, 1, b)), kind)
        return _wrap_u(torch.where(zero, 0, _urem64(a, b)), kind)
    return _wrap_u(fn(a, b), kind)


def _urem64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a % b of u64 bits in int64 lanes (b != 0): a divisor at or
    above 2^63 goes into a at most once; below, the quotient of a / 2
    doubled is short of a / b by at most one b."""
    big = b < 0
    d = torch.where(big | (b == 0), 1, b)
    q = (shr_u64(a, 1) // d) << 1
    r = a - q * d
    r = torch.where(ucmp64(operator.ge, r, d), r - d, r)
    return torch.where(big, torch.where(ucmp64(operator.ge, a, b), a - b, a), r)


def _both_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _infer(t) -> DType:
    if isinstance(t, _U):
        return {16: dt.UINT16, 32: dt.UINT32, 64: dt.UINT64}[t.bits]
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
        if isinstance(data, _U):
            out_d = v.dtype if v.dtype is not None else _infer(data)
            stored = data.t if data.bits == 64 else to_signed_bits(data.t, data.bits)
            return Column(out_d, data=stored, validity=v.valid)
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
        bits = _NP_UNSIGNED.get(getattr(self.value, "dtype", None))
        if bits is not None:  # a numpy UINT16/32/64 scalar: a typed unsigned value
            v = int(self.value)
            return _Value(_U(torch.tensor(u64_bits(v), device=dev), bits),
                          None, None)
        return _Value(torch.as_tensor(self.value, device=dev), None, None)


_NP_UNSIGNED = {np.dtype(np.uint16): 16, np.dtype(np.uint32): 32, np.dtype(np.uint64): 64}


class _BinOp(Expression):
    def __init__(self, a, b, fn, bool_out):
        self.a, self.b, self.fn, self.bool_out = a, b, fn, bool_out

    def _eval(self, table):
        va, vb = self.a._eval(table), self.b._eval(table)
        a, b, kind = _unify(va.data, vb.data)
        data = _unsigned_op(self.fn, a, b, kind) if kind in _U_BITS else self.fn(a, b)
        d = None if self.bool_out else (va.dtype if va.dtype is not None else vb.dtype)
        if d is not None and not d.is_fixed_width:
            d = None
        # the arithmetic output keeps the input's type only where the
        # storage type did not change
        if d is not None and not self.bool_out and isinstance(data, _U):
            if _UNSIGNED_WIDE.get(d.id) != data.bits:
                d = None
        elif d is not None and not self.bool_out and isinstance(data, torch.Tensor):
            if (data.dtype != d.torch_dtype or d.id in _UNSIGNED_WIDE) and not d.is_floating:
                d = None
        return _Value(data, _both_valid(va.valid, vb.valid), d)


class _Div(Expression):
    """SQL divide: always floating point, null on divide-by-zero."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def _eval(self, table):
        va, vb = self.a._eval(table), self.b._eval(table)
        num, den = va.data, vb.data
        if _is_scalar(den):
            den = _scalar_tensor(den, None if _is_scalar(num) else _tensor(num).device)
        # the denominator is a typed float64 array in the reference, so a
        # float32 numerator divides in float64
        den = _as_kind(den, "f64")
        zero = den == 0
        num, den, _ = _unify(num, torch.where(zero, 1.0, den))
        data = num / den
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
        a, b, kind = _unify(t_, o_)
        data = _wrap_u(torch.where(c, a, b), kind)
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
        if self.d.id in _UNSIGNED_WIDE:
            return _Value(_to_unsigned(v.data, _UNSIGNED_WIDE[self.d.id], _device(table)),
                          v.valid, self.d)
        if isinstance(v.data, _U):
            return _Value(_from_unsigned(v.data, self.d), v.valid, self.d)
        data = _tensor(v.data)
        if self.d.is_floating:
            return _Value(data.to(torch.float64), v.valid, self.d)
        return _Value(data.to(self.d.torch_dtype), v.valid, self.d)


def _to_unsigned(x, bits: int, device) -> _U:
    """A value cast to an unsigned width as the reference converts: an
    integer keeps its low bits; a float truncates toward zero and
    saturates to [0, 2^bits - 1], NaN giving 0."""
    if isinstance(x, _U):
        return _U(x.t if bits == 64 else x.t & (2**bits - 1), bits)
    x = _tensor(x, torch.empty(0, device=device))
    if not x.is_floating_point():
        return _wrap_u(x.to(torch.int64), f"u{bits}")
    f = torch.nan_to_num(x.to(torch.float64), nan=0.0).clamp(min=0.0)
    if bits < 64:
        return _U(f.clamp(max=2.0**bits - 1).to(torch.int64), bits)
    # at or above 2^63, the value less 2^63 with the top bit set; the clamp
    # keeps the conversion in range where 2^64 saturates below
    high = f >= 2.0**63
    low = torch.where(high, f - 2.0**63, f).clamp(max=2.0**63 - 1024).to(torch.int64)
    return _U(torch.where(f >= 2.0**64, -1, torch.where(high, low ^ SIGN64, low)), bits)


def _from_unsigned(u: _U, d: DType) -> torch.Tensor:
    """An unsigned value cast to another type: float64 for the float types
    (the reference's float view), else the target's low bits."""
    if d.is_floating:
        return _u_to_float(u, torch.float64)
    if d.torch_dtype == torch.uint8:
        return (u.t & 0xFF).to(torch.uint8)
    width = 8 * d.size_bytes
    return u.t if width == 64 else to_signed_bits(u.t, width)


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
