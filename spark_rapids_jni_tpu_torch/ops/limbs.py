"""Vectorized multi-precision unsigned integers in 32-bit limbs (port of
the JAX package's ``ops/limbs.py``).

A number is a ``[..., K]`` int64 tensor of little-endian limbs, each lane
holding a u32 value in [0, 2^32): K = 4 for 128-bit magnitudes, K = 8 for
256-bit products. Holding a u32 in an int64 lane keeps the carries and
borrows of one limb inside the lane, so most operations are plain torch
arithmetic; the places where an int64 lane would overflow are named
where they are handled (``mul`` splits one factor into 16-bit halves).
Columns store the limbs as int32 (``uword.u32_to_i64`` /
``uword.to_signed_bits`` at the column boundary).

The hot loop of the decimal ops is ``divmod_bits``: 32*K steps, each a
handful of whole-tensor torch operations over ``[N, K]`` (a shift, one
lexicographic compare that also yields the subtraction's borrows, a
select), so a step costs the same number of launches at any K.

Magnitude + sign is the representation of the decimal ops; two's
complement conversion happens only at column storage.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = [
    "from_ints",
    "constant",
    "to_ints",
    "add",
    "add_small",
    "sub",
    "negate",
    "mul10_add",
    "mul_small",
    "mul",
    "gt",
    "ge",
    "eq",
    "is_zero",
    "count_digits",
    "precision10",
    "is_all_nines",
    "POW10_LIMBS",
    "NINES_LIMBS",
    "pow10",
    "shift_left_bits",
    "shift_left_one",
    "divmod_bits",
    "to_twos_complement",
    "from_twos_complement",
]

MASK = 0xFFFFFFFF


def from_ints(values, K: int) -> np.ndarray:
    """Host: non-negative python ints -> [N, K] int64 limbs (u32 values)."""
    out = np.zeros((len(values), K), dtype=np.int64)
    for i, v in enumerate(values):
        v = int(v)
        for k in range(K):
            out[i, k] = (v >> (32 * k)) & MASK
    return out


def to_ints(limbs) -> list:
    """Host: [N, K] limbs (a tensor or an array of u32 values, any integer
    type holding them) -> non-negative python ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    limbs = np.asarray(limbs).astype(np.int64) & MASK
    out = []
    for row in limbs:
        v = 0
        for k, limb in enumerate(row):
            v |= int(limb) << (32 * k)
        out.append(v)
    return out


def _const(name, rows: np.ndarray, device) -> torch.Tensor:
    """The host int64 table ``rows`` on ``device``, built once per name
    and device."""
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(rows).to(device)
    return t


_CONSTS: Dict[tuple, torch.Tensor] = {}


def constant(value: int, K: int, device) -> torch.Tensor:
    """The [K] limbs of a non-negative host int on ``device``, built once
    per value, K and device."""
    return _const(("int", value, K), from_ints([value], K)[0], device)


def _ripple(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry-propagate limbs ``t`` (each in (-2^62, 2^62)) into u32 limbs:
    (limbs, carry out). A negative limb borrows: its ``& MASK`` is the
    limb mod 2^32 and the arithmetic ``>> 32`` is -1, so the carry out
    of a subtraction is -1 where it borrowed."""
    out = []
    carry = torch.zeros_like(t[..., 0])
    for k in range(t.shape[-1]):
        v = t[..., k] + carry
        out.append(v & MASK)
        carry = v >> 32
    return torch.stack(out, dim=-1), carry


def add(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a + b -> (sum limbs, carry-out). Shapes [..., K]."""
    return _ripple(a + b)


def add_small(a: torch.Tensor, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """a + x (x: an int or a [...] tensor of values fitting u32)."""
    t = a.clone()
    t[..., 0] += x
    return _ripple(t)


def sub(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a - b -> (diff limbs mod 2^(32K), borrow-out: 1 when b > a). Each
    limb's ``a - b - borrow`` lies in [-2^32, 2^32), so its borrow is its
    sign."""
    d, carry = _ripple(a - b)
    return d, -carry


def negate(a: torch.Tensor) -> torch.Tensor:
    """Two's complement negation mod 2^(32K)."""
    return add_small(MASK - a, 1)[0]


def mul10_add(a: torch.Tensor, d) -> torch.Tensor:
    """a * 10 + d (d: [...] small non-negative), mod 2^(32K)."""
    return add_small(a * 10, d)[0]


def _mul_words(a: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low and high u32 words of the 64-bit products a * b of u32 values
    in int64 lanes. The product reaches 2^64 and would overflow the signed
    lane, so ``b`` is split into 16-bit halves: a * b_lo and a * b_hi stay
    below 2^48, and the high half's own top 16 bits go straight to the
    high word."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return t & MASK, (t >> 32) + (p_hi >> 16)


def mul_small(a: torch.Tensor, m) -> Tuple[torch.Tensor, torch.Tensor]:
    """a * m (m: an int or a [...] tensor fitting u32) -> (product limbs,
    carry-out)."""
    if isinstance(m, torch.Tensor):
        m = m[..., None]
    lo, hi = _mul_words(a, m)
    t = lo.clone()
    t[..., 1:] += hi[..., :-1]
    out, carry = _ripple(t)
    return out, carry + hi[..., -1]


def mul(a: torch.Tensor, b: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Schoolbook a * b mod 2^(32 * out_limbs) -> [..., out_limbs] (the
    reference's chunked256::multiply in 32-bit limbs). Each column sum of
    product words stays below 2^37."""
    Ka, Kb = a.shape[-1], b.shape[-1]
    lo, hi = _mul_words(a[..., :, None], b[..., None, :])  # [..., Ka, Kb]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc = torch.zeros((*shape, out_limbs + 1), dtype=torch.int64, device=a.device)
    for i in range(min(Ka, out_limbs)):
        w = min(Kb, out_limbs - i)
        acc[..., i:i + w] += lo[..., i, :w]
        acc[..., i + 1:i + 1 + w] += hi[..., i, :w]
    return _ripple(acc[..., :out_limbs])[0]


def _sign_weights(K: int, device) -> torch.Tensor:
    """[K, K + 1] float32: column k < K weighs limb j by 2^j where j < k
    (the weighted signs below limb k), column K weighs every limb (the
    total). A product of K <= 8 limb signs with it is exact in float32
    (and in any reduced matmul precision): every term is 0 or +-2^j, and
    every sum lies within +-255."""
    rows = np.zeros((K, K + 1), dtype=np.float32)
    for j in range(K):
        rows[j, j + 1:] = 2.0**j
    return _const(("sign_weights", K), rows, device)


def _signs(d: torch.Tensor) -> torch.Tensor:
    """The weighted signs of limb differences ``d`` [..., K] -> [..., K + 1]
    float32: for each limb the signed weight of the limbs below it, then
    the total. One small matmul: a cumulative sum over the K limbs of a
    million rows is an innermost-dimension scan that costs the card
    ~6.4 ms (PERF.md section 6), the matmul a few dozen microseconds."""
    return torch.sign(d).to(torch.float32) @ _sign_weights(d.shape[-1], d.device)


def _cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sign of a - b as numbers (> 0, 0, < 0): the signs of the limb
    differences weighted 2^k, so the highest limb that differs decides."""
    return _signs(a - b)[..., -1]


def gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cmp(a, b) > 0


def ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cmp(a, b) >= 0


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


# 10^k and (10^k - 1) tables: 10^38 < 2^127 (K=4); 10^76 < 2^253 (K=8,
# as the reference's device pow_ten table, decimal_utils.cu:235-498).
_MAX_POW = {4: 38, 8: 76}


def _table(K: int, minus_one: bool) -> np.ndarray:
    return from_ints([10**k - (1 if minus_one else 0) for k in range(_MAX_POW[K] + 1)], K)


POW10_LIMBS = {4: _table(4, False), 8: _table(8, False)}
NINES_LIMBS = {4: _table(4, True), 8: _table(8, True)}


def pow10(k: torch.Tensor, K: int) -> torch.Tensor:
    """10^k as limbs; k (an integer tensor) clipped to [0, 38] (K=4) /
    [0, 76] (K=8)."""
    return _const(("pow10", K), POW10_LIMBS[K], k.device)[k.clamp(0, _MAX_POW[K])]


def _count_table(a: torch.Tensor, strict: bool) -> torch.Tensor:
    """#{k : 10^k < a} (``strict``) or #{k : 10^k <= a}: a binary search
    of the increasing table, 6 or 7 whole-tensor compares instead of one
    per power."""
    K = a.shape[-1]
    tbl = _const(("pow10", K), POW10_LIMBS[K], a.device)
    n = tbl.shape[0]
    pos = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    step = 1 << (n.bit_length() - 1)
    while step:
        cand = pos + step
        c = _cmp(a, tbl[(cand - 1).clamp(max=n - 1)])
        ok = (cand <= n) & ((c > 0) if strict else (c >= 0))
        pos = torch.where(ok, cand, pos)
        step >>= 1
    return pos


def count_digits(a: torch.Tensor) -> torch.Tensor:
    """Number of decimal digits (0 for value 0): #{k : a >= 10^k}."""
    return _count_table(a, strict=False)


def precision10(a: torch.Tensor) -> torch.Tensor:
    """Smallest i with 10^i >= a (the reference's precision10,
    decimal_utils.cu:505-521: an exact power of ten gives i, one LESS than
    its digit count; the SPARK-40129 compatibility depends on it). Equals
    #{i : 10^i < a}."""
    return _count_table(a, strict=True)


def is_all_nines(a: torch.Tensor) -> torch.Tensor:
    """True when a == 10^k - 1 for some k in [1, 38] (rounding carried
    through every digit, cast_string.cu:479-498): such an a has exactly k
    digits, so one compare against the row of its digit count decides."""
    K = a.shape[-1]
    c = count_digits(a)
    nines = _const(("nines", K), NINES_LIMBS[K], a.device)[c.clamp(0, _MAX_POW[K])]
    return (c >= 1) & (c <= 38) & eq(a, nines)


def shift_left_bits(a: torch.Tensor, n) -> torch.Tensor:
    """a << n mod 2^(32K) for per-element n in [0, 32*K). Output limb k
    takes source limb k - n // 32 shifted left by n % 32 and the spill of
    the limb below it; ``a << bit`` with a < 2^32 and bit <= 31 stays
    below 2^63."""
    K = a.shape[-1]
    n = torch.as_tensor(n, dtype=torch.int64, device=a.device)
    shape = torch.broadcast_shapes(a.shape[:-1], n.shape)
    a = a.expand(*shape, K)
    n = n.expand(shape)[..., None]
    bit = n % 32
    src = torch.arange(K, device=a.device) - n // 32
    lo = torch.where(src >= 0, torch.gather(a, -1, src.clamp(0, K - 1)) << bit, 0)
    hi = torch.where(src >= 1, torch.gather(a, -1, (src - 1).clamp(0, K - 1)) >> (32 - bit), 0)
    return (lo + hi) & MASK


def shift_left_one(a: torch.Tensor) -> torch.Tensor:
    """a << 1 mod 2^(32K): one shift of every limb and the top bits moved
    up one limb."""
    out = (a << 1) & MASK
    out[..., 1:] |= a[..., :-1] >> 31
    return out


def divmod_bits(num: torch.Tensor, den: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned long division num / den -> (quotient, remainder).

    Bit-serial restoring division over 32*K bits, as the JAX package's
    (its ``lax.scan``; the reference's long division,
    decimal_utils.cu:148-167), each step over whole [..., K] tensors: the
    remainder shifts left taking the next numerator bit (the bit shifted
    out of the top limb is dropped, as there), then one pass of limb
    differences gives both whether it fits (the weighted signs' total)
    and, where it does, the subtraction's borrows (the weighted signs
    below each limb). den == 0 yields quotient 0 and remainder num (the
    caller flags the division by zero): such a row's top divisor limb is
    set to 2^32, which no remainder limb reaches."""
    K = num.shape[-1]
    num, den = torch.broadcast_tensors(num, den)
    den = den.clone()
    den[..., -1] = torch.where(is_zero(den), MASK + 1, den[..., -1])
    span = torch.arange(32, device=num.device)
    qbits = torch.empty((*num.shape[:-1], 32 * K), dtype=torch.bool, device=num.device)
    r = torch.zeros_like(num)
    for i in range(32 * K - 1, -1, -1):
        if i % 32 == 31:  # the next limb's bits, one [..., 32] tensor a limb
            bits = (num[..., i // 32, None] >> span) & 1
        r = shift_left_one(r)
        r[..., 0] |= bits[..., i % 32]
        d = r - den
        signs = _signs(d)
        fits = signs[..., -1] >= 0
        r = torch.where(fits[..., None], (d - (signs[..., :-1] < 0).to(torch.int64)) & MASK, r)
        qbits[..., i] = fits
    q = (qbits.view(*num.shape, 32).to(torch.int64) << span).sum(-1)
    return q, r


def to_twos_complement(mag: torch.Tensor, negative: torch.Tensor) -> torch.Tensor:
    """(magnitude, sign) -> two's complement limbs."""
    return torch.where(negative[..., None], negate(mag), mag)


def from_twos_complement(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two's complement limbs -> (magnitude, negative)."""
    neg = (a[..., -1] >> 31) == 1
    return torch.where(neg[..., None], negate(a), a), neg
