"""Exact float64 accumulation over IEEE bits in int64 lanes (port of the
JAX package's ``ops/f64acc.py``, its exact half).

Spark's ``sum(double)`` and ``avg(double)`` on the accelerator must not
depend on the order of the adds. ``segment_sum_f64bits`` returns the
float64 nearest-even rounding of the exact real sum of each segment:
every value (IEEE bits, ``columnar/dtype.py``) is split into sign,
exponent and 53-bit mantissa with integer ops, aligned to its segment's
largest exponent inside a 224-bit fixed-point window (7 limbs of 32
bits, each held in an int64 lane), summed limb by limb in int64 (exact:
a limb partial stays below 2^63 for up to 2^31 rows), carry-propagated
and rounded once. Integer sums do not depend on the order of the adds,
so the bits equal the reference's on every input and on every device.
Values more than ~108 bits below their segment's largest fall off the
window: an error below 2^-107 of the largest addend, under one ulp of
any result.

``segment_mean_f64bits`` divides the exact 224-bit sum by the count
(long division, the remainder folded into the sticky bit) and rounds
once, so the mean is the nearest-even float64 of (exact sum / count).
``i64_to_f64bits``, ``u64_to_f64bits``, ``mean_i64_div`` and
``div_f64bits_by_int`` give the same exactness to integer aggregates.

IEEE edges as in the reference: +/-inf and NaN propagate through
per-segment flags (inf + -inf is NaN, bits 0x7FF8000000000000);
subnormal inputs and results are exact; a segment whose every addend is
-0.0 returns +0.0.

What differs from the reference, and why the bits do not:

- The reference's hot path (``_accumulate_mxu``) is a signed one-hot
  int8 matrix product, a TPU device for summing limbs on the matrix
  unit. It returns what the payload formulation returns (integer sums);
  the port keeps the payload formulation only: one [N, 10] int64
  payload summed per segment, by masked reductions for at most
  ``SMALL_SEGMENTS`` segments and by ``index_add_`` above.
- The reference's long division (``_limb_divide``) shifts in one bit
  per step of a 224-step scan. The port divides in base 2^32, seven
  steps of ``r = (r << 32) | limb; q = r // c; r = r % c``: the same
  quotient and the same remainder. ``r < c < 2^31`` keeps every
  intermediate below 2^63.
- The double-f32 ("dd") arithmetic of the reference exists for backends
  without float64; the port computes real float64 and does not carry it.

u64 words live in int64 lanes (torch has no unsigned 64-bit arithmetic on
the CPU): right shifts mask off the sign copies, and unsigned compares
flip the sign bit. Every shift count is clamped into [0, 63], as in the
reference: a shift by 64 or more is undefined in CUDA C++.
"""

from __future__ import annotations

import operator
from typing import NamedTuple, Optional, Tuple

import torch

from .uword import SIGN64, shr_u64, ucmp64

__all__ = [
    "segment_sum_f64bits",
    "segment_mean_f64bits",
    "i64_to_f64bits",
    "u64_to_f64bits",
    "mean_i64_div",
    "div_f64bits_by_int",
]

LIMBS = 7  # 224-bit window
# The mantissa MSB of a max-exponent element sits at window bit 160, its
# LSB at bit 108; window bit 0 weighs 2^(E - 1183), E the segment's max
# biased effective exponent. Bits 160..223 are headroom for the sum.
_ANCHOR_LSB = 108
_MASK32 = 0xFFFFFFFF
_FRAC52 = (1 << 52) - 1
_INF_BITS = 0x7FF << 52
_NAN_BITS = _INF_BITS | (1 << 51)
# segment counts up to which the per-segment sums are masked reductions
# (one pass over the payload a segment) rather than one index_add_
SMALL_SEGMENTS = 16


def _decompose(bits: torch.Tensor):
    """IEEE-754 double bits -> (negative, e_eff, mantissa, is_nan, is_pinf,
    is_ninf). e_eff is the effective biased exponent (subnormals read as
    1 with no implicit bit), so every finite value is m * 2^(e_eff-1075)."""
    neg = bits < 0
    e = (bits >> 52) & 0x7FF
    frac = bits & _FRAC52
    is_nan = (e == 0x7FF) & (frac != 0)
    is_inf = (e == 0x7FF) & (frac == 0)
    mant = torch.where(e == 0, frac, frac | (1 << 52))
    e_eff = torch.where(e == 0, 1, e)
    finite = e != 0x7FF
    mant = torch.where(finite, mant, 0)
    e_eff = torch.where(finite, e_eff, 1)
    return neg, e_eff, mant, is_nan, is_inf & ~neg, is_inf & neg


def _element_limbs(mant: torch.Tensor, shift: torch.Tensor) -> list:
    """Per-element limbs, values in [0, 2^32) in int64: bits [32k, 32k+32)
    of mant << (108 - shift). ``mant`` is a u64 word (up to 64 bits: 53
    for doubles, up to 64 for an integer mean's dividend)."""
    out = []
    m32 = mant & _MASK32
    shift = shift.to(torch.int64)
    for k in range(LIMBS):
        t = (32 * k - _ANCHOR_LSB) + shift  # bit offset into mant of this limb's LSB
        right = shr_u64(mant, t.clamp(0, 63)) & _MASK32
        left = (m32 << (-t).clamp(0, 31)) & _MASK32
        limb = torch.where(t >= 0, right, left)
        out.append(torch.where((t >= 64) | (t <= -32), 0, limb))
    return out


class _GroupSum(NamedTuple):
    """Exact per-segment sum in windowed fixed point, before rounding."""

    limbs: torch.Tensor  # [G, LIMBS] int64 signed limb partial sums
    emax: torch.Tensor  # [G] int64 segment max effective biased exponent
    has_nan: torch.Tensor  # [G] bool
    has_pinf: torch.Tensor
    has_ninf: torch.Tensor


def _segment_max(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Per-segment max of non-negative int64 values (0 for an empty segment)."""
    if num <= SMALL_SEGMENTS:
        return torch.stack([torch.where(seg == g, x, 0).max() for g in range(num)])
    return torch.zeros(num, dtype=x.dtype, device=x.device).scatter_reduce_(
        0, seg.to(torch.int64), x, "amax")


def segment_rows(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Per-segment sum of the rows of an int64 [N] or [N, W] payload:
    masked reductions for at most ``SMALL_SEGMENTS`` segments, one
    ``index_add_`` above (integer sums: the two agree exactly)."""
    if num == 0:
        return x.new_zeros((0,) + tuple(x.shape[1:]))
    if num <= SMALL_SEGMENTS:
        m = seg[:, None] if x.dim() == 2 else seg
        return torch.stack([torch.where(m == g, x, 0).sum(0) for g in range(num)])
    out = torch.zeros((num,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg.to(torch.int64), x)


def _accumulate(bits, valid, seg, num_segments) -> _GroupSum:
    dev = bits.device
    if num_segments == 0 or bits.shape[0] == 0:
        # no segments, or no rows: every segment sums to +0.0
        z = torch.zeros((num_segments,), dtype=torch.bool, device=dev)
        return _GroupSum(torch.zeros((num_segments, LIMBS), dtype=torch.int64, device=dev),
                         torch.ones((num_segments,), dtype=torch.int64, device=dev), z, z, z)
    neg, e_eff, mant, is_nan, is_pinf, is_ninf = _decompose(bits)
    live = valid if valid is not None else torch.ones(bits.shape, dtype=torch.bool, device=dev)
    is_nan, is_pinf, is_ninf = is_nan & live, is_pinf & live, is_ninf & live
    emax = _segment_max(torch.where(live, e_eff, 0), seg, num_segments).clamp(min=1)
    shift = emax[seg.to(torch.int64)] - e_eff  # >= 0 for live rows
    sgn = torch.where(live, torch.where(neg, -1, 1), 0)
    payload = torch.stack(
        [limb * sgn for limb in _element_limbs(mant, shift)]
        + [is_nan.to(torch.int64), is_pinf.to(torch.int64), is_ninf.to(torch.int64)], dim=1)
    acc = segment_rows(payload, seg, num_segments)
    return _GroupSum(acc[:, :LIMBS], emax, acc[:, LIMBS] > 0, acc[:, LIMBS + 1] > 0,
                     acc[:, LIMBS + 2] > 0)


def _carry_normalize(acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G, LIMBS] signed int64 partials -> (negative [G], magnitude
    [G, LIMBS] limbs in [0, 2^32)): carry-propagate into a two's-complement
    limb string, then invert + 1 where negative."""
    out = []
    carry = torch.zeros(acc.shape[:-1], dtype=torch.int64, device=acc.device)
    for k in range(LIMBS):
        t = acc[..., k] + carry
        out.append(t & _MASK32)
        carry = t >> 32  # arithmetic: sign-correct
    negative = carry < 0
    mag = []
    add = negative.to(torch.int64)
    for k in range(LIMBS):
        t = torch.where(negative, out[k] ^ _MASK32, out[k]) + add
        mag.append(t & _MASK32)
        add = t >> 32
    return negative, torch.stack(mag, dim=-1)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of a 32-bit value in [0, 2^32) (32 for 0)."""
    n = torch.full(x.shape, 32, dtype=torch.int64, device=x.device)
    f = x
    for s in (16, 8, 4, 2, 1):
        big = f >= (1 << s)
        n = torch.where(big, n - s, n)
        f = torch.where(big, f >> s, f)
    return torch.where(x == 0, 32, n - 1)


def _msb_pos(mag: torch.Tensor) -> torch.Tensor:
    """[G, LIMBS] magnitude -> [G] highest set bit (-1 when zero)."""
    best = torch.full(mag.shape[:-1], -1, dtype=torch.int64, device=mag.device)
    for k in range(LIMBS):
        limb = mag[..., k]
        best = torch.where(limb != 0, 32 * k + 31 - _clz32(limb), best)
    return best


def _extract_bits(mag: torch.Tensor, start: torch.Tensor, width: int) -> torch.Tensor:
    """Bits [start, start+width) of the limb string (width <= 62), funnel
    shifted out of the four aligned u64 words."""
    words = []
    for w in range((LIMBS + 1) // 2):
        lo = mag[..., 2 * w]
        hi = mag[..., 2 * w + 1] if 2 * w + 1 < LIMBS else torch.zeros_like(lo)
        words.append(lo | (hi << 32))
    idx = start >> 6
    r = start & 63
    res = torch.zeros(mag.shape[:-1], dtype=torch.int64, device=mag.device)
    for w, cur in enumerate(words):
        nxt = words[w + 1] if w + 1 < len(words) else torch.zeros_like(cur)
        # (cur >> r) | (nxt << (64 - r)), r == 0 taken apart (a shift by 64)
        hi_part = torch.where(r == 0, 0, nxt << (64 - r.clamp(min=1)))
        res = torch.where(idx == w, shr_u64(cur, r) | hi_part, res)
    return res & ((1 << width) - 1)


def _sticky_below(mag: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Any bit of the limb string strictly below bit ``pos`` set? [G] bool."""
    sticky = torch.zeros(mag.shape[:-1], dtype=torch.bool, device=mag.device)
    for k in range(LIMBS):
        limb = mag[..., k]
        full = pos >= 32 * (k + 1)
        partial = (pos > 32 * k) & ~full
        mask = (1 << (pos - 32 * k).clamp(0, 32)) - 1
        sticky = sticky | (full & (limb != 0)) | (partial & ((limb & mask) != 0))
    return sticky


def _round_to_bits(negative, mag, emax, has_nan, has_pinf, has_ninf,
                   extra_sticky: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Windowed sign-magnitude -> IEEE-754 double bits, nearest-even."""
    emax = emax.to(torch.int64)
    B = _msb_pos(mag)
    # result = keep53 * 2^(q + emax - 1183); the subnormal boundary forces
    # q >= 109 - emax
    q = torch.maximum(B - 52, 109 - emax)
    q_pos = q.clamp(min=0)
    # rounding path (q > 0): keep bits [q, q+53), guard bit q-1, sticky below
    keep_r = _extract_bits(mag, q_pos, 53)
    guard = torch.where(q_pos > 0, _extract_bits(mag, (q_pos - 1).clamp(min=0), 1), 0)
    sticky = _sticky_below(mag, (q_pos - 1).clamp(min=0)) & (q_pos > 0)
    if extra_sticky is not None:
        sticky = sticky | extra_sticky
    round_up = (guard == 1) & (sticky | ((keep_r & 1) == 1))
    keep_r = keep_r + round_up.to(torch.int64)
    # exact path (q <= 0): the magnitude lies below bit 53, in word 0
    w0 = mag[..., 0] | (mag[..., 1] << 32)
    keep_e = w0 << (-q).clamp(0, 63)
    keep = torch.where(q > 0, keep_r, keep_e)
    ovf = (keep >> 53) != 0  # rounding carried out: 2^53 -> 2^52, exponent + 1
    keep = torch.where(ovf, keep >> 1, keep)
    q = q + ovf.to(torch.int64)

    subnormal = (B + emax) < 161
    biased = (q + emax - 108).clamp(0, 0x7FF)
    bits = torch.where(subnormal, keep, (biased << 52) | (keep & _FRAC52))
    overflow = ~subnormal & (q + emax - 108 >= 0x7FF)
    bits = torch.where(overflow, _INF_BITS, bits)
    zero = B < 0
    bits = torch.where(zero, 0, bits)
    bits = torch.where(negative & ~zero, bits | SIGN64, bits)
    bits = torch.where(has_pinf & ~has_ninf, _INF_BITS, bits)
    bits = torch.where(has_ninf & ~has_pinf, _INF_BITS | SIGN64, bits)
    return torch.where(has_nan | (has_pinf & has_ninf), _NAN_BITS, bits)


def segment_sum_f64bits(bits: torch.Tensor, seg: torch.Tensor, num_segments: int,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact per-segment SUM of FLOAT64 values held as int64 IEEE bits:
    [num_segments] int64 bits of the nearest-even float64 of the exact
    real sum. ``seg`` [N] in [0, num_segments); rows with ``valid`` False
    contribute nothing."""
    gs = _accumulate(bits, valid, seg, num_segments)
    negative, mag = _carry_normalize(gs.limbs)
    return _round_to_bits(negative, mag, gs.emax, gs.has_nan, gs.has_pinf, gs.has_ninf)


def _limb_divide(mag: torch.Tensor, cnt: torch.Tensor):
    """Long division of the 224-bit magnitude by ``cnt`` (< 2^31; 0 reads
    as 1) in base 2^32, most significant limb first. Returns (quotient
    [G, LIMBS] limbs, remainder-nonzero [G] bool)."""
    c = cnt.to(torch.int64).clamp(min=1)
    r = torch.zeros_like(c)
    q = [None] * LIMBS
    for k in reversed(range(LIMBS)):
        r = (r << 32) | mag[..., k]  # r < c < 2^31: below 2^63
        q[k] = torch.div(r, c, rounding_mode="floor")
        r = r - q[k] * c
    return torch.stack(q, dim=-1), r != 0


def segment_mean_f64bits(bits: torch.Tensor, seg: torch.Tensor, num_segments: int,
                         valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-segment MEAN of FLOAT64 bits: the nearest-even float64 of
    (exact sum / valid count). Returns (mean bits [G] int64, count [G]
    int64)."""
    gs = _accumulate(bits, valid, seg, num_segments)
    live = valid if valid is not None else torch.ones(bits.shape, dtype=torch.bool,
                                                     device=bits.device)
    if num_segments == 0:
        cnt = torch.zeros((0,), dtype=torch.int64, device=bits.device)
    else:
        cnt = segment_rows(live.to(torch.int64), seg, num_segments)
    negative, mag = _carry_normalize(gs.limbs)
    q, rem = _limb_divide(mag, cnt)
    out = _round_to_bits(negative, q, gs.emax, gs.has_nan, gs.has_pinf, gs.has_ninf,
                         extra_sticky=rem)
    return out, cnt


def u64_to_f64bits(x: torch.Tensor) -> torch.Tensor:
    """uint64 (bits in int64 lanes) -> IEEE-754 double bits, nearest-even
    (exact below 2^53)."""
    x = x.to(torch.int64)
    return _abs64_to_f64bits(x, torch.zeros(x.shape, dtype=torch.bool, device=x.device))


def i64_to_f64bits(x: torch.Tensor) -> torch.Tensor:
    """int64 -> IEEE-754 double bits, nearest-even (exact for |x| < 2^53)."""
    x = x.to(torch.int64)
    neg = x < 0
    return _abs64_to_f64bits(torch.where(neg, -x, x), neg)  # -INT64_MIN wraps to 2^63's bits


def _abs64_to_f64bits(a: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """u64 magnitude (bits in int64) and sign -> double bits, nearest-even."""
    msb = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    v = a
    for s in (32, 16, 8, 4, 2, 1):
        big = ucmp64(operator.ge, v, 1 << s)
        msb = torch.where(big, msb + s, msb)
        v = torch.where(big, shr_u64(v, s), v)
    sh = (msb - 52).clamp(min=0)
    shc = sh.clamp(0, 63)
    keep = shr_u64(a, shc)
    dropped = a & ((1 << shc) - 1)
    half = torch.where(sh > 0, 1 << (sh - 1).clamp(0, 63), 0)
    round_up = (sh > 0) & ((dropped > half) | ((dropped == half) & ((keep & 1) == 1)))
    keep = keep + round_up.to(torch.int64)
    carry = (keep >> 53) != 0
    keep = torch.where(carry, keep >> 1, keep)
    mant = torch.where(sh > 0, keep, keep << (52 - msb).clamp(0, 63))
    biased = msb + carry.to(torch.int64) + 1023
    bits = (biased << 52) | (mant & _FRAC52)
    bits = torch.where(a == 0, 0, bits)
    return torch.where(neg, bits | SIGN64, bits)


def mean_i64_div(sums: torch.Tensor, cnt: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """Exact float64 mean of integer aggregates, [G] int64 sums / [G] int64
    counts -> [G] int64 double bits: |sums| rides the window at the
    mantissa anchor (E = 1075 makes window bit 108 weigh 2^0), so the
    division yields 108 fractional quotient bits before the rounding.
    ``unsigned=True`` reads ``sums`` as uint64 magnitudes (UINT64 sums
    whose bits pass 2^63)."""
    sums = sums.to(torch.int64)
    if unsigned:
        neg = torch.zeros(sums.shape, dtype=torch.bool, device=sums.device)
        a = sums
    else:
        neg = sums < 0
        a = torch.where(neg, -sums, sums)
    e = torch.full(sums.shape, 1075, dtype=torch.int64, device=sums.device)
    mag = torch.stack(_element_limbs(a, torch.zeros_like(e)), dim=-1)
    q, rem = _limb_divide(mag, cnt)
    false = torch.zeros(sums.shape, dtype=torch.bool, device=sums.device)
    return _round_to_bits(neg, q, e, false, false, false, extra_sticky=rem)


def div_f64bits_by_int(bits: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 division of double bits by positive
    integers (< 2^31): the mantissa rides the window at its own exponent,
    the division gives 161 quotient bits and a remainder sticky, and the
    shared rounding emits the bits."""
    neg, e_eff, mant, is_nan, is_pinf, is_ninf = _decompose(bits.to(torch.int64))
    mag = torch.stack(_element_limbs(mant, torch.zeros_like(e_eff)), dim=-1)
    q, rem = _limb_divide(mag, cnt)
    return _round_to_bits(neg, q, e_eff, is_nan, is_pinf, is_ninf, extra_sticky=rem)
