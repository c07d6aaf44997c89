"""DECIMAL128 multiply/divide with Spark-compatible rounding and overflow
(port of the JAX package's ``ops/decimal_utils.py``).

Behavioral parity with the reference's decimal_utils.cu:

- ``multiply128`` (dec128_multiplier :524-592): the 256-bit product, then
  the SPARK-40129 double rounding -- first to precision 38 by
  ``precision10`` (which counts an exact power of ten one short), then to
  the requested product scale; overflow when the 256-bit value does not
  fit a signed 128-bit integer.
- ``divide128`` (dec128_divider :595-684): three regimes keyed by
  ``n_shift_exp = quot_scale - (a_scale - b_scale)``: divide then divide
  (> 0), multiply then divide (in [-38, 0]), and base-10 long division
  through a 10^38 split (< -38); a zero divisor sets the overflow flag
  and gives quotient 0 (:608-612); rounding is half up, away from zero,
  from the remainder (round_from_remainder :196-227).
- both return a Table {BOOL8 overflow, DECIMAL128 result} whose validity
  is the AND of the inputs' (:690-733).

Signs are split off and the arithmetic runs on [N, 8] limb magnitudes
(``ops/limbs.py``), whole columns at a time; the scales are host ints, so
the regime is picked on the host.
"""

from __future__ import annotations

import torch

from ..columnar import Column, Table
from ..columnar import dtype as dt
from ..columnar.dtype import TypeId, decimal128
from . import limbs as L
from .uword import to_signed_bits, u32_to_i64
from ..utils.dispatch import op_boundary

__all__ = ["multiply128", "divide128"]

_SIGNED128_POS_MAX = 2**127 - 1
_SIGNED128_NEG_MAX = 2**127


def _check_inputs(a: Column, b: Column) -> None:
    if a.dtype.id != TypeId.DECIMAL128 or b.dtype.id != TypeId.DECIMAL128:
        raise ValueError("inputs must be DECIMAL128 columns")
    if len(a) != len(b):
        raise ValueError("inputs have mismatched row counts")


def _and_validity(a: Column, b: Column):
    if a.validity is None and b.validity is None:
        return None
    return a.valid_mask() & b.valid_mask()


def _fits_128(mag: torch.Tensor, negative: torch.Tensor) -> torch.Tensor:
    """Signed-128 fit test on a [..., 8] magnitude (chunked256
    fits_in_128_bits :108-118): |v| <= 2^127 - 1, or 2^127 when negative."""
    pos_max = L.constant(_SIGNED128_POS_MAX, 8, mag.device)
    neg_max = L.constant(_SIGNED128_NEG_MAX, 8, mag.device)
    return torch.where(negative, ~L.gt(mag, neg_max), ~L.gt(mag, pos_max))


def _round_half_up(q_mag: torch.Tensor, r_mag: torch.Tensor, d_mag: torch.Tensor) -> torch.Tensor:
    """Add 1 to |q| when 2|r| >= |d| (round_from_remainder :196-227; away
    from zero in magnitude form)."""
    lost = (r_mag[..., -1] >> 31) == 1  # the doubling overflowed
    need_inc = lost | L.ge(L.shift_left_one(r_mag), d_mag)
    return L.add_small(q_mag, need_inc.to(torch.int64))[0]


def _divide_and_round(n_mag: torch.Tensor, d_mag: torch.Tensor) -> torch.Tensor:
    q, r = L.divmod_bits(n_mag, d_mag)
    return _round_half_up(q, r, d_mag)


def _magnitudes(col: Column):
    return L.from_twos_complement(u32_to_i64(col.data))


def _multiply(a: Column, b: Column, a_scale: int, b_scale: int, prod_scale: int):
    a_mag, a_neg = _magnitudes(a)
    b_mag, b_neg = _magnitudes(b)
    negative = a_neg ^ b_neg

    product = L.mul(a_mag, b_mag, 8)  # [N, 8] magnitude

    # SPARK-40129 first rounding: to precision 38 by the product's own
    # precision10 (:538-553)
    first_div_precision = L.precision10(product) - 38
    do_first = first_div_precision > 0
    rounded1 = _divide_and_round(product, L.pow10(first_div_precision.clamp(min=0), 8))
    product = torch.where(do_first[..., None], rounded1, product)
    mult_scale = a_scale + b_scale + torch.where(do_first, first_div_precision, 0)

    exponent = prod_scale - mult_scale

    # exponent < 0: multiply up unless it would exceed precision 38 (:556-567)
    would_overflow = (exponent < 0) & (L.precision10(product) - exponent > 38)
    scale_mult = L.pow10((-exponent).clamp(min=0), 8)
    multiplied = L.mul(product[..., :4], scale_mult[..., :4], 8)
    # the product exceeds 4 limbs only where it overflows anyway
    product_up = torch.where(would_overflow[..., None], product, multiplied)

    # exponent >= 0: divide and round (:568-576)
    divided = _divide_and_round(product, L.pow10(exponent.clamp(min=0), 8))

    product = torch.where((exponent < 0)[..., None], product_up, divided)
    overflow = would_overflow | ~_fits_128(product, negative)
    return L.to_twos_complement(product[..., :4], negative), overflow


@op_boundary("multiply128")
def multiply128(a: Column, b: Column, product_scale: int) -> Table:
    """Parity: DecimalUtils.multiply128 (DecimalUtils.java:40) ->
    cudf::jni::multiply_decimal128 (decimal_utils.cu:690-711)."""
    _check_inputs(a, b)
    # check_scale_divisor (:500-503)
    if product_scale - (a.dtype.scale + b.dtype.scale) > 38:
        raise ValueError("divisor too big")
    result, overflow = _multiply(a, b, a.dtype.scale, b.dtype.scale, product_scale)
    return _result(a, b, overflow, result, product_scale, "product")


def _result(a: Column, b: Column, overflow, limbs, scale: int, name: str) -> Table:
    validity = _and_validity(a, b)
    return Table(
        [
            Column(dt.BOOL8, data=overflow.to(torch.uint8), validity=validity),
            Column(decimal128(scale), data=to_signed_bits(limbs, 32), validity=validity),
        ],
        names=["overflow", name],
    )


def _divide(a: Column, b: Column, a_scale: int, b_scale: int, quot_scale: int):
    n_mag4, n_neg = _magnitudes(a)
    d_mag4, d_neg = _magnitudes(b)
    negative = n_neg ^ d_neg
    div_by_zero = L.is_zero(d_mag4)

    pad = torch.zeros_like(n_mag4)
    n_mag = torch.cat([n_mag4, pad], dim=-1)  # [N, 8]
    d_mag = torch.cat([d_mag4, pad], dim=-1)
    # a zero divisor is replaced by 1 for the arithmetic and flagged at the end
    d_safe = d_mag.clone()
    d_safe[..., 0] = torch.where(div_by_zero, 1, d_mag[..., 0])
    dev = n_mag.device

    n_shift_exp = quot_scale - (a_scale - b_scale)

    if n_shift_exp > 0:
        # divide twice (:617-630)
        q1, _ = L.divmod_bits(n_mag, d_safe)
        result = _divide_and_round(q1, L.constant(10**min(n_shift_exp, 76), 8, dev))
    elif n_shift_exp < -38:
        # base-10 long division through a 10^38 split (:631-658)
        n38 = L.mul(n_mag4, L.constant(10**38, 8, dev), 8)
        q1, r1 = L.divmod_bits(n38, d_safe)
        scale_mult = L.constant(10**min(-n_shift_exp - 38, 76), 8, dev)
        # mod-2^256 products, the wrap of chunked256::multiply
        result = L.mul(q1, scale_mult, 8)
        q2, r2 = L.divmod_bits(L.mul(r1, scale_mult, 8), d_safe)
        result, _ = L.add(result, q2)
        result = _round_half_up(result, r2, d_safe)
    else:
        # multiply then divide (:660-672)
        if n_shift_exp < 0:
            n_mag = L.mul(n_mag4, L.constant(10 ** (-n_shift_exp), 8, dev), 8)
        result = _divide_and_round(n_mag, d_safe)

    overflow = div_by_zero | ~_fits_128(result, negative)
    quotient = L.to_twos_complement(result[..., :4], negative)
    quotient = torch.where(div_by_zero[..., None], 0, quotient)
    return quotient, overflow


@op_boundary("divide128")
def divide128(a: Column, b: Column, quotient_scale: int) -> Table:
    """Parity: DecimalUtils.divide128 (DecimalUtils.java:55) ->
    cudf::jni::divide_decimal128 (decimal_utils.cu:713-733)."""
    _check_inputs(a, b)
    result, overflow = _divide(a, b, a.dtype.scale, b.dtype.scale, quotient_scale)
    return _result(a, b, overflow, result, quotient_scale, "quotient")
