"""Spark-semantics string -> decimal cast, DECIMAL32/64/128 (port of the
JAX package's ``ops/cast_decimal.py``).

Behavioral parity with the reference's cast_string.cu:243-574:

- pass 1 (validate_and_exponent :243-369): a state machine over the chars
  accepting [ws] [+-] digits ['.' digits] [eE [+-] digits] [ws], one
  decimal point at most, whitespace after exponent digits INVALID (the
  quirk is kept), empty and sign-only strings invalid; it gives the sign,
  the first digit's index and the decimal location moved by the
  (overflow-checked) exponent.
- pass 2 (string_to_decimal_kernel :385-574): accumulate digits up to the
  precision / scale cutoff, round half up away from zero at the cutoff
  digit (a carry rippling into a new digit is detected), count the
  significant digits before the decimal, pad with zeros up to the
  decimal location and down to the scale, with the target type's
  overflow checks at every multiply -- rows that fail become null
  (non-ANSI) or raise CastError.

Scale follows the cudf convention (negative = fractional digits); the
output type by precision is DECIMAL32 up to 9, DECIMAL64 up to 18, else
DECIMAL128 (string_to_decimal :792-801).

Pass 1 is a Python loop over the padded [N, L] char matrix carrying the
state as tensors; pass 2's counters are cumulative sums over the char
axis, and its digit accumulator is [N, 4] limbs (``ops/limbs.py``), so
one code path serves all three widths.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..columnar import Column
from ..columnar.dtype import TypeId, decimal32, decimal64, decimal128
from . import limbs as L
from .cast_string import CastError  # noqa: F401  (raised here in ANSI mode; re-exported)
from .cast_string import _first_index, _leading, _padded_chars, _validate_ansi
from .uword import join_u64, to_signed_bits

__all__ = ["string_to_decimal"]

_LIMITS = {  # (positive magnitude limit, negative magnitude limit)
    TypeId.DECIMAL32: (2**31 - 1, 2**31),
    TypeId.DECIMAL64: (2**63 - 1, 2**63),
    TypeId.DECIMAL128: (2**127 - 1, 2**127),
}

# pass-1 states
_D = 0  # reading value digits (includes just after the dot)
_EOS = 1  # just read e/E: exponent or sign
_ES = 2  # just read the exponent's sign
_E = 3  # reading exponent digits
_W = 4  # trailing whitespace
_X = 5  # invalid

_I64_MAX = 2**63 - 1


def _parse_decimal(chars: torch.Tensor, lens: torch.Tensor, in_valid: torch.Tensor,
                   max_len: int, precision: int, scale: int, pos_limit: int, neg_limit: int):
    n = chars.shape[0]
    dev = chars.device
    lens = lens.to(torch.int64)
    istart, negative, ws, inb = _leading(chars, lens, max_len, signed=True)
    positive = ~negative
    valid = in_valid & (lens > 0) & (istart < lens)
    digit = (chars >= ord("0")) & (chars <= ord("9"))
    isdot = chars == ord(".")
    is_e = (chars == ord("e")) | (chars == ord("E"))
    j_idx = torch.arange(max_len, device=dev)[None, :]
    # what pass 1 reads a column at a time, made once over [N, L]
    after_start = (j_idx >= istart[:, None]) & inb  # the active chars
    ws_later = ws & (j_idx != istart[:, None])
    minus = chars == ord("-")
    is_sign = minus | (chars == ord("+"))
    digval = torch.where(digit, chars - ord("0"), 0)

    # --- pass 1: validation state machine + exponent ----------------------
    state = torch.zeros((n,), dtype=torch.int64, device=dev)
    dot_seen = torch.zeros((n,), dtype=torch.bool, device=dev)
    dot_rel = torch.zeros((n,), dtype=torch.int64, device=dev)
    last_digit_abs = lens  # defaults to len (absolute)
    exp_mag = torch.zeros((n,), dtype=torch.int64, device=dev)
    exp_pos = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_digit = torch.zeros((n,), dtype=torch.bool, device=dev)
    for j in range(max_len):
        active = after_start[:, j]
        d, w, dot, e, w_later = digit[:, j], ws[:, j], isdot[:, j], is_e[:, j], ws_later[:, j]

        from_d = torch.where(
            d | (dot & ~dot_seen), _D,
            torch.where(e, _EOS, torch.where(w_later, _W, _X)))
        from_eos = torch.where(
            is_sign[:, j], _ES,
            torch.where(w_later, _W, torch.where(d, _E, _X)))
        from_es_e = torch.where(d, _E, _X)
        from_w = torch.where(w, _W, _X)
        nxt = torch.where(
            state == _D, from_d,
            torch.where(state == _EOS, from_eos,
                        torch.where((state == _ES) | (state == _E), from_es_e, from_w)))
        nxt = torch.where(active, nxt, state)

        # the first dot's position (relative)
        new_dot = active & (state == _D) & dot & ~dot_seen
        dot_rel = torch.where(new_dot, j - istart, dot_rel)
        dot_seen = dot_seen | new_dot

        # last_digit: leaving the digit run for e or whitespace, only when the
        # previous char was a digit (cast_string.cu:344-347's last_state check)
        leave = active & (state == _D) & prev_digit & ((nxt == _EOS) | (nxt == _W))
        last_digit_abs = torch.where(leave & (last_digit_abs == lens), j, last_digit_abs)

        # the exponent's sign and digits, overflow-checked against 2^63 - 1
        exp_pos = torch.where(active & (state == _EOS) & minus[:, j], False, exp_pos)
        consume_exp = active & ((state == _EOS) | (state == _ES) | (state == _E)) & d & (nxt == _E)
        dig = digval[:, j].to(torch.int64)
        first = consume_exp & (exp_mag == 0)
        ovf = exp_mag > _I64_MAX // 10
        exp10 = torch.where(ovf, 0, exp_mag) * 10
        ovf = ovf | (exp10 > _I64_MAX - dig)
        bad_exp = consume_exp & ~first & ovf
        nxt = torch.where(bad_exp, _X, nxt)
        exp_mag = torch.where(consume_exp & ~bad_exp, torch.where(first, dig, exp10 + dig), exp_mag)

        prev_digit = torch.where(active, d, prev_digit)
        state = nxt
    valid = valid & (state != _X)

    exp_val = torch.where(exp_pos, exp_mag, -exp_mag)
    dl0 = torch.where(dot_seen, dot_rel, last_digit_abs - istart)
    decimal_location = dl0 + exp_val  # before rounding (cast_string.cu:363-366)

    # --- pass 2 precomputation (prefix counters over the char axis) -------
    # the run ends at the first char after istart that is neither digit nor dot
    break_pos = _first_index(after_start & ~digit & ~isdot, lens)

    last_digit = decimal_location - scale  # :444
    in_run = after_start & (j_idx < break_pos[:, None])
    dmask = in_run & digit & (last_digit >= 0)[:, None]  # :453's loop guard

    dm = dmask.to(torch.int64)
    td = _cumcount(dmask)  # total_digits including the current one
    nonzero = chars != ord("0")
    sig_seed = dmask & (nonzero | (td > decimal_location[:, None]))
    found_prior = _cumcount(sig_seed) - sig_seed.to(torch.int64) > 0
    sig = dmask & (found_prior | nonzero | (td > decimal_location[:, None]))
    sg = sig.to(torch.int64)
    np_ = _cumcount(sig)  # num_precise_digits including the current one

    cutoff = dmask & ((np_ - sg + 1 > precision) | (td - dm + 1 > last_digit[:, None]))
    cut_pos = _first_index(cutoff, torch.full_like(lens, max_len))
    acc_mask = dmask & (j_idx < cut_pos[:, None])

    # counters at the end of accumulation (the cutoff digit excluded)
    total_digits = acc_mask.sum(1)
    num_precise = (sig & acc_mask).sum(1)

    # --- accumulate the magnitude over the char axis ----------------------
    acc = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    digits = torch.where(acc_mask, chars.to(torch.int64) - ord("0"), 0)
    for j in range(max_len):
        acc = torch.where(acc_mask[:, j, None], L.mul10_add(acc, digits[:, j]), acc)

    limit = torch.where(positive[:, None], L.constant(pos_limit, 4, dev),
                        L.constant(neg_limit, 4, dev))

    # --- rounding at the cutoff digit (:466-506) --------------------------
    cut_digit = torch.gather(chars, 1, cut_pos.clamp(0, max_len - 1)[:, None])[:, 0]
    round_up = cutoff.any(1) & (cut_digit >= ord("5")) & (cut_digit <= ord("9"))
    acc_inc, carry = L.add_small(acc, round_up.to(torch.int64))
    valid = valid & ~(round_up & (L.gt(acc_inc, limit) | (carry != 0)))
    digit_added = round_up & ~L.is_zero(acc) & L.is_all_nines(acc)
    acc = torch.where(round_up[:, None], acc_inc, acc)
    rounding_digits = digit_added.to(torch.int64)
    total_digits = total_digits + rounding_digits
    num_precise = num_precise + rounding_digits
    decimal_location_r = decimal_location + rounding_digits

    # --- significant digits before the decimal in the string (:411-433) ---
    e_pos = _first_index(after_start & is_e, lens)
    count_region = after_start & ~isdot & (j_idx < e_pos[:, None])
    df = _cumcount(count_region)  # digits_found including the current one
    counted = count_region & (df <= decimal_location[:, None])
    started = _cumcount(counted & nonzero) > 0
    sig_in_string = (counted & started).sum(1)

    # --- zero padding to the decimal location (:527-539) ------------------
    zeros_to_decimal = (decimal_location_r - total_digits - (scale if scale > 0 else 0)).clamp(min=0)
    sig_before_decimal = sig_in_string + zeros_to_decimal + rounding_digits
    valid = valid & ~(precision + scale < sig_before_decimal)  # :522

    acc, ovf1 = _mul_pow10_checked(acc, zeros_to_decimal, limit)
    valid = valid & ~ovf1
    num_precise = num_precise + zeros_to_decimal

    # --- zero padding down to the scale (:541-556) ------------------------
    sig_preceding_zeros = torch.where(decimal_location_r < 0, -decimal_location_r, 0)
    digits_after_decimal = num_precise - sig_before_decimal + sig_preceding_zeros
    digits_needed = torch.clamp(precision - sig_before_decimal, max=-scale)
    pad = (digits_needed - digits_after_decimal).clamp(min=0)
    acc, ovf2 = _mul_pow10_checked(acc, pad, limit)
    valid = valid & ~ovf2

    return acc, positive, valid


def _cumcount(mask: torch.Tensor) -> torch.Tensor:
    """The running count of a [N, L] bool mask along the char axis, as
    int64: one matmul with an upper-triangular matrix of ones, exact in
    float32 (every count is at most L). A cumulative sum along the
    innermost axis of a million rows is a scan that costs the card
    ~6.5 ms (PERF.md section 6)."""
    L = mask.shape[1]
    ones = torch.ones((L, L), dtype=torch.float32, device=mask.device).triu()
    return (mask.to(torch.float32) @ ones).to(torch.int64)


def _mul_pow10_checked(acc: torch.Tensor, k: torch.Tensor,
                       limit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """acc * 10^k with the reference's per-step overflow semantics
    (will_overflow before each *10, cast_string.cu:528-538): the same as
    checking the final product against the limit; k > 38 with acc != 0
    always overflows (10^39 > 2^127)."""
    prod = L.mul(acc, L.pow10(k, 4), 8)
    lo, hi = prod[..., :4], prod[..., 4:]
    overflow = ~L.is_zero(acc) & ((k > 38) | ~L.is_zero(hi) | L.gt(lo, limit))
    return torch.where(((k > 0) & ~overflow)[..., None], lo, acc), overflow


def string_to_decimal(col: Column, ansi_mode: bool, precision: int, scale: int) -> Column:
    """String column -> decimal column. Parity: cast_string.cu :785-801.

    ``scale`` is the cudf scale (negative = fractional digits).
    """
    if col.dtype.id != TypeId.STRING:
        raise ValueError("string_to_decimal expects a STRING column")
    if not (1 <= precision <= 38):
        raise ValueError(f"precision must be in [1, 38], got {precision}")

    if precision <= 9:
        out_dtype = decimal32(scale)
    elif precision <= 18:
        out_dtype = decimal64(scale)
    else:
        out_dtype = decimal128(scale)

    n = len(col)
    if n == 0:
        shape = (0, 4) if out_dtype.id == TypeId.DECIMAL128 else (0,)
        return Column(out_dtype, data=torch.zeros(shape, dtype=out_dtype.torch_dtype,
                                                  device=col.device))

    chars, lens, max_len = _padded_chars(col)
    pos_limit, neg_limit = _LIMITS[out_dtype.id]
    acc, positive, valid = _parse_decimal(
        chars, lens, col.valid_mask(), max_len, precision, scale, pos_limit, neg_limit)

    signed = torch.where(valid[:, None], L.to_twos_complement(acc, ~positive), 0)
    words = to_signed_bits(signed, 32)
    if out_dtype.id == TypeId.DECIMAL128:
        data = words
    elif out_dtype.id == TypeId.DECIMAL64:
        data = join_u64(words[:, 0], words[:, 1])
    else:
        data = words[:, 0].contiguous()

    if ansi_mode:
        _validate_ansi(valid, col)
    return Column(out_dtype, data=data, validity=valid)
