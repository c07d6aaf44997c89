"""Spark-semantics string casts: string -> integer / decimal, with ANSI
mode (port of the JAX package's ``ops/cast_string.py``).

Behavioral parity with the reference's cast_string.cu:

- the whitespace set is {space, \\r, \\t, \\n} (cast_string.cu:46-55),
- leading whitespace, then an optional +/- sign (signed targets only),
- non-ANSI integer casts truncate at the first '.', but invalid
  characters after it still invalidate the row (:207-210),
- whitespace inside a value starts a trailing-whitespace region; any
  non-whitespace after that invalidates (:199-204),
- digit accumulation is overflow-checked against the target type at
  every step, negative values accumulate toward min (:77-143),
- decimals (``cast_decimal``) take scientific notation, round half up
  away from zero at the precision and pad with zeros to the scale
  (:243-574),
- ANSI mode: rows that fail (and were not null already) raise
  ``CastError`` with the FIRST failing row and its string
  (validate_ansi_column, :594-627).

Strings are padded into an [N, L] byte matrix (L = the longest string of
the batch) by ``strings.to_padded`` (B8's ``extract_strings_many`` on the
card), and a Python loop walks the L character columns once, carrying the
whole column's parser state as tensors; all control flow is
``torch.where``.
"""

from __future__ import annotations

import operator
from typing import Optional

import torch

from ..columnar import Column
from ..columnar.dtype import DType, TypeId
from .strings import to_padded
from .uword import SIGN64, to_signed_bits, u64_bits, ucmp64

__all__ = ["CastError", "string_to_integer", "string_to_decimal"]


class CastError(RuntimeError):
    """Parity with com.nvidia.spark.rapids.jni.CastException
    (CastException.java:25-39)."""

    def __init__(self, row_with_error: int, string_with_error: Optional[str]):
        super().__init__(f"Error casting data on row {row_with_error}: {string_with_error!r}")
        self.row_with_error = int(row_with_error)
        self.string_with_error = string_with_error


_WS = (ord(" "), ord("\r"), ord("\t"), ord("\n"))

# (largest magnitude, largest negative magnitude) of each target
_INT_LIMITS = {
    TypeId.INT8: (127, 128),
    TypeId.INT16: (2**15 - 1, 2**15),
    TypeId.INT32: (2**31 - 1, 2**31),
    TypeId.INT64: (2**63 - 1, 2**63),
    TypeId.UINT8: (255, 0),
    TypeId.UINT16: (2**16 - 1, 0),
    TypeId.UINT32: (2**32 - 1, 0),
    TypeId.UINT64: (2**64 - 1, 0),
}

def _is_ws(c: torch.Tensor) -> torch.Tensor:
    r = c == _WS[0]
    for w in _WS[1:]:
        r = r | (c == w)
    return r


def _first_index(mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    """Per row, the first column where ``mask`` holds, else ``default``
    (an all-false row's argmax is 0, so the ``any`` guards it)."""
    first = torch.argmax(mask.to(torch.uint8), dim=1)
    return torch.where(mask.any(dim=1), first, default)


def _leading(chars: torch.Tensor, lens: torch.Tensor, max_len: int, signed: bool):
    """The leading whitespace and sign: (istart, the first index past
    them; negative; the [N, L] whitespace mask; the [N, L] in-bounds
    mask). An unsigned target takes no sign."""
    ws = _is_ws(chars)
    inb = torch.arange(max_len, device=chars.device)[None, :] < lens[:, None]
    i0 = _first_index(~ws & inb, lens.to(torch.int64))
    c0 = torch.gather(chars, 1, i0.clamp(0, max_len - 1)[:, None])[:, 0]
    has_sign = ((c0 == ord("+")) | (c0 == ord("-"))) & (i0 < lens)
    if not signed:
        has_sign = torch.zeros_like(has_sign)
    negative = (c0 == ord("-")) & has_sign
    return i0 + has_sign.to(torch.int64), negative, ws, inb


def _parse_integer(chars, lens, in_valid, is_signed: bool, max_mag: int, neg_mag: int,
                   ansi_mode: bool, max_len: int):
    """Returns ([N] int64 holding the u64 magnitude, [N] negative flag,
    [N] valid flag). The 64-bit limits (2^63, 2^64 - 1) do not fit an
    int64 lane as values, so the accumulator holds u64 bits and its
    compares against them are unsigned."""
    n = chars.shape[0]
    dev = chars.device
    istart, negative, ws, inb = _leading(chars, lens, max_len, is_signed)
    digit = (chars >= ord("0")) & (chars <= ord("9"))
    valid = in_valid & (lens > 0) & (istart < lens)
    # what the loop reads a column at a time, made once over [N, L]
    j_idx = torch.arange(max_len, device=dev)[None, :]
    active_all = inb & (j_idx >= istart[:, None])
    ws_later = ws & (j_idx > istart[:, None])
    dot_all = (chars == ord(".")) & (not ansi_mode)
    digval = torch.where(digit, chars - ord("0"), 0)

    limit = torch.where(negative, u64_bits(neg_mag), u64_bits(max_mag))
    lim_div10 = torch.where(negative, neg_mag // 10, max_mag // 10)

    # the character loop: state 0=DIGITS 1=TRUNC(after '.') 2=TRAILWS 3=INVALID
    state = torch.zeros((n,), dtype=torch.int64, device=dev)
    acc = torch.zeros((n,), dtype=torch.int64, device=dev)
    overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    seen_digit = torch.zeros((n,), dtype=torch.bool, device=dev)
    for j in range(max_len):
        active = active_all[:, j]
        d = digit[:, j]
        w = ws[:, j]

        nxt = torch.where(
            state == 0,
            torch.where(d, 0, torch.where(dot_all[:, j], 1, torch.where(ws_later[:, j], 2, 3))),
            torch.where(
                state == 1,
                torch.where(d, 1, torch.where(w, 2, 3)),
                torch.where((state == 2) & w, 2, 3),
            ),
        )
        nxt = torch.where(active, nxt, state)

        # accumulate while in DIGITS consuming a digit. Up to lim_div10,
        # acc * 5 < 2^63 and its doubling is the u64 acc * 10 in the lane;
        # the compare and the add of the digit run where the sign bit is
        # flipped, so that no signed lane overflows where acc10 + dig fits
        consume = active & d & (state == 0) & (nxt == 0)
        dig = digval[:, j].to(torch.int64)
        ovf_mul = ucmp64(operator.gt, acc, lim_div10)
        acc10 = ((torch.where(ovf_mul, 0, acc) * 5) << 1) ^ SIGN64
        ovf = ovf_mul | (acc10 > (limit ^ SIGN64) - dig)
        first = consume & ~seen_digit
        new_ovf = overflow | (consume & ~first & ovf)
        acc = torch.where(consume & ~new_ovf,
                          torch.where(first, dig, (acc10 + dig) ^ SIGN64), acc)
        overflow = new_ovf
        seen_digit = seen_digit | consume
        state = nxt

    return acc, negative, valid & (state != 3) & ~overflow


def _store_integer(signed_bits: torch.Tensor, out_dtype: DType) -> torch.Tensor:
    """int64 lanes holding the value's two's complement bits -> the
    target's storage, keeping its low bits (the reference's convert)."""
    width = 8 * out_dtype.size_bytes
    if width == 64:
        return signed_bits
    if out_dtype.torch_dtype == torch.uint8:
        return (signed_bits & 0xFF).to(torch.uint8)
    return to_signed_bits(signed_bits, width)


def string_to_integer(col: Column, ansi_mode: bool, out_dtype: DType) -> Column:
    """String column -> integral column. Parity: cast_string.cu
    string_to_integer :763."""
    if col.dtype.id != TypeId.STRING:
        raise ValueError("string_to_integer expects a STRING column")
    if not out_dtype.is_integral:
        raise ValueError(f"target must be integral, got {out_dtype!r}")
    n = len(col)
    if n == 0:
        return Column(out_dtype, data=torch.zeros((0,), dtype=out_dtype.torch_dtype,
                                                  device=col.device))

    chars, lens = to_padded(col)
    max_len = chars.shape[1]
    max_mag, neg_mag = _INT_LIMITS[out_dtype.id]
    acc, negative, valid = _parse_integer(
        chars, lens, col.valid_mask(), out_dtype.is_signed, max_mag, neg_mag, bool(ansi_mode),
        max_len)
    # the two's complement of the magnitude; 2^63's bits are their own
    data = _store_integer(torch.where(negative & (acc != SIGN64), -acc, acc), out_dtype)
    data = torch.where(valid, data, torch.zeros((), dtype=data.dtype, device=data.device))

    if ansi_mode:
        _validate_ansi(valid, col)
    return Column(out_dtype, data=data, validity=valid)


def _validate_ansi(valid: torch.Tensor, source: Column) -> None:
    """Raise CastError for the first newly invalid row
    (cast_string.cu:594-627). ANSI mode reads one flag back from the
    device; the row and its string only when it is set."""
    newly_bad = (~valid) & source.valid_mask()
    if bool(newly_bad.any()):
        row = int(torch.argmax(newly_bad.to(torch.uint8)))
        lo, hi = (int(x) for x in source.offsets[row:row + 2].cpu())
        s = source.chars[lo:hi].cpu().numpy().tobytes().decode("utf-8", "replace")
        raise CastError(row, s)


def string_to_decimal(col: Column, ansi_mode: bool, precision: int, scale: int) -> Column:
    """String column -> decimal column (``cast_decimal``); here so that the
    public surface matches CastStrings.java (toInteger/toDecimal)."""
    from . import cast_decimal

    return cast_decimal.string_to_decimal(col, ansi_mode, precision, scale)
