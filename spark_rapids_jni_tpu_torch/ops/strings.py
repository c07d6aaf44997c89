"""String operator tier, cudf's strings surface (port of the JAX
package's ``ops/strings.py``).

Ragged STRING data (offsets + chars) is padded into an [N, L] byte
matrix (L = the longest string of the batch), operated on with
whole-matrix tensor operations, and compacted back into offsets + chars.
Both moves run hand-written kernels on CUDA tensors:

- ``to_padded`` is ``ragged_bytes.extract_strings_many`` (B8's kernel on
  the encode's path): one launch pads every column of the call;
- ``from_padded`` is B5's compaction (``hopper_kernels.
  ragged_compact_many``) of the flattened matrix, row r's bytes at r * L.

On CPU tensors both run their plain versions. A refused launch raises.

Ops: length, upper / lower (ASCII bytes or Unicode codepoints),
substring, concat / concat_ws, contains / startswith / endswith / instr
(literal patterns), strip. Null propagation follows Spark: null in, null
out. ``length`` and ``substring`` count bytes, as the reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import Column
from ..columnar import dtype as dt
from ..columnar.dtype import TypeId
from . import hopper_kernels, ragged_bytes
from .rowscan import cumsum_rows
from .utf8 import _take_right, case_table, decode_padded, encode_padded

__all__ = [
    "length",
    "upper",
    "lower",
    "substring",
    "concat",
    "concat_ws",
    "contains",
    "instr",
    "startswith",
    "endswith",
    "strip",
]


def _check_string(col: Column) -> None:
    if col.dtype.id != TypeId.STRING:
        raise ValueError("string op on non-string column")


def to_padded_many(cols: Sequence[Column]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``to_padded`` of columns of one row count, every column with
    characters padded in ONE ``extract_strings_many`` launch."""
    out: list = [None] * len(cols)
    live = []
    for k, col in enumerate(cols):
        _check_string(col)
        offs = col.offsets
        lens = (offs[1:] - offs[:-1]).to(torch.int32)
        n = len(col)
        if n == 0:
            out[k] = (torch.zeros((0, 1), dtype=torch.uint8, device=offs.device), lens)
            continue
        max_len = max(col.max_char_len, 1)
        if int(col.chars.shape[0]) == 0:  # every row empty (or null): nothing to gather
            out[k] = (torch.zeros((n, max_len), dtype=torch.uint8, device=offs.device), lens)
            continue
        live.append((k, lens, max_len))
    if live:
        mats = ragged_bytes.extract_strings_many(
            [cols[k].chars for k, _, _ in live], [cols[k].offsets[:-1] for k, _, _ in live],
            [lens for _, lens, _ in live], [(ml + 3) // 4 * 4 for _, _, ml in live])
        for (k, lens, ml), m in zip(live, mats):
            out[k] = (m[:, :ml], lens)
    return out


def to_padded(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged -> ([N, L] uint8 right-padded with 0, [N] int32 lengths),
    L = max(``col.max_char_len``, 1); a column of no rows gives a (0, 1)
    matrix."""
    return to_padded_many([col])[0]


def from_padded(padded: torch.Tensor, lens: torch.Tensor, validity=None) -> Column:
    """[N, L] bytes + [N] lengths -> ragged STRING column: B5's compaction
    of the flattened matrix, whose row bases r * L are monotone (the
    compaction's contract). One host sync: the chars' size."""
    dev = padded.device
    lens = lens.to(torch.int32)
    offs = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      torch.cumsum(lens, 0, dtype=torch.int32)])
    total = int(offs[-1])
    if total == 0:
        chars = torch.zeros((0,), dtype=torch.uint8, device=dev)
    else:
        n, width = padded.shape
        base = torch.arange(n, dtype=torch.int64, device=dev) * width
        chars = hopper_kernels.ragged_compact_many(padded.reshape(-1), [(base, offs, total)])[0]
    return Column(dt.STRING, validity=validity, offsets=offs, chars=chars)


def length(col: Column) -> Column:
    """Byte length per row (Spark length() on binary semantics)."""
    _check_string(col)
    lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int32)
    return Column(dt.INT32, data=lens, validity=col.validity)


def _case_map_ascii(col: Column, offset: int, lo: int, hi: int) -> Column:
    padded, lens = to_padded(col)
    in_range = (padded >= lo) & (padded <= hi)
    out = torch.where(in_range, padded + offset, padded)  # uint8: wraps like the reference
    return from_padded(out, lens, col.validity)


def _case_map_unicode(col: Column, to_upper: bool) -> Column:
    """UTF-8-aware 1:1 case map over codepoints (BMP table). Re-encodes,
    because a cased pair can change the UTF-8 length (U+023A <-> U+2C65 is
    2 against 3 bytes)."""
    padded, lens = to_padded(col)
    cp, cp_lens, _ = decode_padded(padded, lens)
    tab = case_table(to_upper, padded.device)
    mapped = torch.where(cp < 0x10000, tab[cp.clamp(0, 0xFFFF).long()], cp)
    out, out_lens = encode_padded(mapped, cp_lens)
    return from_padded(out, out_lens, col.validity)


def _is_ascii(col: Column) -> bool:
    if col.chars.shape[0] == 0:
        return True
    return bool((col.chars < 0x80).all())


def upper(col: Column) -> Column:
    """Spark upper(): Unicode 1:1 case map; a pure-ASCII batch takes the
    byte path (one host check, the same class of sync as the padded
    width)."""
    _check_string(col)
    if _is_ascii(col):
        return _case_map_ascii(col, -32 & 0xFF, ord("a"), ord("z"))
    return _case_map_unicode(col, to_upper=True)


def lower(col: Column) -> Column:
    _check_string(col)
    if _is_ascii(col):
        return _case_map_ascii(col, 32, ord("A"), ord("Z"))
    return _case_map_unicode(col, to_upper=False)


def _clip(x: torch.Tensor, lo, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with a tensor upper bound."""
    return torch.minimum(x.clamp(min=lo), hi)


def _take_cols(padded: torch.Tensor, begin: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
    """Row i's bytes [begin[i], begin[i] + out_lens[i]) moved to the row's
    start, 0 after them (the reference's clipped ``take_along_axis``)."""
    L = padded.shape[1]
    j = torch.arange(L, dtype=torch.int64, device=padded.device)[None, :]
    src = (begin.to(torch.int64)[:, None] + j).clamp(0, L - 1)
    return torch.where(j < out_lens[:, None], torch.gather(padded, 1, src), 0)


def substring(col: Column, start: int, slen: Optional[int] = None) -> Column:
    """Spark SUBSTRING semantics: 1-based start; 0 treated as 1; negative
    start counts from the end; slen None -> to end of string."""
    _check_string(col)
    padded, lens = to_padded(col)
    n = padded.shape[0]
    dev = padded.device
    # Spark UTF8String.substringSQL: the window [begin, begin+len) is
    # computed BEFORE clamping, so a negative start spends its length
    # budget off-string (substring('hello', -6, 3) == 'he', -10 -> '')
    if start > 0:
        begin_raw = torch.full((n,), start - 1, dtype=torch.int32, device=dev)
    elif start == 0:
        begin_raw = torch.zeros((n,), dtype=torch.int32, device=dev)
    else:
        begin_raw = lens + start
    end_raw = lens if slen is None else begin_raw + max(slen, 0)
    begin = _clip(begin_raw, 0, lens)
    end = _clip(end_raw, 0, lens)
    out_lens = (end - begin).clamp(min=0)
    return from_padded(_take_cols(padded, begin, out_lens), out_lens, col.validity)


def concat(cols: Sequence[Column], separator: bytes = b"", null_policy: str = "propagate"
           ) -> Column:
    """Row-wise concatenation with a scalar separator.

    ``null_policy`` selects between Spark's two operators, which differ
    only in null handling:

    - ``"propagate"``: Spark ``concat``; a null row in any input nulls
      the whole output row.
    - ``"skip"``: Spark ``concat_ws``; null inputs are skipped entirely
      (neither text nor a separator slot); the result is never null.
    """
    if null_policy not in ("propagate", "skip"):
        raise ValueError(f"unknown null_policy {null_policy!r}")
    cols = list(cols)
    if not cols:
        raise ValueError("concat needs at least one column")
    for c in cols:
        _check_string(c)
    parts = to_padded_many(cols)
    dev = parts[0][0].device
    sep = torch.tensor(list(separator), dtype=torch.int32, device=dev)
    m = len(separator)
    n = len(cols[0])

    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    if null_policy == "skip":
        kept = [ones if c.validity is None else c.validity for c in cols]
    else:
        # every input contributes text; nullness goes to the output validity
        kept = [ones] * len(cols)

    # per-row output length: kept parts + a separator before each kept
    # part that follows at least one earlier kept part
    out_lens = torch.zeros((n,), dtype=torch.int32, device=dev)
    emitted = torch.zeros((n,), dtype=torch.bool, device=dev)
    sep_present = []
    for k, (_, lens) in enumerate(parts):
        present = (emitted & kept[k]) if (k > 0 and m) else torch.zeros_like(emitted)
        sep_present.append(present)
        out_lens = out_lens + present.to(torch.int32) * m + torch.where(kept[k], lens, 0)
        emitted = emitted | kept[k]
    L = max(int(out_lens.max()) if n else 1, 1)

    # the parts land in disjoint byte ranges of each row, so an int32
    # accumulating scatter places them (the reference's OR of scatter-adds)
    out = torch.zeros((n, L), dtype=torch.int32, device=dev)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)

    def place(vals, eff_lens):
        src_j = torch.arange(vals.shape[1], dtype=torch.int64, device=dev)[None, :]
        keep = src_j < eff_lens[:, None]
        out.scatter_add_(1, (cursor[:, None] + src_j).clamp(0, L - 1),
                         torch.where(keep, vals.to(torch.int32), 0))

    for k, (padded, lens) in enumerate(parts):
        if k > 0 and m:
            sep_lens = torch.where(sep_present[k], m, 0).to(torch.int64)
            place(sep[None, :].expand(n, m), sep_lens)
            cursor = cursor + sep_lens
        eff_lens = torch.where(kept[k], lens, 0).to(torch.int64)
        place(padded, eff_lens)
        cursor = cursor + eff_lens

    validity = None
    if null_policy == "propagate":
        masks = [c.validity for c in cols if c.validity is not None]
        if masks:
            validity = masks[0]
            for v in masks[1:]:
                validity = validity & v
    return from_padded(out.to(torch.uint8), out_lens, validity)


def concat_ws(cols: Sequence[Column], separator: bytes) -> Column:
    """Spark ``concat_ws``: null inputs skipped, never-null output."""
    return concat(cols, separator, null_policy="skip")


def _match_every(padded: torch.Tensor, lens: torch.Tensor, pattern: bytes) -> torch.Tensor:
    """[N, L] bool: the pattern matches at byte position j (the
    reference's ``_match_at`` over every position)."""
    n, L = padded.shape
    if len(pattern) == 0:
        return torch.ones((n, L), dtype=torch.bool, device=padded.device)
    ok = torch.ones((n, L), dtype=torch.bool, device=padded.device)
    for t, byte in enumerate(pattern):
        ok = ok & (_take_right(padded, t) == byte)
    pos = torch.arange(L, dtype=torch.int32, device=padded.device)[None, :]
    return ok & (pos + len(pattern) <= lens[:, None])


def _match_at(padded: torch.Tensor, lens: torch.Tensor, pattern: bytes, pos: torch.Tensor
              ) -> torch.Tensor:
    """[N] bool: the pattern matches at byte position pos[i] of row i."""
    n, L = padded.shape
    if len(pattern) == 0:
        return torch.ones((n,), dtype=torch.bool, device=padded.device)
    pos = pos.to(torch.int64)
    ok = torch.ones((n,), dtype=torch.bool, device=padded.device)
    for t, byte in enumerate(pattern):
        ok = ok & (torch.gather(padded, 1, (pos + t).clamp(0, L - 1)[:, None])[:, 0] == byte)
    return ok & (pos + len(pattern) <= lens)


def _bool_col(data: torch.Tensor, validity) -> Column:
    return Column(dt.BOOL8, data=data.to(torch.uint8), validity=validity)


def contains(col: Column, pattern: bytes) -> Column:
    """Literal substring search (Spark Contains)."""
    _check_string(col)
    padded, lens = to_padded(col)
    return _bool_col(_match_every(padded, lens, pattern).any(dim=1), col.validity)


def startswith(col: Column, pattern: bytes) -> Column:
    _check_string(col)
    padded, lens = to_padded(col)
    return _bool_col(_match_at(padded, lens, pattern, torch.zeros_like(lens)), col.validity)


def endswith(col: Column, pattern: bytes) -> Column:
    _check_string(col)
    padded, lens = to_padded(col)
    pos = (lens - len(pattern)).clamp(min=0)
    return _bool_col(_match_at(padded, lens, pattern, pos) & (lens >= len(pattern)), col.validity)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Per row, the first column where ``mask`` holds (0 where none does,
    as ``jnp.argmax`` of an all-false row)."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def strip(col: Column) -> Column:
    """Trim ASCII spaces both sides (Spark trim)."""
    _check_string(col)
    padded, lens = to_padded(col)
    L = padded.shape[1]
    j = torch.arange(L, dtype=torch.int32, device=padded.device)[None, :]
    non_space = (padded != ord(" ")) & (j < lens[:, None])
    any_ns = non_space.any(dim=1)
    first_ns = _first_true(non_space)
    last_ns = L - 1 - _first_true(non_space.flip(1))
    begin = torch.where(any_ns, first_ns, 0)
    out_lens = torch.where(any_ns, last_ns - first_ns + 1, 0).to(torch.int32)
    return from_padded(_take_cols(padded, begin, out_lens), out_lens, col.validity)


def instr(col: Column, pattern: bytes) -> Column:
    """Spark instr/locate: 1-based CHARACTER position of the first literal
    occurrence, 0 when absent (empty pattern -> 1). A valid UTF-8 needle
    matches only at character boundaries, so the byte hit converts to a
    character index by counting the lead bytes before it."""
    _check_string(col)
    padded, lens = to_padded(col)
    n, L = padded.shape
    hits = _match_every(padded, lens, pattern)
    any_hit = hits.any(dim=1)
    first = _first_true(hits)
    # byte position -> character position: lead (non-continuation) bytes
    # strictly before the hit
    pos = torch.arange(L, dtype=torch.int32, device=padded.device)[None, :]
    lead = ((padded & 0xC0) != 0x80) & (pos < lens[:, None])
    cum = cumsum_rows(lead)
    chars_before = torch.where(
        first > 0, torch.gather(cum, 1, (first - 1).clamp(0, L - 1)[:, None])[:, 0], 0)
    out = torch.where(any_hit, chars_before + 1, 0).to(torch.int32)
    if len(pattern) == 0:
        out = torch.ones((n,), dtype=torch.int32, device=padded.device)
    return Column(dt.INT32, data=out, validity=col.validity)
