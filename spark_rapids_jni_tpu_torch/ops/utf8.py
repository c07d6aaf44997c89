"""Vectorized UTF-8 codec: padded byte matrices <-> codepoint matrices
(port of the JAX package's ``ops/utf8.py``).

The regex and Unicode-case tiers work on codepoints, not bytes: '.'
matches one character, character classes are codepoint ranges and case
mapping is a codepoint relation. This module turns the string tier's
padded [N, L] uint8 matrices (``strings.to_padded``) into padded [N, L]
int32 codepoint matrices and back, with whole-matrix tensor operations
and no per-string loop.

Malformed UTF-8 is garbage in, garbage out, exactly as in the reference:
a continuation byte without a lead is skipped, a truncated sequence takes
the bytes that follow it (or the row's last byte) as its continuation,
and bytes 0xF8-0xFF decode as 4-byte leads clamped to U+10FFFF.

Every running sum along the char axis is ``rowscan.cumsum_rows`` (exact:
each sum is at most 4L), and every scatter is an int32 ``scatter_add_``
into a zeroed matrix: the reference's clipped indices collide, and only
an accumulating scatter gives the same result on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..columnar.column import resolve_device
from .rowscan import cumsum_rows

__all__ = ["decode_padded", "encode_padded", "utf8_nbytes", "case_table"]

MAX_CODEPOINT = 0x10FFFF


def _take_right(b: torch.Tensor, k: int) -> torch.Tensor:
    """``b[:, clip(j + k, 0, L - 1)]`` for every column j: the matrix
    shifted left by k columns, the last column repeated past the end."""
    L = b.shape[1]
    if k >= L:
        return b[:, L - 1:].expand(-1, L)
    return torch.cat([b[:, k:], b[:, L - 1:].expand(-1, k)], dim=1)


def decode_padded(padded: torch.Tensor, lens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, L] uint8 + [N] byte lengths -> (cp [N, L] int32 left-compacted,
    cp_lens [N] int32, byte_off [N, L+1] int32).

    ``cp[i, k]`` is the k-th codepoint of row i (positions >= cp_lens[i]
    are 0). ``byte_off[i, k]`` is the byte offset where codepoint k
    starts; entries at and after cp_lens[i] equal the row's byte length,
    so a codepoint span [a, b) maps to the byte span
    [byte_off[i, a], byte_off[i, b]).
    """
    n, L = padded.shape
    dev = padded.device
    if n == 0 or L == 0:
        w = max(L, 1)
        return (torch.zeros((n, w), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.zeros((n, w + 1), dtype=torch.int32, device=dev))

    b = padded.to(torch.int32)
    j = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    inb = j < lens[:, None]
    lead = inb & ((b & 0xC0) != 0x80)

    b1, b2, b3 = (_take_right(b, k) & 0x3F for k in (1, 2, 3))
    cp2 = ((b & 0x1F) << 6) | b1
    cp3 = ((b & 0x0F) << 12) | (b1 << 6) | b2
    cp4 = ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3
    cp = torch.where(b < 0x80, b, torch.where(b < 0xE0, cp2, torch.where(b < 0xF0, cp3, cp4)))
    cp = cp.clamp(0, MAX_CODEPOINT)

    # left-compact the leads: the k-th lead of row i lands in column k
    dest = (cumsum_rows(lead) - 1).clamp(0, L - 1)
    cp_lens = lead.sum(dim=1, dtype=torch.int32)
    cp_out = torch.zeros((n, L), dtype=torch.int32, device=dev).scatter_add_(
        1, dest, torch.where(lead, cp, 0))
    byte_pos = torch.zeros((n, L), dtype=torch.int32, device=dev).scatter_add_(
        1, dest, torch.where(lead, j, 0).expand(n, L))

    # byte_off: [N, L+1]; columns >= cp_len take the row's byte length
    col = torch.arange(L + 1, dtype=torch.int32, device=dev)[None, :]
    byte_off = torch.cat([byte_pos, torch.zeros((n, 1), dtype=torch.int32, device=dev)], dim=1)
    byte_off = torch.where(col >= cp_lens[:, None], lens[:, None].to(torch.int32), byte_off)
    return cp_out, cp_lens, byte_off


def utf8_nbytes(cp: torch.Tensor) -> torch.Tensor:
    """Encoded length (1..4) of each codepoint, int32."""
    return (1 + (cp >= 0x80).to(torch.int32) + (cp >= 0x800).to(torch.int32)
            + (cp >= 0x10000).to(torch.int32))


def encode_padded(cp: torch.Tensor, cp_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, Lc] int32 codepoints + [N] counts -> ([N, Lb] uint8, [N] int32
    byte lengths). Lb is the batch's longest encoding (one host sync, the
    output allocation's)."""
    n, Lc = cp.shape
    dev = cp.device
    k = torch.arange(Lc, dtype=torch.int32, device=dev)[None, :]
    inb = k < cp_lens[:, None]
    nb = torch.where(inb, utf8_nbytes(cp), 0)
    lens = nb.sum(dim=1, dtype=torch.int32)
    if n == 0:
        return torch.zeros((0, 1), dtype=torch.uint8, device=dev), lens
    Lb = max(int(lens.max()), 1)
    start = cumsum_rows(nb) - nb  # exclusive prefix

    b0 = torch.where(nb == 1, cp, torch.where(
        nb == 2, 0xC0 | (cp >> 6), torch.where(nb == 3, 0xE0 | (cp >> 12), 0xF0 | (cp >> 18))))
    b1 = torch.where(nb == 2, 0x80 | (cp & 0x3F), torch.where(
        nb == 3, 0x80 | ((cp >> 6) & 0x3F), 0x80 | ((cp >> 12) & 0x3F)))
    b2 = torch.where(nb == 3, 0x80 | (cp & 0x3F), 0x80 | ((cp >> 6) & 0x3F))
    b3 = 0x80 | (cp & 0x3F)

    out = torch.zeros((n, Lb), dtype=torch.int32, device=dev)
    for t, bt in enumerate((b0, b1, b2, b3)):
        keep = inb & (nb > t)
        out.scatter_add_(1, (start + t).clamp(0, Lb - 1), torch.where(keep, bt, 0).to(torch.int32))
    return out.to(torch.uint8), lens


def _build_case_table(upper: bool) -> np.ndarray:
    """BMP 1:1 case-map table (codepoint -> codepoint), from the running
    interpreter's Unicode data as in the reference. Multi-char special
    casings (ß -> SS, ...) and supplementary-plane pairs map to
    themselves, the 1:1 restriction of cudf's to_upper / to_lower."""
    tab = np.arange(0x10000, dtype=np.int32)
    for c in range(0x10000):
        if 0xD800 <= c <= 0xDFFF:
            continue
        m = chr(c).upper() if upper else chr(c).lower()
        if len(m) == 1 and ord(m) < 0x10000:
            tab[c] = ord(m)
    return tab


_CASE_HOST: dict = {}
_CASE_TABLES: dict = {}


def case_table(upper: bool, device=None) -> torch.Tensor:
    """The [0x10000] int32 case map on ``device`` (``None``: the card),
    built once per process and uploaded once per device."""
    dev = resolve_device(device)
    key = (bool(upper), str(dev))
    if key not in _CASE_TABLES:
        host = _CASE_HOST.get(bool(upper))
        if host is None:
            host = _CASE_HOST[bool(upper)] = _build_case_table(upper)
        _CASE_TABLES[key] = torch.from_numpy(host).to(dev)
    return _CASE_TABLES[key]
