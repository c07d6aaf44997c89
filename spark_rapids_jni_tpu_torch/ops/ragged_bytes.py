"""Byte movement for the JCUDF transcode (port of the JAX package's
``ops/ragged_bytes.py``).

Kernels, each a wrapper that launches the hand-written CUDA kernel on a
CUDA tensor and runs the plain PyTorch version beside it on a CPU tensor,
and counts its launches in ``.launches``:

- ``expand_u32_planes`` (B6) / ``pack_u8_planes`` (B7): byte-plane
  transposes of the fixed-width sections (``csrc/planes.cu``);
- ``rotl_take`` / ``rotl_take32`` (B8): per-row byte rotate-left, keep a
  prefix (``csrc/strings.cu``; both entry points launch one kernel and
  count in ``rotl_take.launches``);
- ``var_accumulate`` (B9): OR of K byte-shifted string matrices into the
  rows' variable sections (``csrc/strings.cu``);
- ``asm_epilogue`` (B10): the final row-blob tiles of ``assemble_rows``
  (``csrc/strings.cu``).

Every ragged access is decomposed as in the reference: a row gather of
fixed-width OVERLAPPING tiles (stride s, width 2s, so any window of at
most s + 1 bytes at an s-aligned tile lies in one tile) followed by a
per-row byte rotate or shift. The plain versions keep the reference's
arithmetic on u32 lanes: log2(W) conditional lane rolls plus one
sub-word funnel, with the shift by 32 guarded (a 32-bit shift by 32 is
not 0 in torch or C++). ``ragged_compact`` is the plain version of B5,
whose kernel wrapper lives in ``hopper_kernels``.

32-bit words are carried in int32 lanes holding the u32 bits (see
``uword``); byte matrices are uint8.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from . import uword

__all__ = [
    "expand_u32_planes",
    "expand_u32_planes_plain",
    "pack_u8_planes",
    "pack_u8_planes_plain",
    "u32_rows_to_u8_flat",
    "flat_u8_to_u32",
    "overlap_tiles",
    "overlap_tiles_u32",
    "byte_rotate_left",
    "byte_shift_right",
    "rotl_take",
    "rotl_take32",
    "rotl_take_plain",
    "var_accumulate",
    "var_accumulate_plain",
    "vacc_tile_plan",
    "asm_epilogue",
    "asm_epilogue_plain",
    "padded_extract",
    "assemble_rows",
    "build_pool32",
    "ragged_compact",
]


def _check_2d(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.dim() != 2 or x.dtype != dtype:
        raise ValueError(f"{what} expects a 2-D {dtype} tensor, got {tuple(x.shape)} {x.dtype}")


def expand_u32_planes_plain(x32: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: int32 [P, N] (u32 bits) -> uint8 [4P, N], byte
    k (little endian) of word (p, n) at row 4p + k."""
    p, n = x32.shape
    by = x32.contiguous().view(torch.uint8).view(p, n, 4)
    return by.permute(0, 2, 1).reshape(4 * p, n)


def pack_u8_planes_plain(x8: torch.Tensor) -> torch.Tensor:
    """Plain version of B7: uint8 [4P, N] -> int32 [P, N] (u32 bits)."""
    p4, n = x8.shape
    by = x8.reshape(p4 // 4, 4, n).permute(0, 2, 1).contiguous()  # [P, N, 4]
    return by.view(torch.int32).view(p4 // 4, n)


def expand_u32_planes(x32: torch.Tensor) -> torch.Tensor:
    """B6: int32 [P, N] (u32 bits) -> uint8 [4P, N]. Kernel on a CUDA
    tensor, plain version on a CPU tensor."""
    _check_2d(x32, torch.int32, "expand_u32_planes")
    if x32.device.type == "cpu":
        return expand_u32_planes_plain(x32)
    x32 = x32.contiguous()
    p, n = x32.shape
    out = torch.empty((4 * p, n), dtype=torch.uint8, device=x32.device)
    lib = _build.library("planes")
    rc = lib.expand_u32_planes_launch(
        x32.data_ptr(), out.data_ptr(), p, n, torch.cuda.current_stream(x32.device).cuda_stream
    )
    _build.check(rc, "expand_u32_planes")
    expand_u32_planes.launches += 1
    return out


expand_u32_planes.launches = 0


def pack_u8_planes(x8: torch.Tensor) -> torch.Tensor:
    """B7: uint8 [4P, N] -> int32 [P, N] (u32 bits), the inverse of
    ``expand_u32_planes``. Kernel on a CUDA tensor, plain version on a
    CPU tensor."""
    _check_2d(x8, torch.uint8, "pack_u8_planes")
    if x8.shape[0] % 4:
        raise ValueError(f"pack_u8_planes needs a multiple of 4 byte planes, got {x8.shape[0]}")
    if x8.device.type == "cpu":
        return pack_u8_planes_plain(x8)
    x8 = x8.contiguous()
    p4, n = x8.shape
    out = torch.empty((p4 // 4, n), dtype=torch.int32, device=x8.device)
    lib = _build.library("planes")
    rc = lib.pack_u8_planes_launch(
        x8.data_ptr(), out.data_ptr(), p4 // 4, n, torch.cuda.current_stream(x8.device).cuda_stream
    )
    _build.check(rc, "pack_u8_planes")
    pack_u8_planes.launches += 1
    return out


pack_u8_planes.launches = 0


def u32_rows_to_u8_flat(x32: torch.Tensor) -> torch.Tensor:
    """int32 [R, L] (u32 bits) -> uint8 [R * 4L] little-endian bytes.

    From 8 rows up: transpose -> B6 -> transpose, the reference's kernel
    branch; below that the bytes are a view."""
    r, lanes = x32.shape
    if r >= 8 and lanes >= 1:
        by = expand_u32_planes(x32.t().contiguous())  # [4L, R]
        return by.t().contiguous().reshape(-1)
    return x32.contiguous().view(torch.uint8).reshape(-1)


def flat_u8_to_u32(buf: torch.Tensor) -> torch.Tensor:
    """uint8 [L] (L % 4 == 0) -> int32 [L/4] little-endian words (u32 bits).

    From 128 words up: a [R, 512] view, transposed -> B7 -> transposed
    back, the reference's kernel branch; below that a view."""
    n4 = buf.shape[0] // 4
    if n4 >= 128:
        lanes = 512
        rows = (buf.shape[0] + lanes - 1) // lanes
        pad = rows * lanes - buf.shape[0]
        padded = torch.nn.functional.pad(buf, (0, pad)) if pad else buf
        m = padded.reshape(rows, lanes).t().contiguous()  # [512, R]: byte b of row r
        packed = pack_u8_planes(m)  # [128, R]: LE word j of row r
        return packed.t().contiguous().reshape(-1)[:n4]
    if n4 == 0:  # an empty byte view has no stride to reinterpret
        return torch.zeros((0,), dtype=torch.int32, device=buf.device)
    return buf[: 4 * n4].contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# plain lane arithmetic (the reference's ragged_bytes.py:66-143, 256-269)
# ---------------------------------------------------------------------------


def _pow2_ceil(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """uint8 [N, W] (W % 4 == 0) -> int32 [N, W/4] little-endian words."""
    n, w = x.shape
    x = x.contiguous()
    if x.storage_offset() % 4:  # a byte view of words must start on a word
        x = x.clone()
    return x.view(torch.int32).view(n, w // 4)


def _as_u8(x32: torch.Tensor) -> torch.Tensor:
    """int32 [N, L] -> uint8 [N, 4L] little-endian bytes."""
    n, lanes = x32.shape
    return x32.contiguous().view(torch.uint8).view(n, 4 * lanes)


def _split_shift(sh_bytes: torch.Tensor):
    """[N] byte shift -> ([N, 1] lane count, [N, 1] sub-word shift in
    bits, 0/8/16/24), both int64."""
    sh = sh_bytes.to(torch.int64).reshape(-1, 1)
    return sh // 4, (sh % 4) * 8


def _rotl_u32(x32: torch.Tensor, sl: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """Per-row byte rotate-left of int32 [B, L] u32 lanes: sl [B, 1] lane
    count in [0, L), rb [B, 1] sub-word shift in bits. Log2(L)
    conditional lane rolls, then one funnel with the next lane."""
    w = x32.shape[1]
    k = 1
    while k < w:
        rolled = torch.cat([x32[:, k:], x32[:, :k]], dim=1)
        x32 = torch.where((sl & k) != 0, rolled, x32)
        k *= 2
    nxt = torch.cat([x32[:, 1:], x32[:, :1]], dim=1)
    # rb == 0 would need a shift by 32: take x32 itself there
    combined = uword.shr_u32(x32, rb) | uword.shl_u32(nxt, (32 - rb) & 31)
    return torch.where(rb == 0, x32, combined)


def _shr_u32(x32: torch.Tensor, sl: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """Per-row byte shift-right (zero fill) of int32 [B, L] u32 lanes: sl
    [B, 1] lane count (>= L clears the row), rb [B, 1] sub-word shift in
    bits."""
    n, lanes = x32.shape
    ls = torch.clamp(sl, max=lanes)
    k = 1
    while k < lanes:
        shifted = torch.cat(
            [torch.zeros((n, k), dtype=x32.dtype, device=x32.device), x32[:, : lanes - k]], dim=1
        )
        x32 = torch.where((ls & k) != 0, shifted, x32)
        k *= 2
    x32 = torch.where(ls >= lanes, torch.zeros_like(x32), x32)
    prv = torch.cat([torch.zeros((n, 1), dtype=x32.dtype, device=x32.device), x32[:, :-1]], dim=1)
    combined = uword.shl_u32(x32, rb) | uword.shr_u32(prv, (32 - rb) & 31)
    return torch.where(rb == 0, x32, combined)


def byte_rotate_left(x: torch.Tensor, shift_bytes: torch.Tensor) -> torch.Tensor:
    """Rotate each row of uint8 [N, W] left by a per-row byte count in
    [0, W). W % 4 == 0 (u32 lanes; little-endian lane order is byte
    order)."""
    sl, rb = _split_shift(shift_bytes)
    return _as_u8(_rotl_u32(_as_u32(x), sl, rb))


def byte_shift_right(x: torch.Tensor, shift_bytes: torch.Tensor) -> torch.Tensor:
    """Shift each row of uint8 [N, W] right by a per-row byte count >= 0,
    zero-filling on the left (amounts >= W clear the row). W % 4 == 0."""
    sl, rb = _split_shift(torch.clamp(shift_bytes.to(torch.int64), max=x.shape[1]))
    return _as_u8(_shr_u32(_as_u32(x), sl, rb))


def _padded(buf: torch.Tensor, nbytes: int) -> torch.Tensor:
    padded = torch.zeros((nbytes,), dtype=torch.uint8, device=buf.device)
    padded[: buf.shape[0]] = buf
    return padded


def overlap_tiles(buf: torch.Tensor, stride: int, width: int, rows: Optional[int] = None
                  ) -> torch.Tensor:
    """uint8 [L] -> [rows, width] (rows = ceil(L/stride), at least 1, by
    default) where row w is buf[w*stride : w*stride + width], zero past
    the end. A read-only overlapping view of one zero-padded copy of
    ``buf``: nothing of width/stride size is materialized until a caller
    gathers rows of it."""
    if width % stride != 0:
        raise ValueError("width must be a multiple of stride")
    if rows is None:
        rows = max((buf.shape[0] + stride - 1) // stride, 1)
    return _padded(buf, rows * stride + width).as_strided((rows, width), (stride, 1))


def overlap_tiles_u32(buf: torch.Tensor, stride: int, width: int, rows: Optional[int] = None
                      ) -> torch.Tensor:
    """``overlap_tiles`` in u32 lanes: int32 [rows, width/4] where row w
    covers buf bytes [w*stride, w*stride + width). stride and width are
    multiples of 4."""
    if width % stride != 0 or stride % 4 != 0:
        raise ValueError("width must be a multiple of stride; stride of 4")
    if rows is None:
        rows = max((buf.shape[0] + stride - 1) // stride, 1)
    padded = _padded(buf, rows * stride + width)
    return padded.view(torch.int32).as_strided((rows, width // 4), (stride // 4, 1))


# ---------------------------------------------------------------------------
# B8: rotl_take / rotl_take32
# ---------------------------------------------------------------------------


def rotl_take_plain(x32: torch.Tensor, shift_bytes: torch.Tensor, out_w: int) -> torch.Tensor:
    """Plain version of B8: int32 [N, W/4] u32 lanes rotated left by
    ``shift_bytes`` [N] in [0, W), first ``out_w`` bytes as uint8
    [N, out_w]."""
    return byte_rotate_left(_as_u8(x32), shift_bytes)[:, :out_w]


def _check_rotl(x32: torch.Tensor, shift_bytes: torch.Tensor, out_w: int) -> None:
    if x32.dim() != 2 or x32.dtype != torch.int32:
        raise ValueError(f"rotl_take expects 2-D u32 lanes, got {tuple(x32.shape)} {x32.dtype}")
    if out_w % 4 or not 0 <= out_w <= 4 * x32.shape[1]:
        raise ValueError(f"out_w must be a multiple of 4 within the row, got {out_w}")
    if shift_bytes.shape != (x32.shape[0],) or shift_bytes.device != x32.device:
        raise ValueError("shift_bytes must be [N] on the rows' device")


def _rotl_take(x32: torch.Tensor, shift_bytes: torch.Tensor, out_w: int) -> torch.Tensor:
    _check_rotl(x32, shift_bytes, out_w)
    if x32.device.type == "cpu":
        return rotl_take_plain(x32, shift_bytes, out_w)
    x32 = x32.contiguous()
    sh = shift_bytes.to(torch.int32).contiguous()
    n, lanes = x32.shape
    out = torch.empty((n, out_w // 4), dtype=torch.int32, device=x32.device)
    if n and out_w:
        rc = _build.library("strings").rotl_take_launch(
            x32.data_ptr(), sh.data_ptr(), out.data_ptr(), n, lanes, out_w // 4, _stream(x32)
        )
        _build.check(rc, "rotl_take")
        rotl_take.launches += 1
    return out.view(torch.uint8).view(n, out_w)


def rotl_take(x: torch.Tensor, shift_bytes: torch.Tensor, out_w: int) -> torch.Tensor:
    """B8: ``byte_rotate_left(x, shift_bytes)[:, :out_w]`` for uint8
    [N, W] (W % 4 == 0, shifts in [0, W)); returns uint8 [N, out_w].
    Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if x.dim() != 2 or x.dtype != torch.uint8 or x.shape[1] % 4:
        raise ValueError(f"rotl_take expects uint8 [N, W] with W % 4 == 0, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return _rotl_take(_as_u32(x), shift_bytes, out_w)


def rotl_take32(x32: torch.Tensor, shift_bytes: torch.Tensor, out_w: int) -> torch.Tensor:
    """B8 on u32 lanes: int32 [N, W/4] rotated left by ``shift_bytes``
    bytes, first ``out_w`` bytes as uint8 [N, out_w]. The same kernel as
    ``rotl_take``, counted in ``rotl_take.launches``."""
    return _rotl_take(x32, shift_bytes, out_w)


rotl_take.launches = 0


# ---------------------------------------------------------------------------
# B9: var_accumulate
# ---------------------------------------------------------------------------


def _check_vacc(p_mats: Sequence[torch.Tensor], shifts: Sequence[torch.Tensor], maxvar: int) -> int:
    if not p_mats or len(p_mats) != len(shifts):
        raise ValueError("var_accumulate needs one shift vector per matrix, and at least one")
    if maxvar % 4:
        raise ValueError(f"maxvar must be a multiple of 4, got {maxvar}")
    n = p_mats[0].shape[0]
    dev = p_mats[0].device
    for p, s in zip(p_mats, shifts):
        if p.dim() != 2 or p.dtype != torch.uint8 or p.shape[1] % 4 or p.shape[1] > maxvar:
            raise ValueError(f"each matrix must be uint8 [N, L] with L % 4 == 0 and L <= {maxvar}, "
                             f"got {tuple(p.shape)} {p.dtype}")
        if p.shape[0] != n or s.shape != (n,) or p.device != dev or s.device != dev:
            raise ValueError("matrices and shifts must share N rows and one device")
    return n


def var_accumulate_plain(p_mats, shifts, maxvar: int) -> torch.Tensor:
    """Plain version of B9: OR over k of byte_shift_right(pad(p_k, maxvar),
    s_k), as int32 [N, maxvar/4] u32 lanes. Strings of one row are
    disjoint, so the OR places them."""
    n = _check_vacc(p_mats, shifts, maxvar)
    v = torch.zeros((n, maxvar), dtype=torch.uint8, device=p_mats[0].device)
    for p, s in zip(p_mats, shifts):
        if p.shape[1] < maxvar:
            p = torch.nn.functional.pad(p, (0, maxvar - p.shape[1]))
        v |= byte_shift_right(p, s)
    return _as_u32(v)


# B9's shared-memory tile: at most _VACC_TILE_WORDS words (16 KB) and
# _VACC_TILE_ROWS rows a block; up to _VACC_BY_VALUE matrices travel in the
# kernel's arguments (kVaccByValue in csrc/strings.cu), more in a device
# table
_VACC_TILE_WORDS = 4096
_VACC_TILE_ROWS = 64
_VACC_BY_VALUE = 32


def vacc_tile_plan(out_words: int, budget: int) -> Tuple[int, int]:
    """B9's tile of an int32 [N, out_words] output in at most ``budget``
    words (a positive multiple of 4): ``(tile_rows, tile_words)``. Whole
    rows where one row fits, at most ``_VACC_TILE_ROWS`` of them and a
    multiple of 4 where there are 4 or more (so a row slab of a 16-byte
    aligned matrix stays 16-byte aligned); else one row's range of
    ``budget`` words. The kernel launches a block for each tile,
    ``ceil(N / tile_rows) * ceil(out_words / tile_words)``."""
    if budget < 4 or budget % 4:
        raise ValueError(f"the tile budget must be a positive multiple of 4 words, got {budget}")
    if out_words < 1:
        raise ValueError(f"nothing to tile: out_words={out_words}")
    if out_words <= budget:
        rows = min(_VACC_TILE_ROWS, budget // out_words)
        if rows >= 4:
            rows -= rows % 4
        return rows, out_words
    return 1, budget


def var_accumulate(p_mats: Sequence[torch.Tensor], shifts: Sequence[torch.Tensor],
                   maxvar: int) -> torch.Tensor:
    """B9: the variable sections of N rows, int32 [N, maxvar/4] u32 lanes,
    from K uint8 [N, L_k] string matrices (L_k % 4 == 0, L_k <= maxvar)
    each shifted right by its [N] byte shifts (>= 0; >= maxvar clears) and
    OR-ed. Kernel on CUDA tensors, plain version on CPU tensors."""
    n = _check_vacc(p_mats, shifts, maxvar)
    dev = p_mats[0].device
    if dev.type == "cpu":
        return var_accumulate_plain(p_mats, shifts, maxvar)
    out = torch.empty((n, maxvar // 4), dtype=torch.int32, device=dev)
    if n and maxvar:
        keep, entries = [], []  # copies stay alive until the launch is queued
        for p, s in zip(p_mats, shifts):
            if p.data_ptr() % 4 or not p.is_contiguous():  # the kernel reads 4-byte words
                p = p.clone(memory_format=torch.contiguous_format)
            if s.dtype != torch.int32 or not s.is_contiguous():
                s = s.to(torch.int32).contiguous()
            keep += (p, s)
            entries += (p.data_ptr(), s.data_ptr(), p.shape[1] // 4)
        host = (ctypes.c_int64 * len(entries))(*entries)
        table = None
        if len(p_mats) > _VACC_BY_VALUE:
            table = torch.tensor(entries, dtype=torch.int64).to(dev)
        rows, words = vacc_tile_plan(maxvar // 4, _VACC_TILE_WORDS)
        rc = _build.library("strings").var_accumulate_launch(
            ctypes.addressof(host), None if table is None else table.data_ptr(), len(p_mats),
            out.data_ptr(), n, maxvar // 4, rows, words, _build.raw_stream(dev)
        )
        _build.check(rc, "var_accumulate")
        var_accumulate.launches += 1
    return out


var_accumulate.launches = 0


# ---------------------------------------------------------------------------
# B10: asm_epilogue
# ---------------------------------------------------------------------------


def _check_asm(a0, a1, c0, pmod, delta, alen, g_tile: int) -> int:
    if g_tile % 4 or g_tile < 4:
        raise ValueError(f"g_tile must be a positive multiple of 4, got {g_tile}")
    t = a0.shape[0]
    for m in (a0, a1, c0):
        if m.dtype != torch.int32 or tuple(m.shape) != (t, g_tile // 4) or m.device != a0.device:
            raise ValueError(f"tiles must be int32 [T, {g_tile // 4}] on one device")
    for v in (pmod, delta, alen):
        if v.shape != (t,) or v.device != a0.device:
            raise ValueError("pmod, delta and alen must be [T] on the tiles' device")
    return t


def asm_epilogue_plain(a0, a1, c0, pmod, delta, alen, g_tile: int) -> torch.Tensor:
    """Plain version of B10: per tile t, byte i < alen[t] of the output is
    byte i of concat(a0, a1) rotated left by pmod[t]; the others are
    byte i of c0 shifted right by delta[t] (zero fill). int32 [T, G/4]."""
    _check_asm(a0, a1, c0, pmod, delta, alen, g_tile)
    ga = _as_u8(torch.cat([a0, a1], dim=1))
    rot_a = byte_rotate_left(ga, pmod)[:, :g_tile]
    rot_c = byte_shift_right(_as_u8(c0), delta)
    take_a = torch.arange(g_tile, device=a0.device)[None, :] < alen.to(torch.int64)[:, None]
    return _as_u32(torch.where(take_a, rot_a, rot_c))


def asm_epilogue(a0, a1, c0, pmod, delta, alen, g_tile: int) -> torch.Tensor:
    """B10: the final tiles of ``assemble_rows`` (int32 [T, G/4] each of
    a0, a1, c0; [T] pmod in [0, 2G), delta >= 0, alen). Kernel on CUDA
    tensors, plain version on CPU tensors."""
    t = _check_asm(a0, a1, c0, pmod, delta, alen, g_tile)
    if a0.device.type == "cpu":
        return asm_epilogue_plain(a0, a1, c0, pmod, delta, alen, g_tile)
    a0, a1, c0 = a0.contiguous(), a1.contiguous(), c0.contiguous()
    pm, dl, al = (v.to(torch.int32).contiguous() for v in (pmod, delta, alen))
    out = torch.empty((t, g_tile // 4), dtype=torch.int32, device=a0.device)
    if t:
        rc = _build.library("strings").asm_epilogue_launch(
            a0.data_ptr(), a1.data_ptr(), c0.data_ptr(), pm.data_ptr(), dl.data_ptr(),
            al.data_ptr(), out.data_ptr(), t, g_tile // 4, _stream(out)
        )
        _build.check(rc, "asm_epilogue")
        asm_epilogue.launches += 1
    return out


asm_epilogue.launches = 0


# ---------------------------------------------------------------------------
# composites over the kernels
# ---------------------------------------------------------------------------


def padded_extract(pool: torch.Tensor, starts: torch.Tensor, max_len: int) -> torch.Tensor:
    """N windows of up to ``max_len`` bytes at byte offsets ``starts`` [N]
    in the uint8 ``pool`` -> uint8 [N, W] (W = pow2 >= max_len, at least
    4), row r's first max_len bytes being pool[starts[r] : starts[r] +
    max_len] (zero past the pool's end). Bytes past max_len are tile
    bytes: callers mask by true length.

    One overlapping-tile row gather (stride s = W, width 2s, so the
    window [starts % s, starts % s + max_len) lies in the gathered row)
    and one B8 rotate. From s = 512 up the tiles are u32 lanes
    (``rotl_take32``), below that bytes (``rotl_take``), as in the
    reference."""
    n = starts.shape[0]
    if max_len < 1:
        return torch.zeros((n, 4), dtype=torch.uint8, device=pool.device)
    stride = max(_pow2_ceil(max_len), 4)
    starts = starts.to(torch.int64)
    idx = torch.div(starts, stride, rounding_mode="floor")
    sh = starts - idx * stride
    # one tile past the last full one, so a window at the pool's very end
    # (an empty string there) reads zeros
    rows = pool.shape[0] // stride + 1
    if stride >= 512:
        g32 = overlap_tiles_u32(pool, stride, 2 * stride, rows).index_select(0, idx)
        return rotl_take32(g32, sh, stride)
    g = overlap_tiles(pool, stride, 2 * stride, rows).index_select(0, idx)
    return rotl_take(g, sh, stride)


def assemble_rows(rp_parts, sizes: torch.Tensor, offsets: torch.Tensor, total: int,
                  min_row_size: int) -> torch.Tensor:
    """Compact padded rows into the exact 8-aligned ragged blob (uint8
    [total]).

    ``rp_parts``: int32 [N, *] u32 lane parts concatenated logically
    (rows are byte sequences in little-endian lanes, bytes >= size_r
    zero); ``sizes`` [N] the 8-aligned row sizes, ``offsets`` [N+1] their
    cumsum, ``min_row_size`` a lower bound on them (>= 8).

    Destination-centric at tile granularity G = pow2 <= min_row_size, at
    most 256, so a destination tile straddles at most two rows: tile t
    takes G bytes at in-row offset p of its owner row r (two adjacent
    source tiles a0, a1) and the bytes past row r's end from row r+1's
    head (source tile c0). Owners come from one scatter-max and one
    cummax over tiles. The three tile gathers are row gathers of a free
    reshape of the padded rows; B10 combines them."""
    parts = list(rp_parts) if isinstance(rp_parts, (tuple, list)) else [rp_parts]
    n = parts[0].shape[0]
    dev = parts[0].device
    s4 = sum(p.shape[1] for p in parts)
    g_tile = max(min(_pow2_ceil(min_row_size + 1) // 2, 256), 8)
    g4 = g_tile // 4
    # pad S so any in-row window [p, p+2G) with p < size_r stays inside the
    # row's padded span, and keep G | S' so no tile mixes two rows
    s_pad4 = (s4 + g4 - 1) // g4 * g4 + 2 * g4
    rp = torch.cat(parts + [torch.zeros((n, s_pad4 - s4), dtype=torch.int32, device=dev)], dim=1)
    tiles = rp.view(n * (s_pad4 // g4), g4)
    s_pad = s_pad4 * 4

    tt = (total + g_tile - 1) // g_tile
    offsets = offsets.to(torch.int64)
    # tile t's owner is the max r with offsets[r] <= t*G: rows are at least
    # G bytes, so each row's first owned tile ceil(offsets[r]/G) is
    # distinct; scatter (r, offsets[r], offsets[r+1]) there and
    # forward-fill with cummax. Tiles past the end land in a spare slot.
    start_tile = torch.clamp(torch.div(offsets[:-1] + g_tile - 1, g_tile, rounding_mode="floor"),
                             max=tt)

    def fill(init: int, vals: torch.Tensor) -> torch.Tensor:
        slots = torch.full((tt + 1,), init, dtype=torch.int64, device=dev)
        slots.scatter_reduce_(0, start_tile, vals, reduce="amax")
        return torch.cummax(slots[:tt], dim=0).values

    r = torch.clamp(fill(-1, torch.arange(n, dtype=torch.int64, device=dev)), min=0)
    d_r = fill(0, offsets[:-1])
    d_next = fill(0, offsets[1:])

    t0 = torch.arange(tt, dtype=torch.int64, device=dev) * g_tile
    p = torch.clamp(t0 - d_r, 0, s_pad - 2 * g_tile)
    src_a = torch.div(r * s_pad + p, g_tile, rounding_mode="floor")
    src_c = torch.clamp(r + 1, max=n - 1) * (s_pad // g_tile)
    pmod = p % g_tile
    delta = torch.clamp(d_next - t0, 0, g_tile)
    alen = torch.clamp(d_next - d_r - p, 0, g_tile)
    out = asm_epilogue(tiles.index_select(0, src_a), tiles.index_select(0, src_a + 1),
                       tiles.index_select(0, src_c), pmod, delta, alen, g_tile)
    return u32_rows_to_u8_flat(out)[:total]


# ---------------------------------------------------------------------------
# ragged compaction, plain version of B5 (the reference's :589-715)
# ---------------------------------------------------------------------------


def build_pool32(pool: torch.Tensor) -> torch.Tensor:
    """uint8 [L] -> its little-endian int32 word view, padded two words
    past the end (``_funnel_u32`` reads word q + 1). Built once per pool
    and shared by every ``ragged_compact`` over it."""
    plen = int(pool.shape[0])
    pwords = (plen + 4) // 4 + 2
    padded = torch.zeros((pwords * 4,), dtype=torch.uint8, device=pool.device)
    padded[:plen] = pool
    return padded.view(torch.int32)


def _funnel_u32(p32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """u32 value (in int64) of pool bytes [s, s+4) for each byte address
    ``s`` [M] int64; ``p32`` extends one word past any s."""
    q = s >> 2
    g0 = uword.u32_to_i64(p32[q])
    g1 = uword.u32_to_i64(p32[q + 1])
    rb = (s & 3) * 8
    hi = torch.where(rb == 0, torch.zeros_like(g1), (g1 << ((32 - rb) & 31)) & uword.MASK32)
    return (g0 >> rb) | hi


def ragged_compact(pool: torch.Tensor, base: torch.Tensor, offs: torch.Tensor, total: int,
                   pool32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of B5, the dense ragged gather: out[offs[r] + j] =
    pool[base[r] + j] for j < offs[r+1] - offs[r]; uint8 [total].

    ``offs`` [N+1] is dense (cumsum of lengths, from 0); ``base`` [N] is
    nondecreasing over rows of nonzero length and rows do not overlap in
    the pool (base[r+1] >= base[r] + len[r]), as in every row blob and
    every padded matrix. Then c = base - offs[r] is nondecreasing, and
    each output word's OWNER (the row covering its first byte) comes from
    one scatter-max of c at each row's first whole word plus a cummax;
    the byte count the owner keeps is a scatter-min of the in-word row
    boundaries, and rows that start inside a word add their head bytes
    (at most 3, in disjoint byte lanes) with one scatter-add."""
    n = base.shape[0]
    if total == 0 or n == 0:
        return torch.zeros((0,), dtype=torch.uint8, device=pool.device)
    dev = pool.device
    base = base.to(torch.int64)
    offs = offs.to(torch.int64)
    lens = offs[1:] - offs[:-1]
    nw = (total + 3) // 4 + 1
    if pool32 is None:
        pool32 = build_pool32(pool)
    plen = int(pool.shape[0])

    nonzero = lens > 0
    widx = torch.where(nonzero, (offs[:-1] + 3) >> 2, nw)  # zero rows park off the end
    c_w = torch.zeros((nw + 1,), dtype=torch.int64, device=dev)
    c_w.scatter_reduce_(0, widx, base - offs[:-1], reduce="amax")
    c_w = torch.cummax(c_w[:nw], dim=0).values

    # every row boundary (and the final total) is an entry of offs
    bpos = offs & 3
    bidx = torch.where(bpos > 0, offs >> 2, nw)  # word-aligned boundaries need no mask
    nb = torch.full((nw + 1,), 4, dtype=torch.int64, device=dev)
    nb.scatter_reduce_(0, bidx, bpos, reduce="amin")
    nb = nb[:nw]

    w0 = torch.arange(nw, dtype=torch.int64, device=dev) * 4
    cand = _funnel_u32(pool32, torch.clamp(c_w + w0, 0, plen))
    keep = torch.where(nb >= 4, uword.MASK32, (1 << (nb * 8)) - 1)
    words = torch.cat([cand & keep, torch.zeros((1,), dtype=torch.int64, device=dev)])

    # head chunks: bytes [offs[r], min(offs[r+1], align4up(offs[r]))) of
    # each row land in its start word at byte offs[r] % 4
    x = offs[:-1]
    chunk = torch.clamp(torch.minimum(offs[1:], (x + 3) & ~3) - x, 0, 3)
    has = nonzero & (chunk > 0)
    hsrc = _funnel_u32(pool32, torch.clamp(base, 0, plen))
    contrib = (hsrc & ((1 << (chunk * 8)) - 1)) << ((x & 3) * 8)
    words.scatter_add_(0, torch.where(has, x >> 2, nw), torch.where(has, contrib, 0))
    return uword.to_signed_bits(words[:nw], 32).view(torch.uint8)[:total]
