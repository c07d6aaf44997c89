"""u32 word planes <-> u8 byte planes (port of the JAX package's
``ops/ragged_bytes.py``, fixed-width part).

``expand_u32_planes`` (B6) and ``pack_u8_planes`` (B7) are the byte-plane
transposes the fixed-width JCUDF transcode runs on: on a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/planes.cu``, on a CPU
tensor it runs the plain PyTorch version beside it. ``u32_rows_to_u8_flat``
and ``flat_u8_to_u32`` follow the reference's kernel branch (transpose ->
plane kernel -> transpose) for inputs of at least 8 rows / 128 words.

32-bit words are carried in int32 lanes holding the u32 bits (see
``uword``); byte planes are uint8.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = [
    "expand_u32_planes",
    "expand_u32_planes_plain",
    "pack_u8_planes",
    "pack_u8_planes_plain",
    "u32_rows_to_u8_flat",
    "flat_u8_to_u32",
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
