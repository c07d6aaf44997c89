"""Native codecs of the port's readers: snappy, LZ4 block, LZO1X, zstd and
the parquet PLAIN BYTE_ARRAY length walk, the decoders the JAX package's
readers reach through its ``runtime`` (``runtime.py:238-330``).

They are the repo's own C++ decoders under ``native/src``, built with the
host C++ compiler at first use into ``build/torch_kernels/`` (``_build``'s
host library ``codecs``; nothing is built at import). zstd links the
system libzstd when the compiler finds ``zstd.h`` and the library; where
it does not, ``has_zstd()`` is False and ``zstd_decompress`` raises
naming the missing header. A library that cannot be built raises: no
codec falls back silently.

Outputs are ``memoryview``s over fresh uint8 buffers: slicing them copies
nothing and indexing gives Python ints, as with ``bytes``. ``CALLS``
counts the decodes each codec made in this process.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

__all__ = ["has_zstd", "snappy_uncompress", "lz4_decompress_block", "lzo1x_decompress",
           "zstd_frame_content_size", "zstd_decompress", "byte_array_lens", "CALLS"]

CALLS = {"snappy": 0, "lz4": 0, "lzo": 0, "zstd": 0, "byte_array_lens": 0}


def _lib():
    return _build.library("codecs")


def _src(data):
    """(keep-alive array, pointer) of a bytes-like input."""
    arr = np.frombuffer(data, np.uint8)
    return arr, ctypes.c_void_p(arr.ctypes.data if arr.size else 0)


def _fail(lib, what: str):
    msg = lib.codecs_last_error().decode("utf-8", "replace")
    raise RuntimeError(f"native codec error ({what}): {msg}")


def has_zstd() -> bool:
    """Whether the codec library was built with libzstd."""
    return bool(_lib().codecs_has_zstd())


def _missing_zstd() -> RuntimeError:
    _, log = _build.zstd_probe()
    first = log.splitlines()[0] if log else "no compiler output"
    return RuntimeError("zstd pages need zstd.h and libzstd, which the host C++ compiler did not "
                        f"find when the codec library was built: {first}")


def snappy_uncompress(data, uncompressed_size=None) -> memoryview:
    """One raw snappy block; its length comes from the block's preamble
    and, when given, must equal ``uncompressed_size``."""
    lib = _lib()
    keep, src = _src(data)
    n = lib.codecs_snappy_length(src, keep.size)
    if n < 0:
        _fail(lib, "snappy")
    if uncompressed_size is not None and n != uncompressed_size:
        raise RuntimeError(f"native codec error (snappy): the block holds {n} bytes, the page "
                           f"header says {uncompressed_size}")
    out = np.empty(n, np.uint8)
    if lib.codecs_snappy(src, keep.size, ctypes.c_void_p(out.ctypes.data), n) < 0:
        _fail(lib, "snappy")
    CALLS["snappy"] += 1
    return memoryview(out)


def _bounded(fn_name: str, what: str, data, dst_capacity: int) -> memoryview:
    lib = _lib()
    keep, src = _src(data)
    out = np.empty(max(dst_capacity, 1), np.uint8)
    n = getattr(lib, fn_name)(src, keep.size, ctypes.c_void_p(out.ctypes.data), out.size)
    if n < 0:
        _fail(lib, what)
    CALLS[what] += 1
    return memoryview(out)[:n]


def lz4_decompress_block(data, dst_capacity: int) -> memoryview:
    """One LZ4 block of at most ``dst_capacity`` bytes."""
    return _bounded("codecs_lz4_block", "lz4", data, dst_capacity)


def lzo1x_decompress(data, dst_capacity: int) -> memoryview:
    """One LZO1X stream of at most ``dst_capacity`` bytes."""
    return _bounded("codecs_lzo1x", "lzo", data, dst_capacity)


def zstd_frame_content_size(data) -> int:
    """Declared decompressed size of a zstd frame, or -1 if unknown."""
    if not has_zstd():
        raise _missing_zstd()
    lib = _lib()
    keep, src = _src(data)
    n = lib.codecs_zstd_content_size(src, keep.size)
    if n == -2:
        _fail(lib, "zstd")
    return int(n)


def zstd_decompress(data, uncompressed_size: int) -> memoryview:
    """One zstd frame of at most ``uncompressed_size`` bytes."""
    if not has_zstd():
        raise _missing_zstd()
    return _bounded("codecs_zstd", "zstd", data, uncompressed_size)


def byte_array_lens(page) -> np.ndarray:
    """The value lengths of a parquet PLAIN BYTE_ARRAY page ([u32 len]
    [bytes]...), int32; RuntimeError on a malformed page."""
    lib = _lib()
    keep, src = _src(page)
    cap = max(keep.size // 4 + 1, 1)
    out = np.empty(cap, np.int32)
    n = lib.codecs_byte_array_lens(src, keep.size, ctypes.c_void_p(out.ctypes.data), cap)
    if n < 0:
        raise RuntimeError("byte_array_lens: malformed page (truncated value or overflow)")
    CALLS["byte_array_lens"] += 1
    return out[:n].copy()
