"""ctypes bindings to the native runtime (``libsrjt.so``): the port of
the JAX package's ``runtime.py``.

The library is found by ``SRJTORCH_NATIVE_LIB``, then
``native/build/libsrjt.so`` (the CMake build), then the port's own build
of the same sources (``_build.build_native_runtime``: native/src, read
and never edited, compiled by the host C++ compiler into the git-ignored
build directory; ``build_native()`` runs it). ``native_available()`` is
False until one of them exists.

The handle-based C ABI is exposed as Python classes with explicit
``close()`` ownership: ``NativeParquetFooter``, ``NativeHostBuffer``,
``NativeColumn`` / ``NativeTable`` (``from_python`` / ``to_python``
over the port's columns), the codecs, and the native cast, Z-order and
decimal calls.

``device_connect`` spawns the device sidecar worker through the native
client. That client execs ``<python> -m spark_rapids_jni_tpu.sidecar
--socket P``; the port passes a generated launcher as ``<python>``,
which checks those two arguments and execs ``python -m
spark_rapids_jni_tpu_torch.sidecar --device <device> --socket P`` (so
the JAX package is never started). ``stats_report`` assembles every
observability tier in one snapshot and ``explain_last`` renders the
worst recent traced query.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

from .io.parquet_footer import StructElement, flatten_schema
from .sidecar import _host
from .utils import knobs

__all__ = [
    "native_available",
    "native_lib",
    "live_handles",
    "stats_report",
    "device_stats",
    "snappy_uncompress",
    "lz4_decompress_block",
    "lzo1x_decompress",
    "zstd_decompress",
    "zstd_frame_content_size",
    "NativeParquetFooter",
    "NativeHostBuffer",
]


def snappy_uncompress(data: bytes, expected_size: Optional[int] = None) -> bytes:
    """Decompress a snappy block via the native codec tier (nvcomp
    analog). Raises RuntimeError if the native library is missing or the
    stream is malformed."""
    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/)")
    n = lib.srjt_snappy_uncompressed_length(data, len(data))
    if n < 0:
        _raise_last(lib)
    if expected_size is not None and n != expected_size:
        raise RuntimeError(f"snappy: preamble size {n} != expected {expected_size}")
    if expected_size is None and n > max(len(data), 1) * 128:
        # the format can't expand anywhere near this much: an attacker-
        # controlled preamble must not drive a giant allocation
        raise RuntimeError(f"snappy: implausible uncompressed size {n}")
    out = ctypes.create_string_buffer(int(n))
    if lib.srjt_snappy_uncompress(data, len(data), out, n) != 0:
        _raise_last(lib)
    return out.raw

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _candidate_paths() -> List[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    cands = []
    env = knobs.get_str("SRJTORCH_NATIVE_LIB")
    if env:
        cands.append(env)
    cands.append(os.path.join(repo, "native", "build", "libsrjt.so"))  # the CMake build
    from . import _build

    cands.append(str(_build.native_runtime_path()))  # the port's own build
    return cands


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.srjt_last_error.restype = ctypes.c_char_p
    lib.srjt_live_handles.restype = ctypes.c_int64
    lib.srjt_footer_read_and_filter.restype = ctypes.c_int64
    lib.srjt_footer_read_and_filter.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.srjt_footer_num_rows.restype = ctypes.c_int64
    lib.srjt_footer_num_rows.argtypes = [ctypes.c_int64]
    lib.srjt_footer_num_columns.restype = ctypes.c_int32
    lib.srjt_footer_num_columns.argtypes = [ctypes.c_int64]
    lib.srjt_footer_serialize.restype = ctypes.c_int64
    lib.srjt_footer_serialize.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.srjt_blob_copy.restype = ctypes.c_int32
    lib.srjt_blob_copy.argtypes = [ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.srjt_blob_free.argtypes = [ctypes.c_int64]
    lib.srjt_footer_close.argtypes = [ctypes.c_int64]
    lib.srjt_host_alloc.restype = ctypes.c_int64
    lib.srjt_host_alloc.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.srjt_host_ptr.restype = ctypes.c_void_p
    lib.srjt_host_ptr.argtypes = [ctypes.c_int64]
    lib.srjt_host_size.restype = ctypes.c_int64
    lib.srjt_host_size.argtypes = [ctypes.c_int64]
    lib.srjt_host_free.argtypes = [ctypes.c_int64]
    lib.srjt_host_bytes_in_use.restype = ctypes.c_int64
    lib.srjt_snappy_uncompressed_length.restype = ctypes.c_int64
    lib.srjt_snappy_uncompressed_length.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.srjt_snappy_uncompress.restype = ctypes.c_int32
    lib.srjt_snappy_uncompress.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    # columnar engine
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.srjt_column_create.restype = ctypes.c_int64
    lib.srjt_column_create.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        u8p, ctypes.c_int64, u8p, i32p, u8p, ctypes.c_int64,
    ]
    for name, res in [
        ("srjt_column_type", ctypes.c_int32),
        ("srjt_column_scale", ctypes.c_int32),
        ("srjt_column_size", ctypes.c_int64),
        ("srjt_column_data_bytes", ctypes.c_int64),
        ("srjt_column_chars_bytes", ctypes.c_int64),
        ("srjt_column_has_validity", ctypes.c_int32),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_int64]
    for name, ptr_t in [
        ("srjt_column_copy_data", u8p),
        ("srjt_column_copy_validity", u8p),
        ("srjt_column_copy_offsets", i32p),
        ("srjt_column_copy_chars", u8p),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_int64, ptr_t, ctypes.c_int64]
    lib.srjt_column_close.argtypes = [ctypes.c_int64]
    lib.srjt_table_create.restype = ctypes.c_int64
    lib.srjt_table_create.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int32]
    lib.srjt_table_num_columns.restype = ctypes.c_int32
    lib.srjt_table_num_columns.argtypes = [ctypes.c_int64]
    lib.srjt_table_num_rows.restype = ctypes.c_int64
    lib.srjt_table_num_rows.argtypes = [ctypes.c_int64]
    lib.srjt_table_column.restype = ctypes.c_int64
    lib.srjt_table_column.argtypes = [ctypes.c_int64, ctypes.c_int32]
    lib.srjt_table_close.argtypes = [ctypes.c_int64]
    lib.srjt_convert_to_rows.restype = ctypes.c_int64
    lib.srjt_convert_to_rows.argtypes = [ctypes.c_int64]
    lib.srjt_convert_to_rows_batched.restype = ctypes.c_int32
    lib.srjt_convert_to_rows_batched.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
    ]
    lib.srjt_convert_from_rows.restype = ctypes.c_int64
    lib.srjt_convert_from_rows.argtypes = [ctypes.c_int64, i32p, i32p, ctypes.c_int32]
    lib.srjt_cast_string_to_integer.restype = ctypes.c_int64
    lib.srjt_cast_string_to_integer.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.srjt_cast_string_to_decimal.restype = ctypes.c_int64
    lib.srjt_cast_string_to_decimal.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.srjt_last_cast_error_pending.restype = ctypes.c_int32
    lib.srjt_last_cast_row.restype = ctypes.c_int64
    lib.srjt_last_cast_string.restype = ctypes.c_char_p
    lib.srjt_zorder_interleave_bits.restype = ctypes.c_int64
    lib.srjt_zorder_interleave_bits.argtypes = [ctypes.c_int64]
    lib.srjt_live_columnar_handles.restype = ctypes.c_int64
    lib.srjt_multiply_decimal128.restype = ctypes.c_int64
    lib.srjt_multiply_decimal128.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
    lib.srjt_divide_decimal128.restype = ctypes.c_int64
    lib.srjt_divide_decimal128.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
    lib.srjt_byte_array_lens.restype = ctypes.c_int64
    lib.srjt_byte_array_lens.argtypes = [u8p, ctypes.c_int64, i32p, ctypes.c_int64]
    lib.srjt_lz4_decompress_block.restype = ctypes.c_int64
    lib.srjt_lz4_decompress_block.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.srjt_lzo1x_decompress.restype = ctypes.c_int64
    lib.srjt_lzo1x_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.srjt_zstd_decompress.restype = ctypes.c_int64
    lib.srjt_zstd_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.srjt_zstd_frame_content_size.restype = ctypes.c_int64
    lib.srjt_zstd_frame_content_size.argtypes = [u8p, ctypes.c_int64]
    lib.srjt_faultinj_configure.restype = ctypes.c_int32
    lib.srjt_faultinj_configure.argtypes = [ctypes.c_char_p]
    lib.srjt_faultinj_disable.restype = None
    lib.srjt_faultinj_enabled.restype = ctypes.c_int32
    lib.srjt_device_connect.restype = ctypes.c_int32
    lib.srjt_device_connect.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.srjt_device_platform.restype = ctypes.c_char_p
    lib.srjt_device_shutdown.restype = None
    try:
        lib.srjt_device_heartbeat.restype = ctypes.c_int32
    except AttributeError:
        # a stale libsrjt.so predating the supervision tier: the rest
        # of the ABI keeps working; device_heartbeat() reports False
        pass
    try:
        lib.srjt_device_stats_json.restype = ctypes.c_char_p
    except AttributeError:
        # pre-metrics .so: device_stats() reports None
        pass
    lib.srjt_device_groupby_sum.restype = ctypes.c_int32
    lib.srjt_device_groupby_sum.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def native_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        for path in _candidate_paths():
            if os.path.exists(path):
                try:
                    _LIB = _bind(ctypes.CDLL(path))
                    break
                except (OSError, AttributeError):
                    # unloadable, or a stale build missing newer symbols:
                    # fall through to the next candidate / pure-Python path
                    _LIB = None
                    continue
        return _LIB


def native_available() -> bool:
    return native_lib() is not None


def build_native() -> Optional[ctypes.CDLL]:
    """Build ``libsrjt.so`` from native/src when no candidate exists (the
    compiler's error propagates as RuntimeError), then load it."""
    global _TRIED
    from . import _build

    if native_lib() is None:
        _build.build_native_runtime()
        with _LOCK:
            _TRIED = False
    return native_lib()


def lz4_decompress_block(data: bytes, dst_capacity: int) -> bytes:
    """Decompress one LZ4 block via the native codec tier; the exact
    output size need not be known (ORC/parquet only bound it)."""
    import numpy as np

    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/)")
    out = np.empty(max(dst_capacity, 1), np.uint8)
    src = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    n = lib.srjt_lz4_decompress_block(
        src, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out)
    )
    if n < 0:
        _raise_last(lib)
    return out[:n].tobytes()


def lzo1x_decompress(data: bytes, dst_capacity: int) -> bytes:
    """Decompress one LZO1X stream via the native codec tier (ORC LZO
    chunks, Hadoop-framed parquet LZO blocks)."""
    import numpy as np

    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/)")
    out = np.empty(max(dst_capacity, 1), np.uint8)
    src = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    n = lib.srjt_lzo1x_decompress(
        src, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out)
    )
    if n < 0:
        _raise_last(lib)
    return out[:n].tobytes()


def zstd_frame_content_size(data: bytes) -> int:
    """Declared decompressed size of a zstd frame, or -1 if unknown."""
    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/)")
    src = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    n = lib.srjt_zstd_frame_content_size(src, len(data))
    if n == -2:
        _raise_last(lib)
    return int(n)


def zstd_decompress(data: bytes, uncompressed_size: int) -> bytes:
    """Decompress one zstd frame via the native codec tier."""
    import numpy as np

    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/)")
    out = np.empty(max(uncompressed_size, 1), np.uint8)
    src = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    n = lib.srjt_zstd_decompress(
        src, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), uncompressed_size
    )
    if n < 0:
        _raise_last(lib)
    return out[:n].tobytes()


def byte_array_lens(page: bytes):
    """Walk a parquet PLAIN BYTE_ARRAY page in C: per-value lengths.
    The upper bound on values is size/4 (each costs a 4-byte prefix)."""
    import numpy as np

    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/)")
    cap = max(len(page) // 4 + 1, 1)
    out = np.empty(cap, np.int32)
    # borrow the bytes object's buffer (C side only reads) — no memcpy
    src = ctypes.cast(ctypes.c_char_p(page), ctypes.POINTER(ctypes.c_uint8))
    n = lib.srjt_byte_array_lens(
        src,
        len(page),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
    )
    if n < 0:
        raise RuntimeError("byte_array_lens: malformed page (truncated value or overflow)")
    return out[:n].copy()


def _raise_last(lib) -> None:
    msg = lib.srjt_last_error().decode("utf-8", "replace")
    # the native faultinj tier (faultinj.cc) prefixes its injected
    # errors so the failure-classification taxonomy sees them the same
    # way the Python tier's injected faults are seen
    if msg.startswith("RETRYABLE:"):
        from .utils.errors import RetryableError

        raise RetryableError(f"native runtime error: {msg}")
    if msg.startswith("FATAL:"):
        from .utils.errors import FatalDeviceError

        raise FatalDeviceError(f"native runtime error: {msg}")
    raise RuntimeError(f"native runtime error: {msg}")


def faultinj_configure(path: str) -> None:
    """Install a fault-injection config at the NATIVE C-ABI boundary
    (faultinj.cc; same JSON schema as utils/faultinj.py)."""
    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built")
    if lib.srjt_faultinj_configure(path.encode()) != 0:
        _raise_last(lib)


def faultinj_disable() -> None:
    lib = native_lib()
    if lib is not None:
        lib.srjt_faultinj_disable()


def live_handles() -> int:
    """Leak accounting across all native handle types."""
    lib = native_lib()
    return 0 if lib is None else int(lib.srjt_live_handles())


class NativeParquetFooter:
    """Handle to a natively parsed+pruned footer — the ParquetFooter.java
    surface (readAndFilter :200, getNumRows :113, getNumColumns :120,
    serializeThriftFile :106, close :124) over the C ABI."""

    def __init__(self, handle: int, lib: ctypes.CDLL):
        self._handle = handle
        self._lib = lib

    @classmethod
    def read_and_filter(
        cls,
        buf: bytes,
        part_offset: int,
        part_length: int,
        schema: StructElement,
        ignore_case: bool = False,
    ) -> "NativeParquetFooter":
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native runtime not built (run cmake in native/)")
        names, num_children, tags, parent_n = flatten_schema(schema)
        if ignore_case:
            # requested names fold API-side, like ParquetFooter.java:207
            names = [s.lower() for s in names]
        n = len(names)
        names_arr = (ctypes.c_char_p * n)(*[s.encode() for s in names])
        nc_arr = (ctypes.c_int32 * n)(*num_children)
        tag_arr = (ctypes.c_int32 * n)(*tags)
        h = lib.srjt_footer_read_and_filter(
            buf,
            len(buf),
            part_offset,
            part_length,
            ctypes.cast(names_arr, ctypes.POINTER(ctypes.c_char_p)),
            ctypes.cast(nc_arr, ctypes.POINTER(ctypes.c_int32)),
            ctypes.cast(tag_arr, ctypes.POINTER(ctypes.c_int32)),
            n,
            parent_n,
            1 if ignore_case else 0,
        )
        if h == 0:
            _raise_last(lib)
        return cls(h, lib)

    def get_num_rows(self) -> int:
        v = self._lib.srjt_footer_num_rows(self._handle)
        if v < 0:
            _raise_last(self._lib)
        return int(v)

    def get_num_columns(self) -> int:
        v = self._lib.srjt_footer_num_columns(self._handle)
        if v < 0:
            _raise_last(self._lib)
        return int(v)

    def serialize_thrift_file(self) -> bytes:
        size = ctypes.c_int64(0)
        blob = self._lib.srjt_footer_serialize(self._handle, ctypes.byref(size))
        if blob == 0:
            _raise_last(self._lib)
        try:
            out = ctypes.create_string_buffer(size.value)
            if self._lib.srjt_blob_copy(blob, out, size.value) != 0:
                _raise_last(self._lib)
            return out.raw
        finally:
            self._lib.srjt_blob_free(blob)

    def close(self) -> None:
        if self._handle:
            self._lib.srjt_footer_close(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeHostBuffer:
    """Aligned host staging buffer (HostMemoryBuffer analog)."""

    def __init__(self, size: int, alignment: int = 64):
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native runtime not built (run cmake in native/)")
        self._lib = lib
        self._handle = lib.srjt_host_alloc(size, alignment)
        if self._handle == 0:
            _raise_last(lib)
        self.size = size

    @property
    def address(self) -> int:
        return int(self._lib.srjt_host_ptr(self._handle) or 0)

    def write(self, data: bytes, offset: int = 0) -> None:
        if offset < 0 or offset + len(data) > self.size:
            raise ValueError("write out of bounds")
        ctypes.memmove(self.address + offset, data, len(data))

    def read(self, length: int, offset: int = 0) -> bytes:
        if length < 0 or offset < 0 or offset + length > self.size:
            raise ValueError("read out of bounds")
        return ctypes.string_at(self.address + offset, length)

    def close(self) -> None:
        if self._handle:
            self._lib.srjt_host_free(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def bytes_in_use() -> int:
        lib = native_lib()
        return 0 if lib is None else int(lib.srjt_host_bytes_in_use())


# ---------------------------------------------------------------------------
# columnar engine bindings (JVM-facing contract, ctypes-testable)
# ---------------------------------------------------------------------------


class NativeCastError(RuntimeError):
    """CastException shape (reference CastException.java:25-36)."""

    def __init__(self, row_with_error: int, string_with_error: str):
        super().__init__(
            f"Error casting data on row {row_with_error}: {string_with_error!r}"
        )
        self.row_with_error = int(row_with_error)
        self.string_with_error = string_with_error


class NativeColumn:
    """Owned handle to a native column (ai.rapids.cudf.ColumnVector
    analog over the srjt C ABI)."""

    def __init__(self, handle: int, lib):
        self._handle = handle
        self._lib = lib

    @property
    def handle(self) -> int:
        return self._handle

    @classmethod
    def from_python(cls, col) -> "NativeColumn":
        """Build from a port Column (a host copy of its tensors)."""
        import numpy as np

        from .columnar.dtype import TypeId

        lib = native_lib()
        if lib is None:
            raise RuntimeError("native runtime not built (run cmake in native/)")
        n = len(col)
        d = col.dtype
        validity = None
        if col.validity is not None:
            validity = _host(col.validity).astype(np.uint8)
        vp = validity.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if validity is not None else None
        if d.id in (TypeId.STRING, TypeId.LIST):
            offsets = np.ascontiguousarray(_host(col.offsets), dtype=np.int32)
            payload = col.chars if d.id == TypeId.STRING else col.child.data
            chars = np.ascontiguousarray(_host(payload)).view(np.uint8)
            h = lib.srjt_column_create(
                int(d.id), getattr(d, "scale", 0) or 0, n, None, 0, vp,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                chars.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if chars.size else None,
                int(chars.size),
            )
        else:
            data = np.ascontiguousarray(_host(col.data))
            raw = data.view(np.uint8).reshape(-1)
            h = lib.srjt_column_create(
                int(d.id), getattr(d, "scale", 0) or 0, n,
                raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(raw.size),
                vp, None, None, 0,
            )
        if h == 0:
            _raise_last(lib)
        return cls(h, lib)

    def to_python(self, dtype, device=None):
        """Copy back as a port Column on ``device`` (None means the card)."""
        import numpy as np

        from .columnar import Column
        from .columnar.column import _host_to_tensor, resolve_device, upload
        from .columnar.dtype import TypeId

        dev = resolve_device(device)

        lib, h = self._lib, self._handle
        n = int(lib.srjt_column_size(h))
        valid = None
        if lib.srjt_column_has_validity(h):
            vbuf = np.empty(n, np.uint8)
            if lib.srjt_column_copy_validity(h, vbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n) != 0:
                _raise_last(lib)
            valid = upload(vbuf.astype(bool), dev)
        if dtype.id in (TypeId.STRING, TypeId.LIST):
            obuf = np.empty(n + 1, np.int32)
            if lib.srjt_column_copy_offsets(h, obuf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n + 1) != 0:
                _raise_last(lib)
            nchars = int(lib.srjt_column_chars_bytes(h))
            cbuf = np.empty(max(nchars, 1), np.uint8)
            if nchars and lib.srjt_column_copy_chars(h, cbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nchars) != 0:
                _raise_last(lib)
            cbuf = cbuf[:nchars]
            if dtype.id == TypeId.STRING:
                return Column(dtype, validity=valid, offsets=upload(obuf, dev),
                              chars=upload(cbuf, dev))
            from .columnar import dtype as dt_mod

            child = Column(dt_mod.INT8, data=upload(cbuf.view(np.int8), dev))
            return Column(dtype, validity=valid, offsets=upload(obuf, dev), child=child)
        nbytes = int(lib.srjt_column_data_bytes(h))
        dbuf = np.empty(max(nbytes, 1), np.uint8)
        if nbytes and lib.srjt_column_copy_data(h, dbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nbytes) != 0:
            _raise_last(lib)
        dbuf = dbuf[:nbytes]
        if dtype.id == TypeId.DECIMAL128:
            data = upload(dbuf.view(np.int32).reshape(n, 4), dev)
        else:
            data = _host_to_tensor(dbuf, dtype.torch_dtype, dev)
        return Column(dtype, data=data, validity=valid)

    def close(self) -> None:
        if self._handle:
            self._lib.srjt_column_close(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeTable:
    """Owned handle to a native table (ai.rapids.cudf.Table analog)."""

    def __init__(self, handle: int, lib):
        self._handle = handle
        self._lib = lib

    @property
    def handle(self) -> int:
        return self._handle

    @classmethod
    def from_python(cls, table) -> "NativeTable":
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native runtime not built (run cmake in native/)")
        ncols = []
        try:
            for c in table.columns:
                ncols.append(NativeColumn.from_python(c))
            arr = (ctypes.c_int64 * len(ncols))(*[c.handle for c in ncols])
            h = lib.srjt_table_create(arr, len(ncols))
            if h == 0:
                _raise_last(lib)
            return cls(h, lib)
        finally:
            for c in ncols:
                c.close()

    @property
    def num_rows(self) -> int:
        return int(self._lib.srjt_table_num_rows(self._handle))

    @property
    def num_columns(self) -> int:
        return int(self._lib.srjt_table_num_columns(self._handle))

    def column(self, i: int) -> NativeColumn:
        h = self._lib.srjt_table_column(self._handle, i)
        if h == 0:
            _raise_last(self._lib)
        return NativeColumn(h, self._lib)

    def close(self) -> None:
        if self._handle:
            self._lib.srjt_table_close(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_LAUNCHER = """#!{python}
# Launcher for the native sidecar client: it execs
# `<this> -m spark_rapids_jni_tpu.sidecar --socket P`; this script checks
# those two arguments and starts the PyTorch worker in their place.
import os
import sys

if sys.argv[1:3] != ["-m", "spark_rapids_jni_tpu.sidecar"]:
    sys.stderr.write("sidecar launcher: expected -m spark_rapids_jni_tpu.sidecar, got %r\\n"
                     % (sys.argv[1:3],))
    sys.exit(2)
os.execv({python!r}, [{python!r}, "-m", "spark_rapids_jni_tpu_torch.sidecar",
                      "--device", {device!r}] + sys.argv[3:])
"""


def sidecar_launcher(device: str = "cuda") -> str:
    """The launcher the native client execs in place of a python: a
    generated script in the build directory that refuses any module but
    ``spark_rapids_jni_tpu.sidecar`` (exit 2) and execs this interpreter
    on ``spark_rapids_jni_tpu_torch.sidecar --device <device>``."""
    import sys

    from . import _build
    from .sidecar import BACKENDS

    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, got {device!r}")
    text = _LAUNCHER.format(python=sys.executable, device=device)
    path = _build.BUILD_DIR / f"sidecar-launcher-{device}"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not path.exists() or path.read_text() != text:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        tmp.chmod(0o755)
        os.replace(tmp, path)
    return str(path)


def device_connect(python_exe: Optional[str] = None, timeout_sec: int = 120,
                   device: str = "cuda") -> str:
    """Spawn + connect the device sidecar worker through the native client:
    after this, eligible C-ABI ops execute on the worker's device (the
    card unless ``device="cpu"``). ``python_exe=None`` passes the
    launcher (``sidecar_launcher``), so the native client starts the
    port's worker. Returns the backend name (``gpu`` / ``cpu``)."""
    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/ or build_native())")
    # the forked worker resolves the package through PYTHONPATH
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pp = os.environ.get("PYTHONPATH", "")
    if pkg_parent not in pp.split(os.pathsep):
        os.environ["PYTHONPATH"] = f"{pkg_parent}{os.pathsep}{pp}" if pp else pkg_parent
    exe = (python_exe or sidecar_launcher(device)).encode()
    if lib.srjt_device_connect(exe, timeout_sec) != 0:
        _raise_last(lib)
    return device_platform()


def device_platform() -> str:
    """Connected sidecar's backend name, or '' when disconnected."""
    lib = native_lib()
    if lib is None:
        return ""
    return lib.srjt_device_platform().decode()


def device_shutdown() -> None:
    lib = native_lib()
    if lib is not None:
        lib.srjt_device_shutdown()


def device_heartbeat() -> bool:
    """Liveness probe of the connected sidecar worker: True iff a PING
    round-trips on a throwaway connection under the short probe
    deadline of the native client (5 s by default, not its heavy-op
    socket deadline). False means no sidecar, a
    wedged worker, or a libsrjt.so predating the supervision ABI."""
    lib = native_lib()
    if lib is None or not hasattr(lib, "srjt_device_heartbeat"):
        return False
    return bool(lib.srjt_device_heartbeat())


def device_stats(fold: bool = True):
    """Observability snapshot of the device sidecar path(s): the C++
    client's supervision counters (requests, request_failures,
    reconnects, heartbeats) plus the worker's metrics-registry
    snapshot fetched over the STATS protocol verb — and, when a
    Python-side worker POOL is connected (sidecar_pool.py),
    the snapshots of EVERY live pool worker merged in keyed per worker
    id (``pool_workers: {"w0": ..., "w1": ...}``) instead of assuming
    one connection. None when no native library/sidecar AND no pool.

    With ``fold`` (default) the numbers land in this process's
    utils/metrics registry as gauges — ``sidecar.native.*`` for the
    client counters, the single native worker through the shared
    utils/metrics.fold_worker_counters policy (``sidecar.worker.*``),
    and each pool worker under ``sidecar.worker.w<id>.*``."""
    import json

    from . import sidecar_pool
    from .utils import metrics

    stats = None
    lib = native_lib()
    if lib is not None and hasattr(lib, "srjt_device_stats_json"):
        raw = lib.srjt_device_stats_json()
        if raw:
            try:
                stats = json.loads(raw.decode("utf-8", "replace"))
            except ValueError:
                stats = None
    if stats is not None and fold:
        reg = metrics.registry()
        for k, v in (stats.get("client") or {}).items():
            reg.gauge(f"sidecar.native.{k}").set(v)
        worker = stats.get("worker")
        if isinstance(worker, dict):
            metrics.fold_worker_counters(
                (worker.get("snapshot") or {}).get("counters")
            )
    pool = sidecar_pool.current_pool()
    if pool is not None:
        merged = stats if stats is not None else {}
        merged["pool_workers"] = pool.worker_stats(fold=fold)
        return merged
    return stats


def stats_report(pretty: bool = False):
    """End-to-end pipeline stats: ONE snapshot assembling every
    observability tier — the metrics registry (per-op timings, shuffle
    movement, sidecar supervision, event counts), the retry
    orchestrator's counters, the memory tier's split count, and the
    native sidecar's STATS report when one is connected (folded into
    the registry first so the ``metrics`` section is complete).

    The ``retry`` section carries the deadline outcomes
    (``deadline_exceeded`` — gave up on budget — vs ``exhausted`` —
    gave up on attempts — plus ``backoff_truncated``); ``breaker`` is
    the sidecar circuit breaker's state machine (state,
    open/half-open/closed transition counts, fast-fails, last trip
    cause); ``deadline`` reports the ambient SRJTORCH_DEADLINE_SEC budget
    and whether a scope is active at snapshot time; ``memgov`` is the
    memory governor: admission counters and queue-wait
    histogram, spilled/re-materialized bytes, and the catalog's
    per-tier occupancy including sidecar arena registrations.

    ``pool`` is the sidecar worker pool's state (sidecar_pool.py:
    per-worker liveness, failovers, respawns, re-hydrations —
    None until a pool is connected) and ``integrity`` the CRC layer's
    verdicts (frames/spills/exchanges checked, ``crc_mismatch`` — the
    count that separates "corruption caught" from "wrong answer").

    ``health`` and ``hedge`` are the tail-tolerance layer:
    gray-failure quarantine verdicts (quarantines, probe counts,
    reinstatements, per-worker latency EWMAs when a pool is live) and
    hedged-dispatch accounting (launched/won/cancelled/suppressed plus
    adaptive-timeout clamp counts from both the sidecar client and the
    TCP exchange).

    ``serve`` is the concurrent serving runtime (serve/:
    submissions/completions, shed counts per cause, expired-in-queue,
    and every live scheduler's tenant/queue snapshot — None until a
    scheduler has ever been created).

    ``durability`` is the crash-recovery tier: the query
    journal's append/replay/truncation/idempotent-hit counters (None
    until a journal was ever active) and the spill-manifest layer's
    written/rot/re-attached/orphans-reclaimed counters.

    Returns a JSON-serializable dict; ``pretty=True`` returns the
    aligned text rendering (utils/metrics.render_report) instead."""
    from . import cache, memgov, serve, sidecar, sidecar_pool
    from .memgov import persist as _persist  # noqa: F401 (binds memgov.persist)
    from .utils import deadline as deadline_mod
    from .utils import integrity, memory, metrics, retry, trace_sink

    native = device_stats(fold=True)
    report = {
        "metrics": metrics.snapshot(),
        # span/trace volume, sampling, and the
        # flight recorder's ring state (the worst recent query itself
        # renders via runtime.explain_last())
        "trace": trace_sink.stats_section(),
        "retry": retry.stats(),
        "memory": {"split_retries": memory.split_retry_count()},
        "memgov": memgov.stats_section(),
        "breaker": sidecar.breaker().snapshot(),
        "pool": sidecar_pool.stats_section(),
        "health": sidecar_pool.health_section(),
        "hedge": sidecar_pool.hedge_section(),
        "serve": serve.stats_section(),
        # plan-cache hit economics, governed
        # subresult footprint, in-flight sharing, knob posture
        "cache": cache.stats_section(),
        # the journal half is None until a
        # journal was ever active this process; the persist half is
        # registry-direct (zeros) so the sweep/re-attach counters
        # answer even when manifests never armed
        "durability": {
            "journal": serve.journal.stats_section(),
            "persist": memgov.persist.stats_counters(),
        },
        "integrity": integrity.stats_section(),
        "deadline": {
            "default_budget_s": deadline_mod.default_budget(),
            "active_scope": deadline_mod.current() is not None,
        },
        "native_sidecar": native,
    }
    if pretty:
        return metrics.render_report(report)
    return report


def explain_last():
    """Render the WORST recent traced query (failures and sheds first,
    then duration) as an annotated span tree — the flight recorder's
    one-command answer to "why was THAT query slow". Returns
    None when tracing never recorded a query in this process. The
    rendering is this process's view; cross-process spans (sidecar
    workers, exchange peers) live in the per-process span logs."""
    from .utils import trace_sink

    return trace_sink.explain_last()


def device_groupby_sum(keys, vals, num_keys: int, deadline_s: Optional[float] = None):
    """GROUP BY SUM executed on the sidecar's device (B3,
    ``hopper_kernels.groupby_sum_outer``, when the worker is on the
    card). keys int64[n], vals float32[n].

    With the retry orchestrator armed (SRJTORCH_RETRY_ENABLED=1 /
    utils.retry.enable()), RETRYABLE-classified native failures —
    including the native fault injector's ``RETRYABLE:``-prefixed
    storms — re-run under bounded backoff before surfacing.

    ``deadline_s`` opens a per-call deadline scope (utils/deadline.py;
    an ambient SRJTORCH_DEADLINE_SEC applies when unset and no scope is
    active): the orchestrator's backoffs truncate to the budget and
    attempts stop with DeadlineExceeded when it is gone. The native
    call itself blocks under the C++ client's own socket deadline
    — the budget bounds when attempts may
    START; the socket deadline bounds how long one can run."""
    import numpy as np

    from .utils import deadline as deadline_mod
    from .utils import retry

    lib = native_lib()
    if lib is None:
        raise RuntimeError("native runtime not built (run cmake in native/)")
    keys = np.ascontiguousarray(keys, np.int64)
    vals = np.ascontiguousarray(vals, np.float32)
    if len(keys) != len(vals):
        raise ValueError(f"keys/vals length mismatch: {len(keys)} vs {len(vals)}")
    sums = np.empty(num_keys, np.float32)
    counts = np.empty(num_keys, np.int64)

    def attempt():
        rc = lib.srjt_device_groupby_sum(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(keys), num_keys,
            sums.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc != 0:
            _raise_last(lib)

    # same nesting guard as utils/dispatch.py: when an enclosing armed
    # boundary already owns a retry loop, this op must not multiply it
    with deadline_mod.op_scope(deadline_s) as d:
        if d is not None:
            d.check("device_groupby_sum")
        if retry.is_enabled() and not retry.in_attempt():
            retry.call_with_retry(attempt, op_name="device_groupby_sum")
        else:
            attempt()
    return sums, counts


def native_convert_to_rows(table: "NativeTable") -> NativeColumn:
    """RowConversion.convertToRows through the C ABI."""
    lib = table._lib
    h = lib.srjt_convert_to_rows(table.handle)
    if h == 0:
        _raise_last(lib)
    return NativeColumn(h, lib)


def native_convert_to_rows_batched(
    table: "NativeTable", max_batch_bytes: int = 0
) -> List[NativeColumn]:
    """RowConversion.convertToRows with internal batch splitting: one
    LIST<INT8> column per <= max_batch_bytes batch (0 = the 2 GiB
    size_type default). The injectable limit is the test hook for the
    reference's build_batches discipline."""
    lib = table._lib
    cap = 1024
    handles = (ctypes.c_int64 * cap)()
    n = lib.srjt_convert_to_rows_batched(table.handle, max_batch_bytes, handles, cap)
    if n < 0:
        _raise_last(lib)
    return [NativeColumn(handles[i], lib) for i in range(n)]


def native_convert_from_rows(rows: NativeColumn, dtypes) -> NativeTable:
    """RowConversion.convertFromRows through the C ABI."""
    lib = rows._lib
    ids = (ctypes.c_int32 * len(dtypes))(*[int(d.id) for d in dtypes])
    scales = (ctypes.c_int32 * len(dtypes))(*[getattr(d, "scale", 0) or 0 for d in dtypes])
    h = lib.srjt_convert_from_rows(rows.handle, ids, scales, len(dtypes))
    if h == 0:
        _raise_last(lib)
    return NativeTable(h, lib)


def _raise_cast_or_last(lib) -> None:
    """ANSI cast-error protocol (CATCH_CAST_EXCEPTION shape): raise
    NativeCastError with the first failing row when one is pending,
    else the generic native error."""
    if lib.srjt_last_cast_error_pending():
        raise NativeCastError(
            int(lib.srjt_last_cast_row()),
            lib.srjt_last_cast_string().decode("utf-8", "replace"),
        )
    _raise_last(lib)


def native_cast_string_to_integer(col: NativeColumn, ansi_mode: bool, out_dtype) -> NativeColumn:
    """CastStrings.toInteger through the C ABI; raises NativeCastError
    in ANSI mode on the first failing row."""
    lib = col._lib
    h = lib.srjt_cast_string_to_integer(col.handle, 1 if ansi_mode else 0, int(out_dtype.id))
    if h == 0:
        _raise_cast_or_last(lib)
    return NativeColumn(h, lib)


def native_cast_string_to_decimal(
    col: NativeColumn, ansi_mode: bool, precision: int, scale: int
) -> NativeColumn:
    """CastStrings.toDecimal through the C ABI; raises NativeCastError
    in ANSI mode on the first failing row."""
    lib = col._lib
    h = lib.srjt_cast_string_to_decimal(col.handle, 1 if ansi_mode else 0, precision, scale)
    if h == 0:
        _raise_cast_or_last(lib)
    return NativeColumn(h, lib)


def native_zorder_interleave_bits(table: NativeTable) -> NativeColumn:
    """ZOrder.interleaveBits through the C ABI."""
    lib = table._lib
    h = lib.srjt_zorder_interleave_bits(table.handle)
    if h == 0:
        _raise_last(lib)
    return NativeColumn(h, lib)


def live_columnar_handles() -> int:
    lib = native_lib()
    return 0 if lib is None else int(lib.srjt_live_columnar_handles())


def native_multiply_decimal128(a: NativeColumn, b: NativeColumn, product_scale: int) -> NativeTable:
    """DecimalUtils.multiply128 through the C ABI."""
    lib = a._lib
    h = lib.srjt_multiply_decimal128(a.handle, b.handle, product_scale)
    if h == 0:
        _raise_last(lib)
    return NativeTable(h, lib)


def native_divide_decimal128(a: NativeColumn, b: NativeColumn, quotient_scale: int) -> NativeTable:
    """DecimalUtils.divide128 through the C ABI."""
    lib = a._lib
    h = lib.srjt_divide_decimal128(a.handle, b.handle, quotient_scale)
    if h == 0:
        _raise_last(lib)
    return NativeTable(h, lib)
