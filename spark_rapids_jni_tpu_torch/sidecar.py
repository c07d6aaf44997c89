"""Device sidecar worker: the JNI -> device execution path, on PyTorch.

The port of the JAX package's ``sidecar.py``. ``libsrjt.so`` (native/)
forks a worker process that owns the card and dispatches ops to it over
a Unix-domain socket with a length-prefixed binary protocol; the JVM
process never hosts a Python interpreter. This module is that worker
(``python -m spark_rapids_jni_tpu_torch.sidecar --device cuda --socket
P``) and its Python client. ``runtime.device_connect`` reaches it from
the unmodified native client through a launcher (runtime.py).

Wire protocol (little-endian), byte for byte the reference's:
  request:  [u32 op] [u64 payload_len] [u32 crc?] [trace ctx?] [payload]
  response: [u32 status(0=ok)] [u64 payload_len] [u32 crc?] [payload | utf-8 error]

Flag bits of ``op``/``status``: ``CRC_FLAG`` (a 4-byte CRC trailer of
utils/integrity follows the header; negotiated per frame, the worker
echoes it), ``TRACE_FLAG`` (a 17-byte trace context follows the
trailer; the worker's span parents to the caller's) and ``ARENA_FLAG``
(the payload lives in the shared arena the client uploaded with
OP_SET_ARENA: at offset 0 of a legacy arena, or behind a 32-byte region
header of a slab arena, whose stream payload is then a region
descriptor). The native client never sets CRC or TRACE, so the legacy
framing stays what ``native/src/sidecar.cc`` parses.

Ops:
  0 PING              -> payload = the backend name: b"gpu" on the card,
                         b"cpu" with ``--device cpu`` (the reference's
                         jax names for the same backends)
  1 GROUPBY_SUM_F32   in:  u32 num_keys, u64 n, i64[n] keys, f32[n] vals
                      out: f32[num_keys] sums, i64[num_keys] counts
  2 CONVERT_TO_ROWS   in:  serialized table (see _read_table)
                      out: u32 nbatches, per batch: u64 nrows,
                           i32[nrows+1] offsets, u64 blob_len, u8 blob
  3 CONVERT_FROM_ROWS in:  u32 ncols, i32[ncols] type_ids, i32[ncols]
                           scales, u64 nrows, i32[nrows+1] offsets,
                           u64 blob_len, u8 blob
                      out: serialized table (_write_table)
  4 CAST_TO_INTEGER   in:  u8 ansi, i32 out_type_id, serialized table
                      out: serialized table; an ANSI failure answers
                           status 2: i64 row, u8 is_null, utf-8 value
  5 CAST_TO_DECIMAL   in:  u8 ansi, i32 precision, i32 scale, table
  6 ZORDER            in:  serialized table -> one LIST<UINT8> column
  7 DECIMAL128_MUL    in:  i32 product_scale, table (a, b)
  8 DECIMAL128_DIV    in:  i32 quotient_scale, table (a, b)
  9 SET_ARENA         payload u64 size [, u64 mode], memfd by SCM_RIGHTS
  10 STATS            -> utf-8 JSON {"backend", "snapshot", "memgov"}
  255 SHUTDOWN        -> empty ok, then the worker exits

Status codes: 0 ok, 1 error (utf-8 message carrying the taxonomy prefix:
``RetryableError:``, ``FatalDeviceError:``, ``DataCorruption:``,
``Overloaded:``, ``DeadlineExceeded:``), 2 ANSI cast error.

Every op runs on the worker's device: the card for backend ``gpu``, the
CPU for ``cpu`` and for the in-process ``host-fallback`` that
``SupervisedClient.call`` and ``sidecar_pool.SidecarPool.call`` degrade
to when the worker is gone (counted, never quiet). The worker refuses to
start on the card without one (exit 2 before READY): it serves on the
CPU only when asked to.

``SupervisedClient`` is the Python client with the supervision
contract: a per-request deadline (adaptive once an op class has
samples), heartbeat PING on idle connections, reconnect on desync,
worker errors classified into the retryable/fatal taxonomy, the retry
orchestrator, and the process-global circuit breaker (``breaker()``).
"""

from __future__ import annotations

import argparse
import os
import socket
import struct
import sys
import threading
import time

OP_PING = 0
OP_GROUPBY_SUM_F32 = 1
OP_CONVERT_TO_ROWS = 2
OP_CONVERT_FROM_ROWS = 3
OP_CAST_TO_INTEGER = 4
OP_CAST_TO_DECIMAL = 5
OP_ZORDER = 6
OP_DECIMAL128_MUL = 7
OP_DECIMAL128_DIV = 8
OP_SET_ARENA = 9
OP_STATS = 10
OP_SHUTDOWN = 255

# readable per-op metric names (worker-side request counters)
_OP_NAMES = {
    OP_PING: "PING",
    OP_GROUPBY_SUM_F32: "GROUPBY_SUM_F32",
    OP_CONVERT_TO_ROWS: "CONVERT_TO_ROWS",
    OP_CONVERT_FROM_ROWS: "CONVERT_FROM_ROWS",
    OP_CAST_TO_INTEGER: "CAST_TO_INTEGER",
    OP_CAST_TO_DECIMAL: "CAST_TO_DECIMAL",
    OP_ZORDER: "ZORDER",
    OP_DECIMAL128_MUL: "DECIMAL128_MUL",
    OP_DECIMAL128_DIV: "DECIMAL128_DIV",
    OP_SET_ARENA: "SET_ARENA",
    OP_STATS: "STATS",
    OP_SHUTDOWN: "SHUTDOWN",
}


def op_name(op: int) -> str:
    return _OP_NAMES.get(op, f"OP_{op}")


ARENA_FLAG = 0x80000000  # high bit of op/status: payload in the arena
CRC_FLAG = 0x40000000  # op/status bit: a u32 CRC trailer follows the header
TRACE_FLAG = 0x20000000  # op bit: a trace-context blob follows the trailer
_FLAG_MASK = ARENA_FLAG | CRC_FLAG | TRACE_FLAG

# slab-arena data plane: a SET_ARENA payload of >= 16 bytes carries a u64
# mode word after the size; bit 0 marks the arena a SLAB of per-request
# regions (sidecar_pool.ArenaSlab), whose ARENA_FLAG requests carry a
# REGION DESCRIPTOR checked against the region header in the slab.
ARENA_MODE_LEGACY = 0
ARENA_MODE_SLAB = 1
REGION_MAGIC = 0x524A5253  # b"SRJR" little-endian
REGION_HDR = struct.Struct("<IIQQQ")  # magic, generation, request_id, capacity, payload_len
REGION_HDR_LEN = REGION_HDR.size  # 32
REGION_DESC = struct.Struct("<QQI")  # offset, request_id, generation

STATUS_OK = 0
STATUS_ERROR = 1
STATUS_CAST_ERROR = 2

# the backend names PING answers, by worker device
BACKENDS = {"cuda": "gpu", "cpu": "cpu"}


def device_of(backend: str):
    """The torch device an op runs on for a backend name: the card for
    ``gpu``, the CPU for ``cpu`` and ``host-fallback``."""
    import torch

    return torch.device("cuda") if backend == "gpu" else torch.device("cpu")


_RECV_CHUNK = 1 << 20  # bytes asked of one recv: a larger ask allocates that much a call


def _recv_exact(conn: socket.socket, n: int, fds: list = None) -> bytes:
    """Read exactly n bytes into one buffer, at most ``_RECV_CHUNK`` a
    call. With ``fds`` given, capture any SCM_RIGHTS file descriptors that
    arrive with the stream (the OP_SET_ARENA memfd travels with its
    header bytes)."""
    import array

    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        want = min(n - got, _RECV_CHUNK)
        if fds is None:
            k = conn.recv_into(view[got:], want)
        else:
            k, ancdata, _flags, _addr = conn.recvmsg_into(
                [view[got: got + want]], socket.CMSG_SPACE(4 * array.array("i").itemsize)
            )
            for level, ctype, cdata in ancdata:
                if level == socket.SOL_SOCKET and ctype == socket.SCM_RIGHTS:
                    a = array.array("i")
                    a.frombytes(cdata[: len(cdata) - (len(cdata) % a.itemsize)])
                    fds.extend(a)
        if not k:
            raise ConnectionError("sidecar: peer closed")
        got += k
    return bytes(buf)


def _send_frame(conn: socket.socket, head: bytes, body) -> None:
    """Send a frame's header, then its body: one ``sendall`` when the body
    is small, two when joining them would copy a large body."""
    if len(body) < (1 << 16):
        conn.sendall(head + bytes(body))
    else:
        conn.sendall(head)
        conn.sendall(body)


# wire table format negotiation: the worker answers each request in the
# table layout the REQUEST used (one slot per connection thread), so the
# native client's legacy walker layout round-trips byte for byte while
# framed clients get the columnar frame codec (columnar/frames.py) back.
_REQ_FMT = threading.local()


def _host(t):
    """A tensor as a host numpy array with the same bits (one copy off
    the card)."""
    return t.detach().contiguous().cpu().numpy()


def _read_table(payload: bytes, pos: int = 0, device=None):
    """Deserialize a table from ``payload[pos:]`` onto ``device``. Sniffs
    the columnar frame magic first (per-column CRC verified); anything
    else is the legacy walker layout: u32 ncols; per col: i32 type_id,
    i32 scale, u64 n, u8 has_validity, [n] u8 validity, then either
    (u64 data_len, bytes) for fixed width or (i32[n+1] offsets, u64
    chars_len, bytes) for STRING and LIST (byte child)."""
    import numpy as np

    from .columnar import Column, Table, frames
    from .columnar.column import _host_to_tensor, upload
    from .columnar.dtype import DType, TypeId

    dev = device_of("cpu") if device is None else device
    if frames.is_frame(payload, pos):
        _REQ_FMT.framed = True
        return frames.decode_table(payload, where="sidecar.table_frame", offset=pos,
                                   device=dev)
    _REQ_FMT.framed = False
    (ncols,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    cols = []
    for _ in range(ncols):
        type_id, scale = struct.unpack_from("<ii", payload, pos)
        pos += 8
        (n,) = struct.unpack_from("<Q", payload, pos)
        pos += 8
        has_validity = payload[pos]
        pos += 1
        validity = None
        if has_validity:
            validity = upload(np.frombuffer(payload, np.uint8, n, pos).astype(bool), dev)
            pos += n
        tid = TypeId(type_id)
        d = DType(tid, scale if tid.name.startswith("DECIMAL") else 0)
        if tid in (TypeId.STRING, TypeId.LIST):
            offs = np.frombuffer(payload, np.int32, n + 1, pos)
            pos += 4 * (n + 1)
            (clen,) = struct.unpack_from("<Q", payload, pos)
            pos += 8
            chars = np.frombuffer(payload, np.uint8, clen, pos)
            pos += clen
            if tid == TypeId.LIST:
                child = Column(DType(TypeId.INT8), data=upload(chars.view(np.int8), dev))
                cols.append(Column(d, validity=validity, offsets=upload(offs, dev), child=child))
            else:
                cols.append(Column(d, validity=validity, offsets=upload(offs, dev),
                                   chars=upload(chars, dev)))
        else:
            (dlen,) = struct.unpack_from("<Q", payload, pos)
            pos += 8
            raw = np.frombuffer(payload, np.uint8, dlen, pos)
            pos += dlen
            if tid == TypeId.DECIMAL128:
                data = upload(raw.view(np.int32).reshape(n, 4), dev)
            else:
                data = _host_to_tensor(raw, d.torch_dtype, dev)
            cols.append(Column(d, data=data, validity=validity))
    return Table(cols)


def _op_groupby_sum(payload: bytes, dev) -> bytes:
    import numpy as np

    from .columnar.column import upload
    from .ops.aggregate import groupby_sum_bounded

    (num_keys,) = struct.unpack_from("<I", payload, 0)
    (n,) = struct.unpack_from("<Q", payload, 4)
    keys = np.frombuffer(payload, np.int64, n, 12)
    vals = np.frombuffer(payload, np.float32, n, 12 + 8 * n)
    sums, counts = groupby_sum_bounded(upload(keys, dev), upload(vals, dev), int(num_keys))
    return (_host(sums).astype(np.float32, copy=False).tobytes()
            + _host(counts).astype(np.int64, copy=False).tobytes())


def _write_table(table, framed: bool = None) -> bytes:
    """Serialize a Table for the wire. ``framed=None`` (the worker's
    posture) echoes the format the current request's ``_read_table``
    sniffed. LIST<INT8|UINT8> columns reuse the STRING framing (offsets
    + byte child) in the legacy form."""
    import numpy as np

    from .columnar.dtype import TypeId

    if framed is None:
        framed = getattr(_REQ_FMT, "framed", False)
    if framed:
        from .columnar import frames

        return frames.encode_table(table)
    out = [struct.pack("<I", len(table.columns))]
    for col in table.columns:
        d = col.dtype
        n = len(col)
        out.append(struct.pack("<ii", int(d.id.value), int(d.scale)))
        out.append(struct.pack("<Q", n))
        if col.validity is not None:
            out.append(b"\x01")
            out.append(_host(col.validity).astype(np.uint8).data)
        else:
            out.append(b"\x00")
        if d.id in (TypeId.STRING, TypeId.LIST):
            offs = _host(col.offsets).astype(np.int32, copy=False)
            chars = _host(col.chars if d.id == TypeId.STRING else col.child.data)
            out.append(offs.data)
            out.append(struct.pack("<Q", chars.nbytes))
            out.append(chars.data)
        else:
            raw = _host(col.data)
            out.append(struct.pack("<Q", raw.nbytes))
            out.append(raw.reshape(-1).data)
    return b"".join(out)


def _op_convert_to_rows(payload: bytes, dev) -> bytes:
    import numpy as np

    from .ops.row_conversion import convert_to_rows

    table = _read_table(payload, device=dev)
    batches = convert_to_rows(table)
    out = [struct.pack("<I", len(batches))]
    for col in batches:
        offs = _host(col.offsets).astype(np.int32, copy=False)
        blob = _host(col.child.data)
        out.append(struct.pack("<Q", len(col)))
        out.append(offs.data)
        out.append(struct.pack("<Q", blob.nbytes))
        out.append(blob.reshape(-1).data)
    return b"".join(out)


def _op_convert_from_rows(payload: bytes, dev) -> bytes:
    import numpy as np

    from .columnar import Column
    from .columnar.column import upload
    from .columnar.dtype import DType, TypeId
    from .ops.row_conversion import convert_from_rows

    pos = 0
    (ncols,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    type_ids = np.frombuffer(payload, np.int32, ncols, pos)
    pos += 4 * ncols
    scales = np.frombuffer(payload, np.int32, ncols, pos)
    pos += 4 * ncols
    (nrows,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    offs = np.frombuffer(payload, np.int32, nrows + 1, pos)
    pos += 4 * (nrows + 1)
    (blen,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    blob = np.frombuffer(payload, np.uint8, blen, pos)
    dtypes = [
        DType(TypeId(int(t)), int(s) if TypeId(int(t)).name.startswith("DECIMAL") else 0)
        for t, s in zip(type_ids, scales)
    ]
    rows = Column(
        DType(TypeId.LIST),
        offsets=upload(offs, dev),
        child=Column(DType(TypeId.INT8), data=upload(blob.view(np.int8), dev)),
    )
    return _write_table(convert_from_rows(rows, dtypes))


def _op_cast_to_integer(payload: bytes, dev) -> bytes:
    from .columnar import Table
    from .columnar.dtype import DType, TypeId
    from .ops.cast_string import string_to_integer

    ansi = payload[0]
    (out_type,) = struct.unpack_from("<i", payload, 1)
    table = _read_table(payload, 5, device=dev)
    out = string_to_integer(table.columns[0], ansi != 0, DType(TypeId(out_type)))
    return _write_table(Table([out]))


def _op_cast_to_decimal(payload: bytes, dev) -> bytes:
    from .columnar import Table
    from .ops.cast_decimal import string_to_decimal

    ansi = payload[0]
    precision, scale = struct.unpack_from("<ii", payload, 1)
    table = _read_table(payload, 9, device=dev)
    out = string_to_decimal(table.columns[0], ansi != 0, precision, scale)
    return _write_table(Table([out]))


def _op_zorder(payload: bytes, dev) -> bytes:
    from .columnar import Table
    from .ops.zorder import interleave_bits_table

    table = _read_table(payload, device=dev)
    return _write_table(Table([interleave_bits_table(table, device=dev)]))


def _op_decimal128(payload: bytes, dev, div: bool) -> bytes:
    from .ops.decimal_utils import divide128, multiply128

    (out_scale,) = struct.unpack_from("<i", payload, 0)
    table = _read_table(payload, 4, device=dev)
    a, b = table.columns[0], table.columns[1]
    res = divide128(a, b, out_scale) if div else multiply128(a, b, out_scale)
    return _write_table(res)


def _op_stats(backend: str) -> bytes:
    """STATS verb: the worker's metrics-registry snapshot as JSON plus
    the memory governor's section. The worker counts per-op requests and
    errors registry-direct (always on: the verb answers even when
    hot-path instrumentation is disarmed)."""
    import json

    from . import memgov
    from .utils import metrics

    return json.dumps(
        {
            "backend": backend,
            "snapshot": metrics.snapshot(),
            "memgov": memgov.stats_section(),
        }
    ).encode()


def _dispatch(op: int, payload: bytes, backend: str) -> bytes:
    """One op on the device ``backend`` names (``device_of``)."""
    # fresh wire-format slot per dispatch: host-fallback callers reuse
    # threads, and a stale `framed` sniff from an earlier request would
    # make an op that never reads a table echo the wrong table layout
    _REQ_FMT.framed = False
    if op == OP_PING:
        return backend.encode()
    if op == OP_STATS:
        return _op_stats(backend)
    dev = device_of(backend)
    if op == OP_GROUPBY_SUM_F32:
        return _op_groupby_sum(payload, dev)
    if op == OP_CONVERT_TO_ROWS:
        return _op_convert_to_rows(payload, dev)
    if op == OP_CONVERT_FROM_ROWS:
        return _op_convert_from_rows(payload, dev)
    if op == OP_CAST_TO_INTEGER:
        return _op_cast_to_integer(payload, dev)
    if op == OP_CAST_TO_DECIMAL:
        return _op_cast_to_decimal(payload, dev)
    if op == OP_ZORDER:
        return _op_zorder(payload, dev)
    if op == OP_DECIMAL128_MUL:
        return _op_decimal128(payload, dev, div=False)
    if op == OP_DECIMAL128_DIV:
        return _op_decimal128(payload, dev, div=True)
    raise ValueError(f"unknown op {op}")


def _handle_conn(conn: socket.socket, backend: str, shutdown) -> None:
    """One client connection: its own optional arena, its own thread."""
    import mmap

    from . import memgov
    from .utils import faultinj, integrity, knobs, metrics, tracing
    from .utils.errors import DataCorruption

    reg = metrics.registry()  # worker-side counters: always-on
    arena = None  # mmap over the client's memfd
    arena_mode = ARENA_MODE_LEGACY
    # the mmap'd arena is host memory no budget would otherwise see: it
    # registers as a host-tier PINNED catalog entry, keyed per connection
    arena_key = f"sidecar.arena.conn{id(conn)}"
    fds: list = []

    def reply(status: int, body: bytes, with_crc: bool, crc_body: bytes = None,
              region=None):
        """One response frame. ``crc_body`` is what the trailer covers when
        it differs from the bytes on the wire (the injected ``corrupt``
        chaos flips bytes AFTER checksumming, like a transport fault).
        ``region`` is the (offset, capacity, request_id, generation) of a
        slab-mode request: a fitting OK response lands back inside that
        region after its header is re-validated against the request's id
        and generation; otherwise the answer streams."""
        trailer = b""
        if with_crc and integrity.is_enabled():
            status |= CRC_FLAG
            trailer = integrity.pack_crc(
                integrity.checksum(body if crc_body is None else crc_body)
            )
        ok = (status & ~_FLAG_MASK) == STATUS_OK
        if ok and region is not None and 0 < len(body) <= region[1]:
            # re-validate the in-slab header immediately before writing:
            # a slow worker whose client already failed over must not
            # clobber the retry's region (the client bumps the generation
            # on every rewrite); on mismatch answer on the stream
            off = region[0]
            magic, hgen, hrid, _cap, _plen = REGION_HDR.unpack_from(arena, off)
            if magic == REGION_MAGIC and hrid == region[2] and hgen == region[3]:
                start = off + REGION_HDR_LEN
                arena[start: start + len(body)] = body
                conn.sendall(struct.pack("<IQ", status | ARENA_FLAG, len(body)) + trailer)
                return
        if (
            ok and arena is not None and arena_mode == ARENA_MODE_LEGACY
            and 0 < len(body) <= len(arena)
        ):
            arena[: len(body)] = body
            conn.sendall(struct.pack("<IQ", status | ARENA_FLAG, len(body)) + trailer)
        else:
            _send_frame(conn, struct.pack("<IQ", status, len(body)) + trailer, body)

    try:
        while True:
            try:
                hdr = _recv_exact(conn, 12, fds)
            except ConnectionError:
                return  # client went away: this connection only
            wire_op, plen = struct.unpack("<IQ", hdr)
            op = wire_op & ~_FLAG_MASK
            in_arena = bool(wire_op & ARENA_FLAG)
            with_crc = bool(wire_op & CRC_FLAG)
            reg.counter(f"sidecar.worker.requests.{op_name(op)}").inc()
            # the CRC trailer and the trace context ride the SOCKET right
            # after the header, even for arena-resident payloads: read
            # them before any early-out so the stream stays framed
            req_crc = integrity.unpack_crc(_recv_exact(conn, 4, fds)) if with_crc else None
            tctx = (
                tracing.decode_wire_context(_recv_exact(conn, tracing.TRACE_CTX_LEN, fds))
                if wire_op & TRACE_FLAG
                else None
            )
            region = None
            if in_arena and arena_mode == ARENA_MODE_SLAB:
                # slab mode: the stream payload is a region DESCRIPTOR;
                # every mismatch answers retryably so the client rewrites
                # the region (or replays SET_ARENA) and re-sends
                desc = _recv_exact(conn, plen, fds) if plen else b""
                err = None
                if len(desc) != REGION_DESC.size:
                    err = f"bad region descriptor length {len(desc)}"
                elif arena is None:
                    err = "no uploaded arena (re-send SET_ARENA)"
                else:
                    off, rid, gen = REGION_DESC.unpack(desc)
                    if off + REGION_HDR_LEN > len(arena):
                        err = f"region offset {off} out of bounds"
                    else:
                        magic, hgen, hrid, cap, pl = REGION_HDR.unpack_from(arena, off)
                        if magic != REGION_MAGIC or hrid != rid or hgen != gen:
                            err = (
                                f"region header desync at {off} "
                                f"(rid {hrid} != {rid} or gen {hgen} != {gen})"
                            )
                        elif pl > cap or off + REGION_HDR_LEN + cap > len(arena):
                            err = f"region geometry invalid (len {pl} cap {cap})"
                        else:
                            region = (off, cap, rid, gen)
                            start = off + REGION_HDR_LEN
                            payload = bytes(arena[start: start + pl])
                if err is not None:
                    reply(STATUS_ERROR, f"RetryableError: arena region: {err}".encode(), with_crc)
                    continue
            elif in_arena:
                if arena is None or plen > len(arena):
                    # retryable by prefix: a redialed connection lost its
                    # per-connection arena; the client replays SET_ARENA
                    reply(
                        STATUS_ERROR,
                        b"RetryableError: arena request without an uploaded"
                        b" arena (re-send SET_ARENA)",
                        with_crc,
                    )
                    continue
                payload = bytes(arena[:plen])
            else:
                payload = _recv_exact(conn, plen, fds) if plen else b""
            _REQ_FMT.framed = False  # set by _read_table when it sniffs a frame
            if req_crc is not None and integrity.is_enabled():
                reg.counter("sidecar.integrity.frames_checked").inc()
                try:
                    integrity.verify(payload, req_crc, "sidecar.request")
                except DataCorruption as e:
                    reply(STATUS_ERROR, f"{type(e).__name__}: {e}".encode(), with_crc)
                    continue
            # chaos: SRJTORCH_CHAOS_EXIT_ON_OP=<n> makes the worker DIE
            # after consuming the request, before any response
            chaos = knobs.get_int("SRJTORCH_CHAOS_EXIT_ON_OP")
            if chaos is not None and op == chaos:
                os._exit(42)
            try:
                # per-request fault hook: `crash` rules keyed
                # `sidecar.worker.<OP>` SIGKILL the worker here, and error
                # kinds surface as status-1 replies
                if faultinj.is_enabled():
                    faultinj.maybe_inject(f"sidecar.worker.{op_name(op)}")
                if op == OP_SET_ARENA:
                    (size,) = struct.unpack_from("<Q", payload, 0)
                    mode = (
                        struct.unpack_from("<Q", payload, 8)[0]
                        if len(payload) >= 16
                        else ARENA_MODE_LEGACY
                    )
                    if not fds:
                        raise ValueError("SET_ARENA without an fd")
                    fd = fds.pop(0)
                    for extra in fds:
                        os.close(extra)
                    fds.clear()
                    if arena is not None:
                        # replace = unregister-then-register, so the
                        # governor's arena bytes never double-count
                        arena.close()
                        arena = None
                        memgov.catalog().unregister(arena_key)
                    arena = mmap.mmap(fd, size)
                    arena_mode = ARENA_MODE_SLAB if (mode & ARENA_MODE_SLAB) else ARENA_MODE_LEGACY
                    os.close(fd)
                    memgov.catalog().register_host_bytes(arena_key, size, pinned=True,
                                                         kind="arena")
                    reply(STATUS_OK, b"", with_crc)
                    continue
                if op == OP_SHUTDOWN:
                    conn.sendall(struct.pack("<IQ", 0, 0))
                    shutdown()
                    return
                # per-op wall time is gated hot-path instrumentation,
                # unlike the always-on request counters above
                timed = metrics.is_enabled()
                t0 = time.perf_counter() if timed else 0.0
                if tctx is not None and tracing.is_enabled():
                    with tracing.remote_scope(*tctx):
                        with tracing.span("sidecar.worker_op", op=op_name(op), backend=backend):
                            resp = _dispatch(op, payload, backend)
                else:
                    resp = _dispatch(op, payload, backend)
                if timed:
                    reg.histogram(f"sidecar.worker.op_us.{op_name(op)}").record(
                        (time.perf_counter() - t0) * 1e6
                    )
                wire_resp = resp
                if faultinj.is_enabled():
                    # `corrupt` chaos: flips bytes BELOW the checksum
                    wire_resp = faultinj.maybe_corrupt(f"sidecar.worker.{op_name(op)}", resp)
                reply(STATUS_OK, wire_resp, with_crc, crc_body=resp, region=region)
            except Exception as e:  # srjt-lint: allow-broad-except(worker request loop: every failure must become a status-1 reply carrying the taxonomy prefix — the client re-raises the right class across the wire; the worker keeps serving)
                from .ops.cast_string import CastError

                reg.counter("sidecar.worker.errors").inc()
                if isinstance(e, CastError):
                    # semantic ANSI failure: row + null flag + value, so
                    # the client re-raises instead of re-running
                    sv = e.string_with_error
                    val = sv.encode() if isinstance(sv, str) else (bytes(sv) if sv else b"")
                    msg = struct.pack("<qB", int(e.row_with_error), 1 if sv is None else 0) + val
                    reply(STATUS_CAST_ERROR, msg, with_crc)
                else:
                    reply(STATUS_ERROR, f"{type(e).__name__}: {e}".encode(), with_crc)
    finally:
        if arena is not None:
            arena.close()
            memgov.catalog().unregister(arena_key)
        for fd in fds:
            os.close(fd)
        conn.close()


# ---------------------------------------------------------------------------
# supervised Python client (the executor-side path; C++ twin: sidecar.cc)
# ---------------------------------------------------------------------------


def _env_seconds(name: str, default: float = ...) -> float:
    # typed registry accessor: malformed or <= 0 values warn and keep the
    # default (a zero deadline would make the socket non-blocking)
    from .utils import knobs

    return knobs.get_float(name, default=default)


class SupervisedClient:
    """Sidecar client with connection supervision.

    - every socket operation runs under a per-request DEADLINE; a wedged
      worker yields ``RetryableError("DEADLINE_EXCEEDED...")``, never an
      indefinite block,
    - a connection idle longer than ``heartbeat_s`` is probed with a PING
      before carrying a real op,
    - any transport fault or malformed frame closes the socket; the next
      request reconnects fresh,
    - ``call()`` wraps ``request()`` in the retry orchestrator and
      degrades to the in-process host engine (``_dispatch`` on the CPU)
      when the worker is fatally gone, counted in
      ``sidecar.host_fallbacks``.
    """

    def __init__(self, sock_path: str, deadline_s: float = None, heartbeat_s: float = None):
        self.sock_path = sock_path
        if deadline_s is None:
            deadline_s = _env_seconds(
                "SRJTORCH_SIDECAR_DEADLINE_S",
                _env_seconds("SRJTORCH_SIDECAR_TIMEOUT_SEC"),
            )
        self.deadline_s = float(deadline_s)
        self.heartbeat_s = (
            _env_seconds("SRJTORCH_SIDECAR_HEARTBEAT_S") if heartbeat_s is None
            else float(heartbeat_s)
        )
        self._sock: socket.socket = None
        self._last_io = 0.0
        self._ever_connected = False
        self.reconnects = 0  # REDIALS only
        self.host_fallbacks = 0
        # the legacy single-buffer arena, when the caller maps one: the
        # worker may answer through it, so the client reads ARENA_FLAG
        # responses even for stream requests
        self.arena_mm = None

    # -- connection lifecycle ------------------------------------------------

    def connect(self) -> None:
        from .utils import deadline as deadline_mod, metrics
        from .utils.errors import RetryableError

        d = deadline_mod.current()
        timeout = self.deadline_s
        if d is not None:
            d.check("sidecar.connect")
            timeout = min(timeout, max(d.remaining(), 1e-3))
        self.close()
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        try:
            s.connect(self.sock_path)
        except (OSError, socket.timeout) as e:
            s.close()
            raise RetryableError(f"sidecar: UNAVAILABLE: connect failed ({e})") from e
        if self._ever_connected:
            self.reconnects += 1
            metrics.counter("sidecar.reconnects").inc()
            metrics.event("sidecar.reconnect", sock=self.sock_path)
        self._ever_connected = True
        self._sock = s
        self._last_io = time.monotonic()

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- framed request/response under a deadline ----------------------------

    def _op_budget_s(self, op: int) -> float:
        """Adaptive per-op socket deadline: once an op class has samples
        (``sidecar.op_lat_us.<OP>``), its q99 times the multiplier,
        clamped into [floor, the static deadline]; clamps are counted."""
        from .utils import metrics

        budget, clamped = metrics.adaptive_timeout_s(
            f"sidecar.op_lat_us.{op_name(op)}", self.deadline_s
        )
        if clamped:
            metrics.registry().counter("sidecar.adaptive_timeout_clamps").inc()
        return budget

    def _recv_deadline(self, n: int, deadline: float) -> bytes:
        """Read exactly n bytes under a WHOLE-REQUEST deadline."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("request deadline exhausted")
            self._sock.settimeout(remaining)
            k = self._sock.recv_into(view[got:], min(n - got, _RECV_CHUNK))
            if not k:
                raise ConnectionError("sidecar: peer closed")
            got += k
        return bytes(buf)

    def _raw_request(self, op: int, payload: bytes, arena_len: int = None, region=None):
        """One request/response exchange on the live socket, bounded by one
        per-request deadline (under a deadline scope, ``min(deadline_s,
        remaining budget)``). A transport fault closes the connection and
        raises RetryableError; an exhausted budget raises
        DeadlineExceeded. ``arena_len`` sends a payload resident at
        ``arena_mm[0:arena_len]``; ``region`` (a ``sidecar_pool.ArenaRegion``)
        sends only its 20-byte descriptor."""
        from .utils import deadline as deadline_mod, integrity, tracing
        from .utils.errors import DataCorruption, RetryableError

        d = deadline_mod.current()
        budget_s = self._op_budget_s(op)
        if d is not None:
            d.check(f"sidecar_op_{op}")
            budget_s = min(budget_s, max(d.remaining(), 1e-3))
        deadline = time.monotonic() + budget_s
        use_crc = integrity.is_enabled()
        wire_op = (op | CRC_FLAG) if use_crc else op
        if region is not None:
            wire_op |= ARENA_FLAG
            # checksum the IN-HAND request bytes, never an mmap re-read
            body = region.snapshot_bytes()
            payload = REGION_DESC.pack(region.offset, region.request_id, region.generation)
            plen = len(payload)
        elif arena_len is None:
            body, plen = payload, len(payload)
        else:
            if self.arena_mm is None:
                raise ValueError("arena_len given but no client-side arena is mapped")
            if arena_len > len(self.arena_mm):
                # an oversized arena request engages retry-with-split
                raise RetryableError(
                    f"sidecar: RESOURCE_EXHAUSTED: arena request needs "
                    f"{arena_len} bytes but the mapped arena holds "
                    f"{len(self.arena_mm)} — split the batch or lease a "
                    "larger region"
                )
            wire_op |= ARENA_FLAG
            body, plen, payload = bytes(self.arena_mm[:arena_len]), arena_len, b""
        trailer = integrity.pack_crc(integrity.checksum(body)) if use_crc else b""
        tblob = tracing.wire_context()
        if tblob is not None:
            wire_op |= TRACE_FLAG
        else:
            tblob = b""
        try:
            self._sock.settimeout(budget_s)
            _send_frame(self._sock, struct.pack("<IQ", wire_op, plen) + trailer + tblob, payload)
            hdr = self._recv_deadline(12, deadline)
            status, rlen = struct.unpack("<IQ", hdr)
            resp_crc = (
                integrity.unpack_crc(self._recv_deadline(4, deadline))
                if status & CRC_FLAG
                else None
            )
            if status & ARENA_FLAG:
                if region is not None:
                    if rlen > region.capacity:
                        raise ConnectionError("region-flagged response exceeds the leased region")
                    resp = region.read(rlen)
                elif self.arena_mm is None or rlen > len(self.arena_mm):
                    raise ConnectionError("arena-flagged response without a client-side arena")
                else:
                    resp = bytes(self.arena_mm[:rlen])
            else:
                resp = self._recv_deadline(rlen, deadline) if rlen else b""
        except socket.timeout as e:
            self.close()
            if d is not None and d.done():
                raise d.exceeded(f"sidecar op {op}") from e
            raise RetryableError(
                f"sidecar: DEADLINE_EXCEEDED: op {op} exceeded "
                f"{budget_s:g}s request deadline"
            ) from e
        except (ConnectionError, OSError) as e:
            self.close()
            raise RetryableError(f"sidecar: Socket closed mid-request ({e})") from e
        if resp_crc is not None and integrity.is_enabled():
            from .utils import metrics

            metrics.registry().counter("sidecar.integrity.frames_checked").inc()
            try:
                integrity.verify(resp, resp_crc, "sidecar.response")
            except DataCorruption:
                self.close()
                raise
        self._last_io = time.monotonic()
        return status & ~_FLAG_MASK, resp

    def ping(self) -> str:
        """Heartbeat round-trip; returns the worker's backend name."""
        from .utils import metrics

        metrics.counter("sidecar.heartbeats").inc()
        if self._sock is None:
            self.connect()
        status, resp = self._raw_request(OP_PING, b"")
        if status != STATUS_OK:
            from .utils.errors import RetryableError

            self.close()
            raise RetryableError("sidecar: PING failed (worker unhealthy)")
        return resp.decode()

    def request(self, op: int, payload: bytes, arena_len: int = None, region=None) -> bytes:
        """Supervised exchange: reconnect when needed, heartbeat stale
        connections, classify worker-side errors into the taxonomy. One
        ``sidecar.request`` span per exchange when a traced query is
        active (the worker's span parents to it)."""
        from .utils import tracing

        with tracing.span("sidecar.request", op=op_name(op)):
            return self._request(op, payload, arena_len, region)

    def _request(self, op: int, payload: bytes, arena_len: int = None, region=None) -> bytes:
        from .utils import metrics
        from .utils.errors import DataCorruption, DeadlineExceeded, FatalDeviceError, RetryableError

        if self._sock is None:
            self.connect()
        elif time.monotonic() - self._last_io > self.heartbeat_s:
            try:
                self.ping()
            except RetryableError:
                self.connect()
        armed = metrics.is_enabled()
        # the per-op latency histogram is product state (adaptive
        # deadlines and the pool's health scorer read it), not gated
        t0 = time.perf_counter()
        try:
            status, resp = self._raw_request(op, payload, arena_len, region)
        except Exception as e:
            metrics.counter("sidecar.request_failures").inc()
            if isinstance(e, RetryableError) and "DEADLINE_EXCEEDED" in str(e):
                metrics.registry().histogram(f"sidecar.op_lat_us.{op_name(op)}").record(
                    (time.perf_counter() - t0) * 1e6
                )
            raise
        if status == STATUS_OK:
            metrics.registry().histogram(f"sidecar.op_lat_us.{op_name(op)}").record(
                (time.perf_counter() - t0) * 1e6
            )
        if armed:
            metrics.counter("sidecar.requests").inc()
            metrics.histogram("sidecar.request_us").record((time.perf_counter() - t0) * 1e6)
        if status == STATUS_OK:
            return resp
        msg = resp.decode("utf-8", "replace")
        if status == STATUS_CAST_ERROR:
            raise _cast_error_from_wire(resp)
        if msg.startswith("DataCorruption:"):
            raise DataCorruption(f"sidecar worker: {msg}")
        if msg.startswith("Overloaded:"):
            from .utils.errors import Overloaded

            raise Overloaded(f"sidecar worker: {msg}")
        if msg.startswith("RetryableError:"):
            raise RetryableError(f"sidecar worker: {msg}")
        if msg.startswith("FatalDeviceError:"):
            raise FatalDeviceError(f"sidecar worker: {msg}")
        if msg.startswith("DeadlineExceeded:"):
            raise DeadlineExceeded(f"sidecar worker: {msg}")
        # a semantic error on a healthy transport: not a taxonomy member,
        # so neither the breaker nor retry nor the host degrade engages
        raise RuntimeError(f"sidecar worker: {msg}")  # srjt-lint: allow-raise(semantic wire error on a healthy transport; taxonomy-wrapping would trip the breaker or retry a non-transient failure)

    # -- degrade-to-host orchestration ---------------------------------------

    def call(self, op: int, payload: bytes) -> bytes:
        """Run ``op`` on the worker under the retry orchestrator; degrade
        to the in-process host engine (the CPU) when the worker is gone or
        the breaker is open, counted in ``sidecar.host_fallbacks``. An
        exhausted budget raises DeadlineExceeded up front."""
        from .utils import deadline as deadline_mod, metrics, retry
        from .utils.errors import DeadlineExceeded, DeviceError

        deadline_mod.check(f"sidecar_op_{op}")
        br = breaker()
        if not br.allow():
            self.host_fallbacks += 1
            metrics.counter("sidecar.host_fallbacks").inc()
            metrics.event("sidecar.breaker_fast_fail", op=op_name(op))
            return _dispatch(op, payload, "host-fallback")
        try:
            resp = retry.call_with_retry(self.request, op, payload, op_name=f"sidecar_op_{op}")
        except DeadlineExceeded:
            # a device path that cannot answer within the budget is, for
            # the breaker, unavailable; a cooperative cancel is no verdict
            d = deadline_mod.current()
            if d is not None and d.cancelled() and not d.expired():
                br.abort_probe()
            else:
                br.record_failure(cause="deadline")
            self.close()
            raise
        except DeviceError as e:
            br.record_failure(cause=type(e).__name__)
            self.host_fallbacks += 1
            metrics.counter("sidecar.host_fallbacks").inc()
            metrics.event("sidecar.degrade_to_host", op=op_name(op), cls=type(e).__name__)
            self.close()
            return _dispatch(op, payload, "host-fallback")
        except Exception:
            br.record_success()  # semantic error: the transport is healthy
            raise
        except BaseException:
            br.abort_probe()
            raise
        br.record_success()
        return resp

    # -- observability -------------------------------------------------------

    def worker_stats(self, fold: bool = True, timeout_s: float = None) -> dict:
        """Poll the worker's STATS verb on a THROWAWAY connection under
        its own short deadline (``SRJTORCH_SIDECAR_STATS_TIMEOUT_SEC``);
        with ``fold`` the worker's counters land in this process's
        registry (``sidecar.worker.*`` gauges)."""
        import json

        from .utils import metrics
        from .utils.errors import RetryableError

        if timeout_s is None:
            timeout_s = _env_seconds("SRJTORCH_SIDECAR_STATS_TIMEOUT_SEC")
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(float(timeout_s))
        try:
            s.connect(self.sock_path)
            s.sendall(struct.pack("<IQ", OP_STATS, 0))
            hdr = _recv_exact(s, 12)
            status, rlen = struct.unpack("<IQ", hdr)
            if rlen > (4 << 20):
                raise ConnectionError(f"implausible STATS length {rlen}")
            resp = _recv_exact(s, rlen) if rlen else b""
        except (OSError, ConnectionError) as e:
            raise RetryableError(f"sidecar: UNAVAILABLE: STATS probe failed ({e})") from e
        finally:
            s.close()
        if (status & ~_FLAG_MASK) != STATUS_OK:
            raise RetryableError("sidecar: STATS failed (worker unhealthy)")
        try:
            stats = json.loads(resp.decode("utf-8", "replace"))
        except ValueError as e:
            raise RetryableError(f"sidecar: malformed STATS payload ({e})") from e
        if fold:
            metrics.fold_worker_counters((stats.get("snapshot") or {}).get("counters"))
        return stats


# ---------------------------------------------------------------------------
# the sidecar path's circuit breaker (process-global)
# ---------------------------------------------------------------------------

_BREAKER = None
_BREAKER_LOCK = threading.Lock()


def breaker():
    """The process-global sidecar CircuitBreaker (utils/deadline.py):
    after ``SRJTORCH_BREAKER_THRESHOLD`` consecutive supervision failures
    it opens and ``call`` degrades to the host engine without dialing; a
    half-open probe after ``SRJTORCH_BREAKER_COOLDOWN_SEC`` restores
    device mode on success. Lazy, so knobs are read at first use."""
    global _BREAKER
    if _BREAKER is None:
        with _BREAKER_LOCK:
            if _BREAKER is None:
                from .utils.deadline import CircuitBreaker

                _BREAKER = CircuitBreaker("sidecar.breaker")
    return _BREAKER


def _cast_error_from_wire(resp: bytes):
    from .ops.cast_string import CastError

    if len(resp) < 9:
        from .utils.errors import RetryableError

        return RetryableError("sidecar: malformed cast-error frame (desync)")
    (row,) = struct.unpack_from("<q", resp, 0)
    is_null = resp[8] != 0
    val = None if is_null else resp[9:].decode("utf-8", "replace")
    return CastError(int(row), val)


def _reap_worker(proc) -> None:
    """Terminate and REAP a worker (best effort: spawn cleanup must never
    mask the original startup error)."""
    try:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except Exception:  # srjt-lint: allow-broad-except(best-effort escalation to SIGKILL; reaping must never mask the original startup error)
                proc.kill()
                proc.wait(timeout=10)
        else:
            proc.wait()
    except Exception:  # srjt-lint: allow-broad-except(best-effort reap of a dying child; the caller re-raises the original startup error)
        pass


def spawn_worker(
    sock_path: str = None,
    python_exe: str = None,
    startup_timeout_s: float = 60.0,
    env: dict = None,
    device: str = "cuda",
):
    """Spawn ``python -m spark_rapids_jni_tpu_torch.sidecar --device
    <device>``, wait for its socket, and verify a PING round-trips.
    Returns (Popen, sock_path); the caller owns shutdown. Every failure
    path terminates and reaps the child before re-raising."""
    import subprocess
    import tempfile

    from .utils.errors import FatalDeviceError

    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, got {device!r}")
    if sock_path is None:
        fd, tmp = tempfile.mkstemp(prefix="srjtorch-sidecar-")
        os.close(fd)
        os.unlink(tmp)
        sock_path = tmp + ".sock"
    full_env = dict(os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pp = full_env.get("PYTHONPATH", "")
    if pkg_parent not in pp.split(os.pathsep):
        full_env["PYTHONPATH"] = f"{pkg_parent}{os.pathsep}{pp}" if pp else pkg_parent
    if env:
        full_env.update(env)
    proc = subprocess.Popen(
        [python_exe or sys.executable, "-m", "spark_rapids_jni_tpu_torch.sidecar",
         "--device", device, "--socket", sock_path],
        env=full_env,
    )
    try:
        t_deadline = time.monotonic() + startup_timeout_s
        while True:
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(min(10.0, max(1.0, t_deadline - time.monotonic())))
            try:
                probe.connect(sock_path)
                probe.sendall(struct.pack("<IQ", OP_PING, 0))
                hdr = _recv_exact(probe, 12)
                status, rlen = struct.unpack("<IQ", hdr)
                if rlen:
                    _recv_exact(probe, rlen)
                if (status & ~_FLAG_MASK) != STATUS_OK:
                    raise FatalDeviceError("sidecar worker failed the startup PING handshake")
                return proc, sock_path
            except (OSError, ConnectionError):
                pass  # not listening / not answering yet
            finally:
                probe.close()
            if proc.poll() is not None:
                raise FatalDeviceError(
                    f"sidecar worker exited during startup (rc={proc.returncode})"
                )
            if time.monotonic() > t_deadline:
                raise FatalDeviceError("sidecar worker startup timed out")
            time.sleep(0.05)
    except BaseException:
        _reap_worker(proc)
        raise


def serve(sock_path: str, device: str = "cuda") -> None:
    """Bind ``sock_path`` and serve every connection on its own thread,
    with the ops on ``device``. On the card, the CUDA context comes up
    before READY; without a card the worker exits 2 before READY."""
    import torch

    from .utils import knobs

    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            print("sidecar worker: --device cuda but no CUDA device is available "
                  "(pass --device cpu to serve on the CPU)", file=sys.stderr, flush=True)
            sys.exit(2)
        torch.empty(1, device="cuda")  # the context, before READY
    backend = BACKENDS[device]

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv.bind(sock_path)
    srv.listen(16)
    print(f"{knobs.SIDECAR_READY} backend={backend}", flush=True)

    def shutdown():
        # client-initiated: unlink before the hard exit so no stale
        # socket file outlives the worker
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass
        # os._exit skips atexit: an armed lockdep must persist the
        # worker's lock-order graph NOW or the merge gate never sees the
        # worker side of the package's locks
        from .analysis import lockdep as _lockdep

        _lockdep.flush_report()
        os._exit(0)

    try:
        while True:
            conn, _ = srv.accept()
            t = threading.Thread(target=_handle_conn, args=(conn, backend, shutdown), daemon=True)
            t.start()
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m spark_rapids_jni_tpu_torch.sidecar")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--device", choices=sorted(BACKENDS), default="cuda",
                    help="where the ops run (default: the card; cpu only when asked)")
    args = ap.parse_args(argv)
    serve(args.socket, args.device)


if __name__ == "__main__":
    sys.exit(main())
