"""Shuffle: the hash partition, the in-mesh all-to-all exchange and the
cross-process TCP exchange (port of the JAX package's
``parallel/shuffle.py``).

``hash_partition`` is the single-device shuffle write. The exchange
repartitions row-sharded arrays over the mesh's data axis: each shard
scatters its rows into a [P, capacity] bucket matrix and an occupancy
mask, ``mesh.all_to_all`` swaps the bucket axes, and every receiver gets
[P, capacity] from each peer. ``capacity`` bounds the rows one shard may
send to one destination. An overflow raises ``RetryableError`` by
default; ``on_overflow="flag"`` hands back the flag for callers that
manage capacity, and ``on_overflow="retry"`` doubles the capacity and
re-executes until every row lands (bounded by the rows a shard holds).

Integrity: while ``utils/integrity`` checks are on (the default), a
completed exchange verifies an order-independent checksum, the
wraparound u64 sum of every lane's bit pattern (each value zero-extended
from its width, a bool as one byte), and the occupied slots against the
rows sent; a mismatch raises retryable ``DataCorruption``.

Runtime: the three ops cross ``op_boundary``. With metrics armed, an
exchange counts ``shuffle.bytes_exchanged`` (the capacity-padded bytes
every attempt moved), ``shuffle.exchanges`` and the ``shuffle.exchange_us``
histogram; a capacity doubling is a deadline cancel point and counts in
``retry.record_capacity_retry`` (``shuffle.capacity_retries``). With the
memory governor armed, a doubled capacity's footprint passes
``memgov.ensure_fits`` first: it spills cold catalog entries or raises
the retryable ``MemoryBudgetExceeded`` (the split path).

Cross-process exchange: ``TcpExchange`` moves hash partitions between
runtimes in separate processes as columnar frames (``columnar/frames``)
over plain TCP, with the reference's wire format byte for byte. It is
pull-based: each rank serves the partitions it published, and the fetch
side carries the deadline, retry, a per-peer breaker and the frame CRCs.
A cluster generation fences every request once a ``cluster.ClusterView``
is attached. The server threads only send bytes that ``publish`` already
encoded on the caller's thread; a fetched frame is decoded onto the
exchange's device (``device=None`` means the card).
``SRJTORCH_EXCHANGE_MODE`` (``mesh`` or ``tcp``) is read by callers
that pick a transport; the in-mesh functions above ignore it. The worker
harness, ``python -m spark_rapids_jni_tpu_torch.parallel.shuffle
--exchange-worker --device cpu|cuda ...``, is one rank of a distributed
group-by; ``spawn_exchange_peer`` and ``spawn_exchange_fleet`` start it.
"""

from __future__ import annotations

import os
import socket as socket_mod
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import memgov
from ..columnar import Table
from ..columnar import frames as frames_mod
from ..columnar.dtype import TypeId
from ..ops.copying import gather
from ..ops.hashing import hash_partition_map
from ..ops.uword import MASK32, split_u64
from ..utils import deadline, faultinj, integrity, knobs, metrics, retry, tracing
from ..utils.errors import RetryableError
from ..utils.memory import exchange_bytes_estimate
from . import mesh as mesh_mod
from ..utils.dispatch import op_boundary

__all__ = [
    "hash_partition",
    "all_to_all_exchange",
    "exchange_by_key",
    "exchange_mode",
    "TcpExchange",
    "exchange_breaker",
    "spawn_exchange_peer",
]

_ON_OVERFLOW = ("raise", "flag", "retry")


@op_boundary("hash_partition")
def hash_partition(table: Table, num_partitions: int,
                   key_cols: Sequence[str]) -> Tuple[Table, List[int]]:
    """Single-device cudf-style hash_partition: rows reordered so that
    each partition is contiguous (rows keep their order within one);
    returns (table, partition start offsets). One INT32 or INT64 key
    column runs B1."""
    pmap = hash_partition_map([table.column(c) for c in key_cols], num_partitions)
    order = torch.argsort(pmap, stable=True)
    out = gather(table, order)
    counts = torch.bincount(pmap, minlength=num_partitions)
    offsets = torch.cumsum(counts, 0) - counts
    return out, offsets.tolist()


_NARROW = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF), 4: (torch.int32, MASK32)}
_MASK64 = (1 << 64) - 1


def _exchange_checksum(arrays) -> int:
    """Order-independent payload checksum of an exchange: the wraparound
    u64 sum of every lane's bit pattern, each value zero-extended from its
    width (a bool as one byte). Unoccupied bucket slots are zero and add
    nothing, so the sum over the padded receive buffers equals the sum over
    the dense send payload exactly when every row landed intact. A 64-bit
    lane sums its u32 halves apart, so no partial sum leaves int64; one
    host read for all the arrays."""
    parts = []  # (0-d int64 sum, its weight as a left shift)
    for a in arrays:
        a = a.contiguous().reshape(-1)
        w = a.element_size()
        if w == 8:
            lo, hi = split_u64(a.view(torch.int64))
            parts += [((lo.to(torch.int64) & MASK32).sum(), 0),
                      ((hi.to(torch.int64) & MASK32).sum(), 32)]
        else:
            t, mask = _NARROW[w]
            v = a.view(torch.uint8) if a.dtype == torch.bool else a.view(t)
            parts.append(((v.to(torch.int64) & mask).sum(), 0))
    if not parts:
        return 0
    dev = parts[0][0].device
    vals = torch.stack([s.to(dev) for s, _ in parts]).tolist()
    return sum(v << sh for v, (_, sh) in zip(vals, parts)) & _MASK64


class _Plan:
    """Where one shard's rows go in its [P, capacity] buckets: the stable
    order by destination, each sorted row's flat slot (``P * capacity``,
    the trash slot, for a row past its bucket's capacity), the occupancy
    mask and the overflow flag (a 0-d bool tensor)."""

    def __init__(self, dest: torch.Tensor, n_parts: int, capacity: int):
        n = dest.shape[0]
        dev = dest.device
        self.shape = (n_parts, capacity)
        self.order = torch.argsort(dest, stable=True)
        d_sorted = dest[self.order].to(torch.int64)
        run_start = torch.searchsorted(
            d_sorted, torch.arange(n_parts, dtype=torch.int64, device=dev), side="left")
        slot = (torch.arange(n, dtype=torch.int64, device=dev)
                - run_start[d_sorted.clamp(0, n_parts - 1)])
        self.overflow = (slot >= capacity).any()
        # overflowing rows go to the trash slot and are dropped, never
        # aliasing the legitimate occupant of the last slot
        keep = (slot < capacity) & (d_sorted >= 0) & (d_sorted < n_parts)
        self.flat = torch.where(keep, d_sorted * capacity + slot, n_parts * capacity)
        self.mask = self.scatter(torch.ones((n,), dtype=torch.bool, device=dev), ordered=True)

    def scatter(self, vals: torch.Tensor, ordered: bool = False) -> torch.Tensor:
        """[n, ...] rows -> [P, capacity, ...] buckets (zeros where empty)."""
        p, cap = self.shape
        out = vals.new_zeros((p * cap + 1,) + tuple(vals.shape[1:]))
        out[self.flat] = vals if ordered else vals[self.order]
        return out[:-1].reshape((p, cap) + tuple(vals.shape[1:]))


def _bucketize(vals: torch.Tensor, dest: torch.Tensor, n_parts: int, capacity: int):
    """Per-shard scatter of [n] rows into [P, capacity] buckets. Returns
    (buckets, mask, overflow). Rows beyond capacity for their destination
    are dropped and flagged."""
    plan = _Plan(dest, n_parts, capacity)
    return plan.scatter(vals), plan.mask, plan.overflow


def _exchange_shards(lane_shards, dests, n_parts: int, capacity: int):
    """The shards' side of an exchange at a fixed capacity.
    ``lane_shards[l][s]`` is lane l's rows on shard s and ``dests[s]``
    their destination shards. Returns (``received[l][d]``, the [P *
    capacity, ...] rows shard d received of lane l, source-major;
    ``masks[d]``, their occupancy; ``overflow[s]``, 0-d flags)."""
    plans = [_Plan(d, n_parts, capacity) for d in dests]
    received = []
    for shards in lane_shards:
        recv = mesh_mod.all_to_all([pl.scatter(x) for pl, x in zip(plans, shards)])
        received.append([r.reshape((-1,) + tuple(r.shape[2:])) for r in recv])
    masks = [r.reshape(-1) for r in mesh_mod.all_to_all([pl.mask for pl in plans])]
    return received, masks, [pl.overflow for pl in plans]


def _exchange_once(arrays, dest, mesh, axis: str, capacity: int, n_parts: int):
    """One all-to-all at a fixed capacity: (received [P * P, capacity, ...]
    each, received mask [P * P, capacity], overflow [P])."""
    home = mesh.home(axis)
    received, masks, ovf = _exchange_shards(
        [mesh_mod.shard_rows(a, mesh, axis) for a in arrays],
        mesh_mod.shard_rows(dest, mesh, axis), n_parts, capacity)

    def glob(parts):  # the global [P * P, capacity, ...] view
        return mesh_mod.cat(parts, home).reshape((n_parts * n_parts, capacity)
                                                 + tuple(parts[0].shape[1:]))

    overflow = torch.stack([o.to(home) for o in ovf])
    return [glob(r) for r in received], glob(masks), overflow


def _check_on_overflow(on_overflow: str) -> None:
    if on_overflow not in _ON_OVERFLOW:
        raise ValueError(
            f"on_overflow must be 'raise', 'flag', or 'retry', got {on_overflow!r}"
        )


@op_boundary("all_to_all_exchange")
def all_to_all_exchange(
    arrays: Sequence[torch.Tensor],
    dest: torch.Tensor,
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    on_overflow: str = "raise",
):
    """Exchange row-sharded arrays so that row i lands on shard dest[i].

    ``arrays``: global [N, ...] tensors, row-sharded along ``axis``;
    ``dest``: [N] int32 in [0, P). Returns (received, recv_mask, overflow):
    each received array is [P * P, capacity, ...] (shard d's [P, capacity]
    block from every source, shards in order), ``recv_mask`` marks the
    occupied slots and ``overflow`` is [P] bool, one flag a shard. The
    defaulted capacity (the rows a shard holds) cannot overflow."""
    _check_on_overflow(on_overflow)
    if capacity is not None and capacity < 1:
        # capacity 0 would make the doubling a fixed point
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    n_parts = mesh.shape[axis]
    n_global = dest.shape[0]
    per_shard = n_global // n_parts
    if capacity is None:
        capacity = per_shard  # safe: one shard can absorb everything
    armed = metrics.is_enabled()
    governed = on_overflow == "retry" and memgov.is_enabled()
    checked = integrity.is_enabled()
    sent_sum = _exchange_checksum(arrays) if checked else None
    # per-GLOBAL-ROW wire cost: the exchange moves capacity-padded
    # [P, capacity] buckets a shard for each array (not the dense rows)
    # plus the 1-byte occupancy mask a slot; it changes every time the
    # escalation doubles the capacity. One cost model: the wire
    # accounting and the governor's escalation estimate read it
    row_bytes = (
        sum(a.element_size() * a.numel() // max(a.shape[0], 1) for a in arrays) + 1
        if armed or governed else 0
    )
    t0 = time.perf_counter() if armed else 0.0
    wire_bytes = 0
    while True:
        received, recv_mask, overflow = _exchange_once(
            arrays, dest, mesh, axis, int(capacity), n_parts
        )
        if armed:
            # bytes THIS execution moved (an overflowed attempt moved its
            # buckets too)
            attempt_bytes = n_parts * n_parts * int(capacity) * row_bytes
            wire_bytes += attempt_bytes
            metrics.counter("shuffle.bytes_exchanged").inc(attempt_bytes)
        overflowed = bool(overflow.any())
        if not overflowed or on_overflow == "flag":
            if checked and not overflowed:
                # a flagged overflow dropped rows on purpose (the caller's
                # recompute contract); only complete exchanges are verified
                metrics.registry().counter("sidecar.integrity.exchanges_checked").inc()
                recv_sum = _exchange_checksum(received)
                recv_rows = int(recv_mask.sum())
                if recv_sum != sent_sum or recv_rows != int(n_global):
                    raise integrity.raise_corruption(
                        "shuffle.exchange",
                        f"sent 0x{sent_sum:016x}/{int(n_global)} rows != "
                        f"recv 0x{recv_sum:016x}/{recv_rows} rows",
                    )
            if armed:
                elapsed = time.perf_counter() - t0
                metrics.counter("shuffle.exchanges").inc()
                metrics.histogram("shuffle.exchange_us").record(elapsed * 1e6)
                metrics.event(
                    "shuffle.exchange", axis=axis, n_parts=n_parts,
                    capacity=int(capacity), wire_bytes=wire_bytes,
                    wall_us=round(elapsed * 1e6, 1), overflow=overflowed,
                )
            return received, recv_mask, overflow
        if on_overflow == "retry" and capacity < per_shard:
            # a cancel point between attempts: no escalated re-execution
            # starts once the query's budget is gone
            deadline.check("all_to_all_exchange.capacity_retry")
            # geometric escalation: at most ceil(log2(per_shard / cap0))
            # re-executions before the capacity that cannot overflow
            new_capacity = min(2 * int(capacity), per_shard)
            # the doubled bucket matrices are a footprint the op's
            # admission never covered: the governor grows the held
            # admission, spills cold catalog entries, or refuses
            if governed:
                memgov.ensure_fits(
                    exchange_bytes_estimate(row_bytes, n_parts, int(new_capacity)),
                    "all_to_all_exchange.capacity_retry",
                )
            metrics.event(
                "shuffle.capacity_escalation", axis=axis,
                capacity=int(capacity), new_capacity=int(new_capacity),
            )
            capacity = new_capacity
            retry.record_capacity_retry()
            continue
        raise RetryableError(
            f"all_to_all_exchange: a destination shard received more than "
            f"capacity={capacity} rows; retry with a larger capacity "
            f"(rows would otherwise be dropped)"
        )


@op_boundary("exchange_by_key")
def exchange_by_key(
    table: Table,
    key_cols: Sequence[str],
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    on_overflow: str = "raise",
):
    """Hash-repartition a row-sharded fixed-width Table over the mesh.

    Returns (pairs_by_column, recv_mask, overflow), each pair (data,
    validity or None) in ``all_to_all_exchange``'s received layout: null
    masks travel with their column. Rows of one key all land on one shard
    (``hash_partition_map``, so one INT32 or INT64 key runs B1)."""
    _check_on_overflow(on_overflow)
    for c in table.columns:
        if c.dtype.id in (TypeId.STRING, TypeId.LIST):
            raise ValueError(
                "exchange_by_key moves fixed-width payloads; use "
                "parallel.table_ops.exchange_table, which dictionary-encodes "
                "string columns automatically"
            )
    dest = hash_partition_map([table.column(c) for c in key_cols], mesh.shape[axis])
    arrays: List[torch.Tensor] = []
    has_validity: List[bool] = []
    for c in table.columns:
        arrays.append(c.data)
        has_validity.append(c.validity is not None)
        if c.validity is not None:
            arrays.append(c.validity)
    received, recv_mask, overflow = all_to_all_exchange(
        arrays, dest.to(torch.int32), mesh, axis, capacity, on_overflow=on_overflow
    )
    pairs = []
    it = iter(received)
    for nullable in has_validity:
        data = next(it)
        pairs.append((data, next(it) if nullable else None))
    return pairs, recv_mask, overflow


# ---------------------------------------------------------------------------
# the cross-process TCP exchange: hash partitions as columnar frames
# between runtimes in separate processes, pull-based so that the deadline,
# retry, the breaker and the CRC ride the fetch side
# ---------------------------------------------------------------------------

_EXC_MAGIC = b"SRJTEXC1"
_EXC_REQ = struct.Struct("<8sIII")  # magic, verb, epoch, part
_EXC_RESP = struct.Struct("<IQ")  # status, payload length
_EXC_GET = 1
# a GET whose request carries a 17-byte trace context
# (utils/tracing.wire_context) right after the header, so that the serving
# peer's span parents to the fetcher's across the process boundary
_EXC_GET_TRACED = 3
# generation-fenced GETs carry the requester's 4-byte cluster generation
# after the header (after the trace blob on the traced verb). The server
# answers _EXC_STALE on a mismatch in either direction, and a fenced OK
# prefixes the server's generation to the frame, so that the fetcher
# checks it before a payload byte reaches the decoder.
_EXC_GET_FENCED = 4
_EXC_GET_FENCED_TRACED = 5
# liveness probe (cluster.ClusterView heartbeats): the request's epoch
# field carries the sender's generation, its part field the sender's rank;
# the answer is _EXC_OK with the responder's 4-byte generation
_EXC_PING = 6
_EXC_GEN = struct.Struct("<I")  # the 4-byte generation blob
_EXC_OK = 0
_EXC_RETRY = 1  # partition not (yet) published here: retryable
_EXC_ERR = 2
_EXC_STALE = 3  # generation fence mismatch: retryable desync

# epoch strides: the tree plan keys round j's frames at ``epoch + (j+1) *
# _TREE_EPOCH_STRIDE`` and a recovery republish lands at ``epoch +
# (dead_rank+1) * _RECOVERY_EPOCH_STRIDE``, far above any caller's epochs
_TREE_EPOCH_STRIDE = 1 << 16
_RECOVERY_EPOCH_STRIDE = 1 << 24

_VERBS = (_EXC_GET, _EXC_GET_TRACED, _EXC_GET_FENCED, _EXC_GET_FENCED_TRACED, _EXC_PING)


def exchange_mode() -> str:
    """``SRJTORCH_EXCHANGE_MODE``: ``mesh`` (default, the in-process
    collective) or ``tcp`` (cross-process ``TcpExchange`` frames). Read by
    callers that choose a transport, such as the ``--exchange-worker``
    harness; the in-mesh functions of this module ignore it. An unknown
    value warns and keeps ``mesh``."""
    return knobs.get_str("SRJTORCH_EXCHANGE_MODE")


_EXC_BREAKERS: Dict[str, object] = {}
_EXC_BREAKER_LOCK = threading.Lock()


class _AllExchangeBreakers:
    """The no-argument ``exchange_breaker()`` facade: its operations fan
    out to every per-peer breaker."""

    @staticmethod
    def _all():
        with _EXC_BREAKER_LOCK:
            return list(_EXC_BREAKERS.values())

    def reset(self) -> None:
        for br in self._all():
            br.reset()

    def snapshot(self) -> Dict[str, dict]:
        with _EXC_BREAKER_LOCK:
            return {addr: br.snapshot() for addr, br in _EXC_BREAKERS.items()}


def exchange_breaker(addr: Optional[str] = None):
    """The TCP exchange's breaker for peer ``addr``: each peer address owns
    one, so that a dead rank fast-fails its own fetches while pulls from
    healthy peers flow. Consecutive fetch failures open it; a half-open
    probe after the cooldown restores the path. Its states land under
    ``shuffle.exchange.breaker.<peer>.*``. With no ``addr``, a facade whose
    ``reset()`` / ``snapshot()`` cover every peer's breaker."""
    if addr is None:
        return _AllExchangeBreakers()
    with _EXC_BREAKER_LOCK:
        br = _EXC_BREAKERS.get(addr)
        if br is None:
            # dots and colons would collide with the metric namespace
            peer = addr.replace(".", "-").replace(":", "_")
            br = deadline.CircuitBreaker(f"shuffle.exchange.breaker.{peer}")
            _EXC_BREAKERS[addr] = br
        return br


def _parse_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _recv_exact_tcp(sock, n: int, until: float) -> bytes:
    """Read exactly n bytes before the monotonic time ``until``: the socket
    timeout shrinks to the remaining budget on every read."""
    buf = bytearray()
    while len(buf) < n:
        remaining = until - time.monotonic()
        if remaining <= 0:
            raise socket_mod.timeout("exchange deadline exhausted")
        sock.settimeout(remaining)
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("exchange: peer closed")
        buf.extend(chunk)
    return bytes(buf)


class TcpExchange:
    """One runtime's end of the cross-process exchange: a server that
    publishes this rank's outgoing partitions (each encoded once as a
    columnar frame) and a fetch client that pulls this rank's incoming
    partitions from its peers under deadline, retry, breaker and CRC.

    Keys are ``(epoch, part)``: an epoch is one exchange round, ``part``
    the destination rank. A fetch of a partition not yet published waits
    on the server (for ``publish_wait_s`` at most) and then answers
    retryably, so start-up races cost latency, never wrong answers. Chaos
    hooks: every served GET crosses ``faultinj.maybe_inject("exchange.serve")``
    and, between the response header and its payload,
    ``"exchange.serve.payload"``; every response frame crosses
    ``faultinj.maybe_corrupt("exchange.frame", ...)`` after encoding, which
    the fetcher's decode must catch. Fetched frames are decoded onto
    ``device`` (None means the card)."""

    def __init__(self, rank: int, bind: str = "127.0.0.1:0",
                 deadline_s: Optional[float] = None,
                 publish_wait_s: float = 10.0,
                 retain_epochs: Optional[int] = None,
                 device=None):
        from ..columnar.column import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the pull and recovery threads name the card explicitly
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.rank = int(rank)
        if deadline_s is None:
            deadline_s = knobs.get_float("SRJTORCH_EXCHANGE_TIMEOUT_SEC")
        self.deadline_s = float(deadline_s)
        self.publish_wait_s = float(publish_wait_s)
        if retain_epochs is None:
            retain_epochs = knobs.get_int("SRJTORCH_EXCHANGE_RETAIN_EPOCHS")
        # publish() evicts the epochs published before the retain_epochs
        # most recently published ones: a long-lived runtime keeps no round
        # forever, while a respawned peer's republish window stays servable
        self.retain_epochs = max(int(retain_epochs), 1)
        self._frames: Dict[Tuple[int, int], bytes] = {}
        self._epochs: Dict[int, None] = {}  # published epochs, the most recent last
        self._lock = threading.Lock()
        self._published = threading.Condition(self._lock)
        self._closed = False
        # the generation fence: None is unfenced (the plain wire protocol);
        # an attached ClusterView keeps it equal to its generation
        self._generation: Optional[int] = None
        host, port = _parse_addr(bind)
        self._srv = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_STREAM)
        self._srv.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.address = "%s:%d" % self._srv.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"srjtorch-exchange-r{self.rank}")
        self._accept_thread.start()

    # -- the generation fence ------------------------------------------------

    def set_generation(self, generation: Optional[int]) -> None:
        """Install the cluster generation this exchange serves and fetches
        under (None disarms the fence). The ClusterView calls it on attach
        and on every bump; a peer still fetching under an older generation
        is answered ``_EXC_STALE`` instead of bytes."""
        with self._lock:
            self._generation = None if generation is None else int(generation)

    def generation(self) -> Optional[int]:
        with self._lock:
            return self._generation

    # -- server side ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn) -> None:
        try:
            conn.settimeout(self.deadline_s)  # bounds every read below
            while True:
                # the header, then the trace blob and the generation, which
                # are read whatever this side arms, so that the stream stays
                # framed; a closed peer or a failed read ends the connection
                req, need = b"", _EXC_REQ.size
                try:
                    while len(req) < need:
                        chunk = conn.recv(need - len(req))
                        if not chunk:
                            return
                        req += chunk
                        if len(req) == _EXC_REQ.size:
                            magic, verb, epoch, part = _EXC_REQ.unpack(req)
                            if magic != _EXC_MAGIC or verb not in _VERBS:
                                conn.sendall(_EXC_RESP.pack(_EXC_ERR, 0))
                                return
                            need += (tracing.TRACE_CTX_LEN if verb in (
                                _EXC_GET_TRACED, _EXC_GET_FENCED_TRACED) else 0) + (
                                _EXC_GEN.size if verb in (
                                    _EXC_GET_FENCED, _EXC_GET_FENCED_TRACED) else 0)
                except OSError:  # socket.timeout included
                    return
                if verb == _EXC_PING:
                    # a PING never gates on the fence; the answer carries
                    # our generation so that the prober learns of a bump
                    conn.sendall(_EXC_RESP.pack(_EXC_OK, _EXC_GEN.size)
                                 + _EXC_GEN.pack(self.generation() or 0))
                    continue
                at, tctx, req_gen = _EXC_REQ.size, None, None
                if verb in (_EXC_GET_TRACED, _EXC_GET_FENCED_TRACED):
                    tctx = tracing.decode_wire_context(req[at:at + tracing.TRACE_CTX_LEN])
                    at += tracing.TRACE_CTX_LEN
                if verb in (_EXC_GET_FENCED, _EXC_GET_FENCED_TRACED):
                    (req_gen,) = _EXC_GEN.unpack(req[at:at + _EXC_GEN.size])
                if tctx is not None and tracing.is_enabled():
                    # the serving half of the cross-process trace, logged here
                    with tracing.remote_scope(*tctx):
                        with tracing.span("exchange.serve", epoch=int(epoch), part=int(part),
                                          rank=self.rank):
                            self._answer_get(conn, epoch, part, req_gen)
                else:
                    self._answer_get(conn, epoch, part, req_gen)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _answer_get(self, conn, epoch: int, part: int, req_gen: Optional[int] = None) -> None:
        """Answer one GET: enforce the fence, wait (bounded) for the
        partition to be published, then send it, or a retryable
        not-yet-published or stale-generation status."""
        if faultinj.is_enabled():
            # `crash` kills the serving process mid-request, `delay` models
            # a slow peer
            faultinj.maybe_inject("exchange.serve")
        own = self.generation()
        if req_gen is not None and (own is None or own != req_gen):
            # a zombie server must not feed a current client, nor a zombie
            # client be fed: zero payload bytes, our generation in the answer
            metrics.registry().counter("cluster.stale_generation_refused").inc()
            conn.sendall(_EXC_RESP.pack(_EXC_STALE, _EXC_GEN.size) + _EXC_GEN.pack(own or 0))
            return
        with self._published:
            end = time.monotonic() + self.publish_wait_s
            blob = self._frames.get((epoch, part))
            while blob is None and not self._closed:
                left = end - time.monotonic()
                if left <= 0:
                    break
                self._published.wait(left)
                blob = self._frames.get((epoch, part))
        if blob is None:
            conn.sendall(_EXC_RESP.pack(_EXC_RETRY, 0))
            return
        wire = blob
        if faultinj.is_enabled():
            # flips bytes after the frame and its CRCs were encoded
            wire = faultinj.maybe_corrupt("exchange.frame", blob)
        prefix = b"" if req_gen is None else _EXC_GEN.pack(own)
        header = _EXC_RESP.pack(_EXC_OK, len(prefix) + len(wire)) + prefix
        if faultinj.is_enabled():
            # two writes, so that a `crash` rule on exchange.serve.payload
            # kills this process between the header and the payload: the
            # fetcher must call that UNAVAILABLE, never corruption
            conn.sendall(header)
            faultinj.maybe_inject("exchange.serve.payload")
            conn.sendall(wire)
        else:
            conn.sendall(header + wire)
        metrics.counter("shuffle.tcp.bytes_out").inc(len(wire))

    def publish(self, epoch: int, partitions: Dict[int, Table]) -> None:
        """Encode and expose this rank's outgoing partitions for ``epoch``
        (one frame a destination rank, column CRCs under the integrity
        gate). A card table is copied to the host here, on the caller's
        thread. Idempotent a key: a respawned peer republishing identical
        partitions changes nothing.

        Eviction keeps the ``retain_epochs`` most recently published
        epochs. The reference keeps the numerically largest ones instead,
        so a worker's result, published at a small epoch after tree rounds
        whose frames sit at ``epoch + (j+1) * 2^16``, is evicted the moment
        it is published once two rounds ran; in publish order, the rounds
        the reference's tests publish evict alike."""
        encoded = {(int(epoch), int(part)): frames_mod.encode_table(t)
                   for part, t in partitions.items()}
        evicted = 0
        with self._published:
            self._frames.update(encoded)
            for e in {e for e, _ in encoded}:
                self._epochs.pop(e, None)
                self._epochs[e] = None
            for old in list(self._epochs)[: max(len(self._epochs) - self.retain_epochs, 0)]:
                del self._epochs[old]
                stale = [k for k in self._frames if k[0] == old]
                for k in stale:
                    del self._frames[k]
                evicted += len(stale)
            self._published.notify_all()
        metrics.counter("shuffle.tcp.published").inc(len(encoded))
        if evicted:
            metrics.counter("shuffle.tcp.frames_evicted").inc(evicted)

    def drop_epoch(self, epoch: int) -> int:
        """Release one round's published frames; returns how many."""
        with self._published:
            self._epochs.pop(int(epoch), None)
            stale = [k for k in self._frames if k[0] == int(epoch)]
            for k in stale:
                del self._frames[k]
        return len(stale)

    # -- fetch side ----------------------------------------------------------

    def _fetch_once(self, addr: str, epoch: int, part: int) -> Table:
        """One fetch attempt, the unit the retry orchestrator re-runs.
        Transport faults and not-yet-published answers raise
        RetryableError; a frame whose bytes rotted raises retryable
        DataCorruption from the decoder; an exhausted query budget raises
        DeadlineExceeded (never a raw socket timeout)."""
        from ..utils.errors import FatalDeviceError

        d = deadline.current()
        # adaptive fetch deadline: the observed q99 x a multiplier once
        # warm, clamped into [floor, SRJTORCH_EXCHANGE_TIMEOUT_SEC]; the
        # query budget clamps below
        budget_s, clamped = metrics.adaptive_timeout_s("shuffle.tcp.fetch_lat_us", self.deadline_s)
        if clamped:
            metrics.registry().counter("shuffle.tcp.adaptive_timeout_clamps").inc()
        if d is not None:
            d.check("tcp_exchange_fetch")
            budget_s = min(budget_s, max(d.remaining(), 1e-3))
        until = time.monotonic() + budget_s
        t0 = time.monotonic()
        lat_hist = metrics.registry().histogram("shuffle.tcp.fetch_lat_us")
        host, port = _parse_addr(addr)
        s = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_STREAM)
        # fenced verbs whenever a generation is installed; the OK answer's
        # echo is checked below before any byte reaches the decoder
        gen = self.generation()
        phase = "connect"
        try:
            s.settimeout(budget_s)
            tblob = tracing.wire_context()
            if gen is None:
                verb = _EXC_GET if tblob is None else _EXC_GET_TRACED
                gblob = b""
            else:
                verb = _EXC_GET_FENCED if tblob is None else _EXC_GET_FENCED_TRACED
                gblob = _EXC_GEN.pack(gen)
            try:
                # netsplit chaos: a `netsplit` rule on exchange.connect
                # (optionally @r<N>) raises ConnectionRefusedError inside the
                # handler that classifies real refused connects
                if faultinj.is_enabled():
                    faultinj.maybe_inject("exchange.connect")
                s.connect((host, port))
                s.sendall(_EXC_REQ.pack(_EXC_MAGIC, verb, epoch, part) + (tblob or b"") + gblob)
                phase = "header"
                status, blen = _EXC_RESP.unpack(_recv_exact_tcp(s, _EXC_RESP.size, until))
                phase = "payload"
                blob = _recv_exact_tcp(s, blen, until) if blen else b""
            except socket_mod.timeout as e:
                # the timed-out wait is a latency sample too, so that a
                # tight adaptive clamp corrects itself upward
                lat_hist.record((time.monotonic() - t0) * 1e6)
                if d is not None and d.done():
                    raise d.exceeded("tcp exchange fetch") from e
                raise RetryableError(
                    f"shuffle exchange: DEADLINE_EXCEEDED: fetch of (epoch {epoch}, part {part}) "
                    f"from {addr} exceeded {budget_s:g}s") from e
            except OSError as e:  # ConnectionError included
                # a peer that died before or while framing its answer is
                # UNAVAILABLE, not corruption: no frame was accepted
                raise RetryableError(
                    f"shuffle exchange: UNAVAILABLE: peer {addr} reset before completing "
                    f"frame ({phase}: {e})") from e
        finally:
            s.close()
        if status == _EXC_STALE:
            # the peer lives in another generation; retryable, and the
            # retry reads the installed generation again
            peer_gen = _EXC_GEN.unpack(blob)[0] if blob else 0
            metrics.registry().counter("cluster.stale_generation_rejects").inc()
            raise RetryableError(
                f"shuffle exchange: DESYNC: generation fence mismatch with peer {addr} (ours "
                f"{gen}, peer {peer_gen}) for (epoch {epoch}, part {part})")
        if status == _EXC_RETRY:
            raise RetryableError(
                f"shuffle exchange: UNAVAILABLE: peer {addr} has not published (epoch {epoch}, "
                f"part {part}) yet")
        if status != _EXC_OK:
            # the peer rejected our magic or verb: a misaddressed or
            # version-skewed peer fails the same way on every attempt
            raise FatalDeviceError(
                f"shuffle exchange: peer {addr} answered error status {status} (protocol "
                "mismatch: wrong service or version-skewed peer?)")
        if gen is not None:
            # the fenced OK's server generation, checked before the decoder
            if len(blob) < _EXC_GEN.size:
                raise RetryableError(
                    f"shuffle exchange: UNAVAILABLE: peer {addr} reset before completing frame "
                    "(fence prefix truncated)")
            (srv_gen,) = _EXC_GEN.unpack(blob[:_EXC_GEN.size])
            if srv_gen != gen:
                metrics.registry().counter("cluster.stale_generation_rejects").inc()
                raise RetryableError(
                    f"shuffle exchange: DESYNC: peer {addr} answered under generation {srv_gen}, "
                    f"ours is {gen}; stale bytes rejected undecoded")
            blob = blob[_EXC_GEN.size:]
        lat_hist.record((time.monotonic() - t0) * 1e6)
        metrics.counter("shuffle.tcp.bytes_in").inc(len(blob))
        # decode checks the frame header and every column CRC
        return frames_mod.decode_table(blob, where="shuffle.exchange", device=self.device)

    def fetch(self, addr: str, epoch: int, part: int) -> Table:
        """Pull one partition from ``addr`` under retry, breaker and
        deadline. Corruption and transport faults retry; exhaustion records
        a breaker failure and re-raises. One ``exchange.fetch`` span covers
        every attempt; each attempt carries the trace context to the peer."""
        with tracing.span("exchange.fetch", peer=addr, epoch=int(epoch), part=int(part)):
            return self._fetch_impl(addr, epoch, part)

    def _fetch_impl(self, addr: str, epoch: int, part: int) -> Table:
        from ..utils.errors import DeadlineExceeded

        br = exchange_breaker(addr)
        if not br.allow():
            raise RetryableError(
                f"shuffle exchange: UNAVAILABLE: exchange breaker open (peer {addr})")
        t0 = time.perf_counter()
        try:
            table = retry.call_with_retry(self._fetch_once, addr, epoch, part,
                                          op_name="tcp_exchange_fetch")
        except DeadlineExceeded:
            br.record_failure(cause="deadline")
            raise
        except RetryableError:
            br.record_failure(cause="unavailable")
            raise
        except BaseException:
            br.abort_probe()
            raise
        br.record_success()
        metrics.counter("shuffle.tcp.fetches").inc()
        metrics.histogram("shuffle.tcp.fetch_us").record((time.perf_counter() - t0) * 1e6)
        return table

    def ping(self, addr: str, timeout_s: float) -> int:
        """One liveness probe: PING ``addr`` and return the responder's
        generation (0 is unfenced). Raises on any transport fault; it runs
        outside the breaker and the retry on purpose, so that a probe
        measures the peer and not the recovery machinery."""
        host, port = _parse_addr(addr)
        budget = max(float(timeout_s), 1e-3)
        until = time.monotonic() + budget
        gen = self.generation()
        s = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_STREAM)
        try:
            s.settimeout(budget)
            if faultinj.is_enabled():
                # the fetch path's netsplit choke point: a partitioned
                # rank's heartbeats fail as its fetches do
                faultinj.maybe_inject("exchange.connect")
            s.connect((host, port))
            s.sendall(_EXC_REQ.pack(_EXC_MAGIC, _EXC_PING, gen or 0, self.rank))
            status, blen = _EXC_RESP.unpack(_recv_exact_tcp(s, _EXC_RESP.size, until))
            blob = _recv_exact_tcp(s, blen, until) if blen else b""
        finally:
            s.close()
        if status != _EXC_OK or len(blob) < _EXC_GEN.size:
            raise RetryableError(
                f"shuffle exchange: UNAVAILABLE: malformed PING answer from {addr} "
                f"(status {status})")
        return _EXC_GEN.unpack(blob[:_EXC_GEN.size])[0]

    # -- the one-call partition exchange -------------------------------------

    def exchange_table(self, table: Table, key_cols: Sequence[str], peers: Dict[int, str],
                       epoch: int = 0, topology: Optional[str] = None, cluster=None) -> Table:
        """Hash-repartition ``table`` across this rank and ``peers`` (rank ->
        "host:port", this rank excluded): the rows of one key all land on
        pmod(murmur3(key), world), whichever process they started in.
        Returns this rank's incoming partition in a row order that depends
        only on (table, keys, world, rank).

        ``topology`` picks the plan; None reads ``SRJTORCH_CLUSTER_TOPOLOGY``:

        - ``all_to_all``: publish world - 1 partitions and pull this
          rank's from every peer concurrently (any world);
        - ``tree``: the hypercube plan of a power-of-two world, log2(world)
          rounds, one partner and one coalesced frame a round;
        - ``auto``: tree for a power-of-two world of 4 or more, else
          all_to_all.

        ``cluster`` (a ``cluster.ClusterView``) arms failover: a pull that
        spends its retries against a peer the cluster declares DEAD is
        recomputed from that rank's lineage. Recovery needs single-hop
        lineage, so an attached cluster pins ``all_to_all``."""
        world = len(peers) + 1
        ranks = sorted(set(peers) | {self.rank})
        if len(ranks) != world or ranks != list(range(world)):
            raise ValueError(f"exchange peers must cover ranks 0..{world - 1} "
                             f"(got self={self.rank}, peers={sorted(peers)})")
        if topology is None:
            topology = knobs.get_str("SRJTORCH_CLUSTER_TOPOLOGY")
        if topology == "auto":
            topology = ("tree" if cluster is None and world >= 4 and world & (world - 1) == 0
                        else "all_to_all")
        if topology == "tree" and cluster is not None:
            topology = "all_to_all"  # recovery needs single-hop lineage
        if topology == "tree":
            if world < 2 or world & (world - 1):
                raise ValueError(f"tree exchange needs a power-of-two world, got {world}")
            return self._exchange_tree(table, key_cols, peers, epoch)
        if topology != "all_to_all":
            raise ValueError(f"unknown exchange topology {topology!r}")
        return self._exchange_all_to_all(table, key_cols, peers, epoch, cluster)

    def _exchange_all_to_all(self, table: Table, key_cols: Sequence[str], peers: Dict[int, str],
                             epoch: int, cluster=None) -> Table:
        """The direct plan: publish world - 1 partitions, pull this rank's
        from every peer in threads, concatenate in rank order. With
        ``cluster``, a pull from a peer the cluster declares dead fails over
        to the lineage-recomputed copy."""
        import contextvars

        from ..ops.copying import concatenate, slice_table

        world = len(peers) + 1
        ranks = sorted(set(peers) | {self.rank})
        partitioned, offsets = hash_partition(table, world, key_cols)
        bounds = list(offsets) + [partitioned.num_rows]
        parts = {p: slice_table(partitioned, bounds[p], bounds[p + 1]) for p in range(world)}
        self.publish(epoch, {p: t for p, t in parts.items() if p != self.rank})
        # concurrent pulls (the wall time of the slowest peer), reassembled
        # in rank order; copy_context carries the caller's deadline scope
        fetched: Dict[int, Table] = {}
        errs: List[BaseException] = []

        def _pull(r: int, addr: str, ctx) -> None:
            try:
                fetched[r] = ctx.run(self.fetch, addr, epoch, self.rank)
                return
            except BaseException as e:  # srjt-lint: allow-broad-except(thread-exit funnel: the joiner re-raises errs[0] after joining every fetch thread)
                if cluster is None:
                    errs.append(e)
                    return
                primary = e
            # failover only once the retries are spent and the membership
            # layer agrees that the peer is dead
            try:
                recovered = ctx.run(cluster.failover_fetch, r, epoch, list(key_cols), world,
                                    self.rank)
            except BaseException as e2:  # srjt-lint: allow-broad-except(thread-exit funnel: the joiner re-raises errs[0] after joining every fetch thread)
                errs.append(e2)
                return
            if recovered is None:
                errs.append(primary)
            else:
                fetched[r] = recovered

        pulls = [threading.Thread(target=_pull, args=(r, peers[r], contextvars.copy_context()))
                 for r in ranks if r != self.rank]
        for t in pulls:
            t.start()
        for t in pulls:
            t.join()
        if errs:
            raise errs[0]
        names = list(table.names)
        # frames carry the schema, not the names: the caller's are re-applied
        received = [parts[self.rank] if r == self.rank else Table(fetched[r].columns, names)
                    for r in ranks]
        return concatenate(received)

    def _exchange_tree(self, table: Table, key_cols: Sequence[str], peers: Dict[int, str],
                       epoch: int) -> Table:
        """The hypercube plan of a power-of-two world: in round j this rank
        trades one coalesced frame with ``rank ^ (1 << j)``, handing over
        every held row whose destination differs from ours in bit j. Round
        j's frames are keyed at ``epoch + (j+1) * _TREE_EPOCH_STRIDE``.
        Each round rebuilds the held table as the kept partitions in rank
        order followed by the partner's frame, so the final row order is a
        function of (table, key_cols, world, rank); it differs from the
        direct plan's."""
        from ..ops.copying import concatenate, slice_table

        world = len(peers) + 1
        names = list(table.names)
        held = table
        for j in range(world.bit_length() - 1):
            partner = self.rank ^ (1 << j)
            sub_epoch = int(epoch) + (j + 1) * _TREE_EPOCH_STRIDE
            partitioned, offsets = hash_partition(held, world, key_cols)
            bounds = list(offsets) + [partitioned.num_rows]
            keep: List[Table] = []
            send: List[Table] = []
            mine_j = (self.rank >> j) & 1
            for p in range(world):
                seg = slice_table(partitioned, bounds[p], bounds[p + 1])
                (keep if ((p >> j) & 1) == mine_j else send).append(seg)
            self.publish(sub_epoch, {partner: concatenate(send)})
            got = self.fetch(peers[partner], sub_epoch, self.rank)
            held = concatenate(keep + [Table(got.columns, names)])
        return held

    def close(self) -> None:
        with self._published:
            self._closed = True
            self._frames.clear()
            self._epochs.clear()
            self._published.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# the worker harness: one rank of a distributed group-by in its own process.
# Deterministic (seeded data, integer sums), so a respawned incarnation
# republishes identical partitions.
# ---------------------------------------------------------------------------


def _demo_table(rows: int, seed: int, num_keys: int = 64, device=None) -> Table:
    """The harness's workload: INT64 keys ``k`` in [0, num_keys) and INT64
    values ``v`` in [-1000, 1000), made on the host from the seed and
    uploaded to ``device`` (None means the card)."""
    from ..columnar import Column
    from ..columnar.column import resolve_device, upload
    from ..columnar.dtype import INT64

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num_keys, rows).astype(np.int64)
    vals = rng.integers(-1000, 1000, rows).astype(np.int64)
    return Table([Column(INT64, data=upload(keys, dev)), Column(INT64, data=upload(vals, dev))],
                 ["k", "v"])


def _local_groupby_sum(table: Table) -> Table:
    """Exact INT64 group-by (sum and count) of the harness table in host
    numpy, sorted by key, on the table's device: each rank's result, whose
    concatenation must be bit for bit the single-process one."""
    from ..columnar import Column
    from ..columnar.column import upload
    from ..columnar.dtype import INT64

    dev = table.column("k").device
    keys = table.column("k").data.cpu().numpy()
    vals = table.column("v").data.cpu().numpy()
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, vals)
    np.add.at(counts, inv, 1)
    return Table([Column(INT64, data=upload(a, dev)) for a in (uniq, sums, counts)],
                 ["k", "s", "c"])


def _shard_bounds(rows: int, world: int, rank: int) -> Tuple[int, int]:
    return rows * rank // world, rows * (rank + 1) // world


def format_peers(peers: Dict[int, str]) -> str:
    """``rank=host:port,...``: the ``--peers`` argument and the stdin
    update, both parsed by ``parse_peers``."""
    return ",".join(f"{r}={a}" for r, a in sorted(peers.items()))


def parse_peers(spec: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for item in (spec or "").split(","):
        if not item:
            continue
        r, _, addr = item.partition("=")
        out[int(r)] = addr
    return out


def send_peer_map(proc, peers: Dict[int, str]) -> None:
    """Second half of the N-rank handshake: ranks start knowing only rank
    0's address, so once every READY line is in, the spawner completes each
    child's world with one ``EXCHANGE_PEER_MAP`` line on its stdin. A
    world-2 child knows its world already and does not wait."""
    proc.stdin.write(f"EXCHANGE_PEER_MAP {format_peers(peers)}\n")
    proc.stdin.flush()


def _kill(proc) -> None:
    proc.kill()
    proc.wait()


def _drain_stderr(proc, keep: int = 200):
    """Copy the child's stderr to ours line by line from a daemon thread,
    keeping its last ``keep`` lines on ``proc.stderr_tail``, so that a
    failure in the parent can name what the child said."""
    import collections
    import sys

    tail = collections.deque(maxlen=keep)

    def pump():
        for line in proc.stderr:
            tail.append(line)
            try:
                sys.stderr.write(line)
            except (OSError, ValueError):  # our stderr closed: keep the tail only
                pass

    t = threading.Thread(target=pump, name="exchange-peer-stderr", daemon=True)
    t.start()
    proc.stderr_tail = tail
    proc.stderr_thread = t


def peer_stderr(proc, wait_s: float = 5.0) -> str:
    """The last lines a spawned peer wrote to stderr; after its exit, all
    of them (waits up to ``wait_s`` for the copy to reach EOF)."""
    t = getattr(proc, "stderr_thread", None)
    if t is None:
        return ""
    if proc.poll() is not None:
        t.join(wait_s)
    return "".join(proc.stderr_tail)


def spawn_exchange_peer(parent_addr: str, rows: int, seed: int, *,
                        rank: int = 1, world: int = 2,
                        extra_env: Optional[dict] = None,
                        ready_timeout_s: float = 180.0,
                        respawn_of=None,
                        cluster: bool = False,
                        query: str = "demo",
                        epoch: int = 0,
                        rounds: int = 1,
                        device=None):
    """Start one ``--exchange-worker`` process against ``parent_addr``
    (rank 0) and wait for its READY line; returns ``(Popen,
    peer_address)``. The child inherits this environment less any armed
    fault-injection config (pass one back in ``extra_env`` to storm the
    peer on purpose), with retry armed and ``SRJTORCH_FAULTINJ_RANK=r<rank>``
    stamped so that ``@r<N>`` chaos rules resolve in the right process.
    ``device`` is the child's ``--device`` (None: its default, the card).
    For ``world > 2`` complete the child's peer map with ``send_peer_map``
    once every rank's address is known. ``respawn_of`` is the Popen of a
    dead predecessor: the harness checks that it exited and emits the
    ``exchange.peer_respawn`` event."""
    import select
    import subprocess
    import sys

    from ..utils.errors import FatalDeviceError

    env = dict(os.environ)
    env.pop("SRJTORCH_FAULTINJ_CONFIG", None)
    env["SRJTORCH_RETRY_ENABLED"] = "1"
    env["SRJTORCH_FAULTINJ_RANK"] = f"r{rank}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    if extra_env:
        env.update(extra_env)
    argv = [sys.executable, "-m", "spark_rapids_jni_tpu_torch.parallel.shuffle",
            "--exchange-worker", "--rank", str(rank), "--world", str(world),
            "--rows", str(rows), "--seed", str(seed), "--epoch", str(epoch),
            "--query", query, "--rounds", str(rounds), "--peers", f"0={parent_addr}"]
    if cluster:
        argv.append("--cluster")
    if device is not None:
        argv += ["--device", str(device)]
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, text=True)
    _drain_stderr(proc)

    def exited():
        return FatalDeviceError(f"exchange peer exited during startup rc={proc.returncode}; "
                                f"its stderr:\n{peer_stderr(proc)}")
    # select() on the raw fd and a line buffer of our own, so that the
    # timeout holds while the child prints nothing, an EOF fails at once,
    # and a READY line sharing a pipe chunk with an earlier line is seen
    fd = proc.stdout.fileno()
    buf = b""
    t_end = time.monotonic() + ready_timeout_s
    try:
        while True:
            nl = buf.find(b"\n")
            if nl >= 0:
                line, buf = buf[:nl], buf[nl + 1:]
                text = line.decode("utf-8", "replace")
                if text.startswith(knobs.EXCHANGE_READY):
                    if respawn_of is not None and respawn_of.poll() is not None:
                        metrics.event("exchange.peer_respawn", rank=rank,
                                      prev_rc=respawn_of.returncode)
                    return proc, text.strip().split("addr=")[1]
                continue
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                raise FatalDeviceError(
                    f"exchange peer never reported ready within {ready_timeout_s:g}s; "
                    f"its stderr:\n{peer_stderr(proc)}")
            readable, _, _ = select.select([fd], [], [], min(remaining, 0.5))
            if not readable:
                if proc.poll() is not None:
                    raise exited()
                continue
            chunk = os.read(fd, 65536)
            if not chunk:
                # a dying child's pipes close before it can be reaped: at
                # EOF wait for the exit instead of polling once
                try:
                    proc.wait(timeout=max(t_end - time.monotonic(), 0.0))
                except subprocess.TimeoutExpired:
                    raise FatalDeviceError(
                        "exchange peer closed stdout before reporting ready; "
                        f"its stderr:\n{peer_stderr(proc, 0.0)}") from None
                raise exited()
            buf += chunk
    except BaseException:
        _kill(proc)
        raise


def spawn_exchange_fleet(parent_addr: str, rows: int, seed: int, *,
                         world: int,
                         cluster: bool = False,
                         query: str = "demo",
                         epoch: int = 0,
                         rounds: int = 1,
                         extra_env_by_rank: Optional[dict] = None,
                         ready_timeout_s: float = 180.0,
                         device=None):
    """Start ranks ``1..world-1`` as ``--exchange-worker`` processes, all
    at once (each start-up is an interpreter, torch and its table: seconds;
    this process is rank 0 at ``parent_addr``), complete every child's
    peer map once all READY lines are in, and return ``(procs, peers)``:
    ``procs[rank]`` the Popen, ``peers[rank]`` the address of every rank,
    0 included, both in rank order. On any failure the children already
    started are killed before the error propagates."""
    started: Dict[int, tuple] = {}
    errors: List[BaseException] = []
    lock = threading.Lock()

    def start(rank: int) -> None:
        try:
            got = spawn_exchange_peer(
                parent_addr, rows, seed, rank=rank, world=world, cluster=cluster, query=query,
                epoch=epoch, rounds=rounds, ready_timeout_s=ready_timeout_s,
                extra_env=(extra_env_by_rank or {}).get(rank), device=device)
        except BaseException as e:  # srjt-lint: allow-broad-except(thread-exit funnel: the starter re-raises errors[0] after joining every start thread)
            with lock:
                errors.append(e)
            return
        with lock:
            started[rank] = got

    procs: Dict[int, object] = {}
    peers: Dict[int, str] = {0: parent_addr}
    try:
        threads = [threading.Thread(target=start, args=(rank,), daemon=True,
                                    name=f"srjtorch-exchange-spawn-r{rank}")
                   for rank in range(1, world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for rank in sorted(started):
            procs[rank], peers[rank] = started[rank]
        if errors:
            raise errors[0]
        if world > 2:
            for rank, proc in procs.items():
                send_peer_map(proc, {r: a for r, a in peers.items() if r != rank})
    except BaseException:
        with lock:
            for proc, _addr in started.values():
                _kill(proc)
        raise
    return procs, peers


def _await_peer_map(peers: Dict[int, str], world: int) -> bool:
    """Block on stdin until the spawner's ``EXCHANGE_PEER_MAP`` line
    completes the map; False on EOF before it arrived (the spawner died)."""
    import sys

    while len(peers) < world - 1:
        line = sys.stdin.readline()
        if not line:
            return False
        if line.startswith("EXCHANGE_PEER_MAP "):
            peers.update(parse_peers(line.split(" ", 1)[1].strip()))
    return True


def _worker_run_q55(ex: "TcpExchange", peers: Dict[int, str], cluster, args,
                    dev) -> Table:
    """The distributed TPC-DS leg of the worker: compile q55 with exchange
    stages, run it over this rank's store_sales shard (dimensions
    replicated), and return the rank's partial. Concatenating every rank's
    partial and re-sorting (``plan.distribute.merge_partials``) gives the
    single-host answer bit for bit: the FLOAT64 sums are exact, and the
    sort keys are a total order."""
    from ..models import tpcds
    from ..models.tpcds_plans import q55_plan
    from ..ops.copying import slice_table
    from ..plan import compile_ir
    from ..plan.distribute import exchange_context, insert_exchanges

    tables = tpcds.gen_store(args.rows, seed=args.seed, device=dev)
    world = args.world
    sales = tables["store_sales"]

    def shard_tables(r: int) -> Dict[str, Table]:
        lo, hi = _shard_bounds(sales.num_rows, world, r)
        shards = dict(tables)
        shards["store_sales"] = slice_table(sales, lo, hi)
        return shards

    plan = insert_exchanges(q55_plan(), world)
    compiled = compile_ir(plan, shard_tables(args.rank), name=f"q55@r{args.rank}")
    with exchange_context(ex, peers, cluster=cluster, shard_tables=shard_tables,
                          base_epoch=args.epoch):
        return compiled()


def _exchange_worker_main(args) -> int:
    """One peer rank: build the seeded shard on ``args.device``, exchange
    hash partitions with the rest of the world, aggregate, publish the
    result (epoch ``args.epoch + 2 * rounds - 1``, part = this rank), then
    serve until stdin closes. ``--query q55`` swaps the demo group-by for
    the plan-compiled distributed TPC-DS q55 over ``gen_store(rows)``,
    published at ``args.epoch + 1``. Prints ``SRJTORCH_EXCHANGE_READY
    addr=<host:port>`` once the server is up; for ``world > 2`` it then
    waits for the spawner's peer map. ``--cluster`` arms a ClusterView
    (fence, heartbeats, lineage recovery). The worker is the cross-process
    posture: ``SRJTORCH_EXCHANGE_MODE`` defaults to ``tcp`` here and an
    explicit ``mesh`` is refused. Without a card, ``--device cpu`` is
    required: the worker exits before READY otherwise."""
    import sys

    from ..columnar.column import resolve_device
    from ..ops.copying import slice_table

    mode = exchange_mode() if knobs.is_set("SRJTORCH_EXCHANGE_MODE") else "tcp"
    if mode != "tcp":
        print(f"exchange worker: SRJTORCH_EXCHANGE_MODE must be 'tcp' for a cross-process peer "
              f"(got {mode!r})", file=sys.stderr)
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"exchange worker: {e}", file=sys.stderr)
        return 2
    peers = parse_peers(args.peers)
    table = shard = None
    if args.query == "demo":
        # warm before READY: the spawner's measurement window opens at the
        # handshake, and loading the kernels is not exchange throughput
        table = _demo_table(args.rows, args.seed, device=dev)
        shard = slice_table(table, *_shard_bounds(args.rows, args.world, args.rank))
        parts_w, offs_w = hash_partition(shard, args.world, ["k"])
        bounds_w = list(offs_w) + [parts_w.num_rows]
        for p in range(args.world):
            if p != args.rank:  # the frames publish() will encode
                frames_mod.encode_table(slice_table(parts_w, bounds_w[p], bounds_w[p + 1]))
        _local_groupby_sum(slice_table(shard, 0, min(shard.num_rows, 1024)))
        del parts_w
    ex = TcpExchange(args.rank, bind=args.bind, device=dev)
    print(f"{knobs.EXCHANGE_READY} addr={ex.address}", flush=True)
    if not _await_peer_map(peers, args.world):
        print("exchange worker: stdin closed before peer map arrived", file=sys.stderr)
        ex.close()
        return 3

    cluster = None
    if args.cluster:
        from .cluster import ClusterView

        addresses = dict(peers)
        addresses[args.rank] = ex.address
        cluster = ClusterView(args.rank, addresses, ex)
        cluster.start()
    try:
        with retry.enabled(max_attempts=40, base_delay_ms=25, max_delay_ms=250):
            if args.query == "q55":
                result = _worker_run_q55(ex, peers, cluster, args, dev)
                result_epoch = args.epoch + 1
            else:
                if cluster is not None:
                    cluster.set_lineage(lambda r: slice_table(
                        table, *_shard_bounds(args.rows, args.world, r)))
                # round i at epoch + 2i, so that a steady-state round can
                # be timed with every first-call cost paid; a rank is at
                # most one round ahead of another, which retain_epochs=4
                # outlives
                rounds = max(args.rounds, 1)
                for rnd in range(rounds):
                    local = ex.exchange_table(shard, ["k"], peers,
                                              epoch=args.epoch + 2 * rnd, cluster=cluster)
                result = _local_groupby_sum(local)
                result_epoch = args.epoch + 2 * rounds - 1
            ex.publish(result_epoch, {args.rank: result})
            # serve until the supervisor closes our stdin
            sys.stdin.read()
    finally:
        if cluster is not None:
            cluster.stop()
        ex.close()
    return 0


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="TCP exchange worker harness")
    ap.add_argument("--exchange-worker", action="store_true", required=True)
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--bind", default="127.0.0.1:0")
    ap.add_argument("--peers", default="", help="rank=host:port,...")
    ap.add_argument("--cluster", action="store_true",
                    help="arm ClusterView membership + heartbeats")
    ap.add_argument("--query", default="demo", choices=("demo", "q55"),
                    help="workload: the demo group-by or the plan-compiled q55 (result "
                         "published at epoch + 1)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="demo exchange rounds (round i at epoch + 2i; result published at "
                         "epoch + 2*rounds - 1)")
    ap.add_argument("--device", default=None,
                    help="device of the worker's tables: cuda (the default) or cpu")
    return _exchange_worker_main(ap.parse_args(argv))


if __name__ == "__main__":
    import sys

    # run the canonical module's copy, so that cluster.py and this entry
    # share one TcpExchange class and one breaker registry
    from spark_rapids_jni_tpu_torch.parallel.shuffle import _main as _canonical_main

    sys.exit(_canonical_main())
