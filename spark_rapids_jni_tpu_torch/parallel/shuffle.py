"""Shuffle: the hash partition and the in-mesh all-to-all exchange (port
of the JAX package's ``parallel/shuffle.py``; its cross-process
``TcpExchange`` is not ported yet).

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
``retry.record_capacity_retry`` (``shuffle.capacity_retries``). The
reference's memory-governor check of a doubled capacity is not ported.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import Table
from ..columnar.dtype import TypeId
from ..ops.copying import gather
from ..ops.hashing import hash_partition_map
from ..ops.uword import MASK32, split_u64
from ..utils import deadline, integrity, metrics, retry
from ..utils.errors import RetryableError
from . import mesh as mesh_mod
from ..utils.dispatch import op_boundary

__all__ = ["hash_partition", "all_to_all_exchange", "exchange_by_key"]

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
    checked = integrity.is_enabled()
    sent_sum = _exchange_checksum(arrays) if checked else None
    # per-GLOBAL-ROW wire cost: the exchange moves capacity-padded
    # [P, capacity] buckets a shard for each array (not the dense rows)
    # plus the 1-byte occupancy mask a slot; it changes every time the
    # escalation doubles the capacity
    row_bytes = (
        sum(a.element_size() * a.numel() // max(a.shape[0], 1) for a in arrays) + 1
        if armed else 0
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
