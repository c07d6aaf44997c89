"""Distributed relational ops over the mesh: the 1M-row GROUP BY SUM
(BASELINE.json configs[0]) end to end across the shards (port of the JAX
package's ``parallel/distributed.py``).

Each shard, in order (the body ``shard_map`` runs once a device):

1. hashes its local key rows to a destination shard (pmod),
2. buckets them for the all-to-all exchange (``parallel/shuffle``
   framing), which ``mesh.all_to_all`` swaps,
3. groups what it received at a static capacity: a stable sort of the
   rows, then segment sums into a fixed [capacity] accumulator,

and the host compacts the [P, capacity] partials. ``shard_groupby_sum``
is the static-shape group-by a shard runs (no host read of its group
count, unlike ``ops.aggregate.groupby_aggregate``).

This is the in-mesh tier: shards of one runtime, one failure domain. The
destination of one INT32 or INT64 key lane is kernel B1's function
(``hopper_kernels.partition_map``: murmur3 with seed 42, then pmod), so
that routing launches B1 on a CUDA shard, once a shard; composite keys
chain ``murmur3_raw`` (Spark Murmur3Hash chaining).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.hashing import murmur3_raw
from ..ops.hopper_kernels import partition_map
from ..ops.murmur import pmod
from ..ops.uword import u32_to_i64
from . import mesh as mesh_mod
from .shuffle import _exchange_shards

__all__ = ["shard_groupby_sum", "distributed_groupby_sum", "distributed_groupby_sum_multi"]


def _hash_dest_multi(key_arrays, n_parts: int) -> torch.Tensor:
    """[n] int32 destination shard of each row: chained murmur3 over the raw
    key lanes pmod n_parts (Spark Murmur3Hash chaining: each lane hashes
    with the running hash as its seed), the same as ``hash_partition_map``
    on the equivalent columns. One INT32 or INT64 lane is B1's function and
    runs B1 (its plain version on a CPU tensor)."""
    key_arrays = list(key_arrays)
    if len(key_arrays) == 1 and key_arrays[0].dtype in (torch.int32, torch.int64):
        return partition_map(key_arrays[0], n_parts)
    h = None
    for k in key_arrays:
        h = murmur3_raw(k) if h is None else murmur3_raw(k, seed=h)
    return pmod(u32_to_i64(h), n_parts)


def _hash_dest(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Single-key convenience over _hash_dest_multi."""
    return _hash_dest_multi([keys], n_parts)


def _lexsort_present_first(lanes: Sequence[torch.Tensor], present: torch.Tensor) -> torch.Tensor:
    """The stable order of ``jnp.lexsort(tuple(reversed(lanes)) +
    (~present,))``: present rows first, then by the lanes, the first most
    significant, ties in row order (successive stable argsorts from the
    least significant key)."""
    order = torch.arange(present.shape[0], dtype=torch.int64, device=present.device)
    for lane in list(reversed(list(lanes))) + [~present]:
        order = order[torch.argsort(lane[order], stable=True)]
    return order


def _segments(ks: Sequence[torch.Tensor], ps: torch.Tensor, capacity: int):
    """Segment ids of sorted rows (``ks`` key lanes and ``ps`` occupancy
    in sorted order): a new segment where any key changes, absent rows in
    the trash segment ``capacity``, ids past the capacity clipped to its
    last slot. Returns (seg int64 [n], num_groups 0-d, overflow 0-d)."""
    n = ps.shape[0]
    changed = torch.zeros((n - 1,), dtype=torch.bool, device=ps.device)
    for k in ks:
        changed = changed | (k[1:] != k[:-1])
    new_seg = torch.cat([torch.ones((1,), dtype=torch.bool, device=ps.device), changed]) & ps
    seg = torch.cumsum(new_seg, 0) - 1
    num_groups = (seg[-1] + 1).clamp(min=0)
    overflow = num_groups > capacity
    seg = torch.where(ps, seg.clamp(0, capacity - 1), capacity)
    return seg, num_groups, overflow


def _scatter_keys(ks: Sequence[torch.Tensor], seg: torch.Tensor,
                  capacity: int) -> List[torch.Tensor]:
    """[capacity] group keys: each segment's key (zero where no group); the
    trash segment's rows are dropped."""
    out = []
    for k in ks:
        o = k.new_zeros((capacity + 1,))
        o[seg] = k
        out.append(o[:capacity])
    return out


def shard_groupby_sum(
    keys: torch.Tensor,  # [n] int key lane (int32/int64)
    vals: torch.Tensor,  # [n] numeric values
    present: torch.Tensor,  # [n] bool occupancy (exchange padding mask)
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape group-by sum: (keys [capacity], sums [capacity],
    group_valid [capacity], overflow 0-d). Absent rows are left out; a
    group count past the capacity sets the overflow flag. Single-key
    form of _shard_groupby_sum_multi."""
    out_keys, sums, group_valid, overflow = _shard_groupby_sum_multi(
        [keys], vals, present, capacity
    )
    return out_keys[0], sums, group_valid, overflow


def _shard_groupby_sum_multi(key_arrays, vals, present, capacity: int):
    """Multi-key form of shard_groupby_sum: a stable sort over all key
    lanes (occupancy primary), a segment where any key changes. Integer
    sums accumulate in int64 (Spark semantics), not the input width."""
    order = _lexsort_present_first(key_arrays, present)
    ks = [k[order] for k in key_arrays]
    vs = torch.where(present, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))[order]
    if not vs.is_floating_point():
        vs = vs.to(torch.int64)
    ps = present[order]
    seg, num_groups, overflow = _segments(ks, ps, capacity)
    sums = vs.new_zeros((capacity + 1,)).index_add_(0, seg, vs)[:capacity]
    group_valid = torch.arange(capacity, device=ps.device) < num_groups
    return _scatter_keys(ks, seg, capacity), sums, group_valid, overflow


def _defaults(n_global: int, n_parts: int, capacity, group_capacity):
    per_shard = n_global // n_parts
    if capacity is None:
        capacity = per_shard
    if group_capacity is None:
        group_capacity = capacity * n_parts
    return int(capacity), int(group_capacity)


def _groupby_shards(key_arrays, vals, mesh, axis: str, capacity: int, cap_g: int):
    """The shards' bodies: route, bucket, exchange, group. Returns the
    [P * cap_g] key lanes, sums and group-valid mask on the home device
    and the overflow flag (one host read)."""
    n_parts = mesh.shape[axis]
    home = mesh.home(axis)
    k_shards = [mesh_mod.shard_rows(k, mesh, axis) for k in key_arrays]
    dests = [_hash_dest_multi([ks[s] for ks in k_shards], n_parts) for s in range(n_parts)]
    (*krs, vr), mr, ovf = _exchange_shards(
        k_shards + [mesh_mod.shard_rows(vals, mesh, axis)], dests, n_parts, capacity)
    gks, gss, gvs = [[] for _ in key_arrays], [], []
    for s in range(n_parts):
        gk, gs, gv, o2 = _shard_groupby_sum_multi([kr[s] for kr in krs], vr[s], mr[s], cap_g)
        for lst, g in zip(gks, gk):
            lst.append(g)
        gss.append(gs)
        gvs.append(gv)
        ovf.append(o2)
    overflow = bool(torch.stack([o.to(home) for o in ovf]).any())
    return ([mesh_mod.cat(g, home) for g in gks], mesh_mod.cat(gss, home),
            mesh_mod.cat(gvs, home), overflow)


def distributed_groupby_sum(
    keys: torch.Tensor,  # [N_global] int64/int32 keys, row-sharded
    vals: torch.Tensor,  # [N_global] values, row-sharded
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    group_capacity: Optional[int] = None,
):
    """GROUP BY key SUM(val) across the mesh. Returns (keys, sums) as host
    numpy arrays (compacted, shard by shard in each shard's key order)
    and the overflow flag. ``capacity``: rows a shard may send one
    destination; ``group_capacity``: distinct keys a shard may hold."""
    n_parts = mesh.shape[axis]
    capacity, cap_g = _defaults(keys.shape[0], n_parts, capacity, group_capacity)
    (gk,), gs, gv, ovf = _groupby_shards([keys], vals, mesh, axis, capacity, cap_g)
    # compact on the device: only the groups cross to the host
    return gk[gv].cpu().numpy(), gs[gv].cpu().numpy(), ovf


def distributed_groupby_sum_multi(
    key_arrays,  # sequence of [N_global] int tensors, row-sharded alike
    vals: torch.Tensor,
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    group_capacity: Optional[int] = None,
):
    """GROUP BY (k1, k2, ...) SUM(val) across the mesh, the composite-key
    form of distributed_groupby_sum (rows of one key tuple land on one
    shard through chained murmur3). Returns (list of key arrays, sums,
    overflow), host numpy arrays."""
    key_arrays = list(key_arrays)
    n_parts = mesh.shape[axis]
    capacity, cap_g = _defaults(key_arrays[0].shape[0], n_parts, capacity, group_capacity)
    gks, gs, gv, ovf = _groupby_shards(key_arrays, vals, mesh, axis, capacity, cap_g)
    return [g[gv].cpu().numpy() for g in gks], gs[gv].cpu().numpy(), ovf
