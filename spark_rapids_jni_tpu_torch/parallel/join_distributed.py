"""Distributed hash join over the mesh, the exchange-heavy TPC-DS q95
shape (BASELINE.json configs[3]); port of the JAX package's
``parallel/join_distributed.py``.

Spark's shuffled hash join: both sides hash-partition by key onto the
same shard (two all-to-all exchanges), then each shard joins what it
received. The local join is static-shape: sort the received right side
by key, find each left row's run of matches with two ``searchsorted``
probes, and expand the runs into (left, right) index pairs bounded by
``out_capacity`` with an occupancy mask; a run overflow is flagged like
the exchange's bucket overflow. Single-key routing runs B1 on each
shard, each side (``distributed._hash_dest``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import mesh as mesh_mod
from .distributed import _hash_dest, _lexsort_present_first
from .shuffle import _exchange_shards
from ..utils.dispatch import op_boundary

__all__ = ["shard_join_pairs", "distributed_inner_join"]


def shard_join_pairs(
    lk: torch.Tensor,  # [nl] left keys
    lp: torch.Tensor,  # [nl] left present mask
    rk: torch.Tensor,  # [nr] right keys
    rp: torch.Tensor,  # [nr] right present mask
    out_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape inner-join pair expansion.

    Returns (left_idx [out_capacity] int32, right_idx [out_capacity] int32,
    pair_valid [out_capacity], overflow 0-d). Indices refer to the input
    arrays; absent rows never match."""
    nl, nr = lk.shape[0], rk.shape[0]
    dev = lk.device
    # right sorted by (absent last, key): occupancy is the primary key, so
    # absent rows cannot collide with any real key
    rorder = _lexsort_present_first([rk], rp)
    rks = rk[rorder]
    rps = rp[rorder]
    n_right_valid = rps.sum()

    # padding rows sit after the valid prefix with arbitrary keys: the max
    # key keeps the probe array monotone, and the clamp to n_right_valid
    # cuts a real max-valued key's run back to real rows
    rks_probe = torch.where(rps, rks, torch.iinfo(rks.dtype).max)
    lo = torch.minimum(torch.searchsorted(rks_probe, lk, side="left"), n_right_valid)
    hi = torch.minimum(torch.searchsorted(rks_probe, lk, side="right"), n_right_valid)
    # int64: a skewed shard can pass 2^31 candidate pairs
    cnt = torch.where(lp, hi - lo, 0).to(torch.int64)

    starts = torch.cumsum(cnt, 0) - cnt  # exclusive scan
    total = (starts[-1] + cnt[-1]) if nl else torch.zeros((), dtype=torch.int64, device=dev)
    overflow = total > out_capacity

    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    # the left row owning output slot j: the first whose cumulative end
    # passes j (empty runs end where they start and are skipped)
    ends = starts + cnt
    left_row = torch.searchsorted(ends, j, side="right").clamp(0, max(nl - 1, 0))
    within = j - starts[left_row]
    pair_valid = (j < total) & (within >= 0) & (within < cnt[left_row])
    right_sorted_idx = (lo[left_row] + within).clamp(0, max(nr - 1, 0))
    right_row = rorder[right_sorted_idx].to(torch.int32)
    return left_row.to(torch.int32), right_row, pair_valid, overflow


@op_boundary("distributed_inner_join")
def distributed_inner_join(
    left_key: torch.Tensor,  # [NL_global] row-sharded
    left_val: torch.Tensor,  # [NL_global]
    right_key: torch.Tensor,  # [NR_global] row-sharded
    right_val: torch.Tensor,  # [NR_global]
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    out_capacity: Optional[int] = None,
):
    """Inner join on integer keys across the mesh; returns host numpy
    arrays (key, left value, right value) of the matched rows and the
    overflow flag. ``capacity`` bounds the rows a shard sends one
    destination, ``out_capacity`` the pairs a shard emits."""
    n_parts = mesh.shape[axis]
    home = mesh.home(axis)
    per_l = left_key.shape[0] // n_parts
    per_r = right_key.shape[0] // n_parts
    if capacity is None:
        capacity = max(per_l, per_r)
    if out_capacity is None:
        out_capacity = capacity * n_parts * 2
    capacity, cap_out = int(capacity), int(out_capacity)

    def side(keys, vals):
        k_sh = mesh_mod.shard_rows(keys, mesh, axis)
        (kr, vr), mr, ovf = _exchange_shards(
            [k_sh, mesh_mod.shard_rows(vals, mesh, axis)],
            [_hash_dest(k, n_parts) for k in k_sh], n_parts, capacity)
        return kr, vr, mr, ovf

    lkr, lvr, lmr, o1 = side(left_key, left_val)
    rkr, rvr, rmr, o2 = side(right_key, right_val)
    outs, ovf = [[], [], [], []], o1 + o2
    for s in range(n_parts):
        li, ri, pv, o3 = shard_join_pairs(lkr[s], lmr[s], rkr[s], rmr[s], cap_out)
        zero = torch.zeros((), dtype=torch.int64, device=pv.device)
        outs[0].append(torch.where(pv, lkr[s][li], zero.to(lkr[s].dtype)))
        outs[1].append(torch.where(pv, lvr[s][li], zero.to(lvr[s].dtype)))
        outs[2].append(torch.where(pv, rvr[s][ri], zero.to(rvr[s].dtype)))
        outs[3].append(pv)
        ovf.append(o3)
    k, lv, rv, pv = (mesh_mod.cat(o, home) for o in outs)
    overflow = bool(torch.stack([o.to(home) for o in ovf]).any())
    # compact on the device: only the matched rows cross to the host
    return k[pv].cpu().numpy(), lv[pv].cpu().numpy(), rv[pv].cpu().numpy(), overflow
