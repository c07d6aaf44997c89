"""Distributed sort over the mesh: a range-partitioned sample sort (port
of the JAX package's ``parallel/sort_distributed.py``), Spark's
range-partitioning exchange plus a local sort. Each shard:

1. sorts its rows,
2. samples ``oversample`` evenly spaced keys; the samples of all shards
   are gathered (``mesh.all_gather``) and sorted, and P - 1 splitters
   taken at even ranks,
3. routes each row by splitter range (``searchsorted``: the rows of shard
   i are all <= those of shard i + 1) through the bucket all-to-all,
4. sorts what it received, absent rows last: each shard holds a sorted
   run, and shard order is the global order.

It takes raw integer keys. FLOAT64 callers map the bits through
``ops.bitutils.total_order_key`` first. Capacity overflow is flagged as
in the exchange. No kernel runs here: the routing is by splitters, not by
hash.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import mesh as mesh_mod
from .distributed import _lexsort_present_first
from .shuffle import _exchange_shards
from ..utils.dispatch import op_boundary

__all__ = ["distributed_sort"]


@op_boundary("distributed_sort")
def distributed_sort(
    keys: torch.Tensor,  # [N_global] integer keys, row-sharded
    mesh,
    axis: str = "data",
    capacity: Optional[int] = None,
    oversample: int = 32,
    descending: bool = False,
):
    """Globally sort row-sharded keys. Returns (sorted host numpy array,
    overflow flag); on the devices each shard ends holding a sorted run,
    shard order the global order."""
    n_parts = mesh.shape[axis]
    home = mesh.home(axis)
    per_shard = keys.shape[0] // n_parts
    if capacity is None:
        # a source shard holds per_shard rows, so no bucket can hold more
        capacity = per_shard
    capacity = int(capacity)
    samples_per = min(oversample, per_shard)

    shards = mesh_mod.shard_rows(keys, mesh, axis)
    local = []
    for k in shards:
        pos = (torch.arange(samples_per, device=k.device) * k.shape[0]) // samples_per
        local.append(torch.sort(k).values[pos])
    gathered = mesh_mod.all_gather(local)
    dests = []
    for k, g in zip(shards, gathered):
        all_sorted = torch.sort(g.reshape(-1)).values
        spl_pos = (torch.arange(1, n_parts, device=k.device) * all_sorted.shape[0]) // n_parts
        dests.append(torch.searchsorted(all_sorted[spl_pos], k, side="right").to(torch.int32))
    (kr,), mr, ovf = _exchange_shards([shards], dests, n_parts, capacity)
    runs = []
    for kf, mf in zip(kr, mr):
        order = _lexsort_present_first([kf], mf)
        runs.append(kf[order][mf[order]])  # the shard's sorted run, absent rows dropped
    overflow = bool(torch.stack([o.to(home) for o in ovf]).any())
    out = mesh_mod.cat(runs, home).cpu().numpy()
    if descending:
        out = out[::-1]
    return out, overflow
