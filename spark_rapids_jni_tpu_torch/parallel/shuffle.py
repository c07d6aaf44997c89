"""The shuffle write (port of ``hash_partition`` from the JAX package's
``parallel/shuffle.py``; its mesh and TCP exchange are not ported yet)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar import Table
from ..ops.copying import gather
from ..ops.hashing import hash_partition_map

__all__ = ["hash_partition"]


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
