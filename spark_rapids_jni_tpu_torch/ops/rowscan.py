"""Running sums along the short inner axis of an [N, L] matrix.

A cumulative sum along the innermost axis of a million rows is a scan
that costs the card ~6.5 ms a call even over 8 columns (PERF.md section
6). One matmul with an upper-triangular matrix of ones computes the same
sums, exactly in float32 while every partial sum stays below 2^24: the
inputs here are counts and byte lengths of at most a few bytes a column.
"""

from __future__ import annotations

import torch

__all__ = ["cumsum_rows"]


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """The running sum of an [N, L] bool or small non-negative integer
    tensor along dim 1, as int64 (``torch.cumsum(x, 1)`` when every sum is
    below 2^24)."""
    L = x.shape[1]
    ones = torch.ones((L, L), dtype=torch.float32, device=x.device).triu()
    return (x.to(torch.float32) @ ones).to(torch.int64)
