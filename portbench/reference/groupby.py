"""Plain bounded GROUP BY SUM and COUNT, in plain PyTorch.

Keys outside [0, num_keys) are dropped. ``dtype`` is the type the values
are rounded to and summed in: float64 for the reference, a lower one
(bfloat16) for the control that stands in for the program.
"""

from __future__ import annotations

from typing import Tuple

import torch


def bounded_sum(keys: torch.Tensor, vals: torch.Tensor, num_keys: int,
                dtype: torch.dtype = torch.float64) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums, counts int64, sums of absolute values in float64) of each key."""
    keys = keys.to(torch.int64)
    keep = (keys >= 0) & (keys < num_keys)
    k, v = keys[keep], vals[keep]
    sums = torch.zeros(num_keys, dtype=dtype, device=keys.device).index_add_(0, k, v.to(dtype))
    counts = torch.bincount(k, minlength=num_keys)
    mags = torch.zeros(num_keys, dtype=torch.float64, device=keys.device).index_add_(
        0, k, v.to(torch.float64).abs())
    return sums, counts, mags


def sum_gap(got: torch.Tensor, want: torch.Tensor, mags: torch.Tensor) -> float:
    """The widest gap of a key's sum from the reference's, over the sum of
    the key's absolute values (the rounding error a sum of those values
    can carry, whatever cancels in it)."""
    gap = (got.to(torch.float64) - want.to(torch.float64)).abs() / mags.clamp_min(1e-300)
    return float(gap.max()) if gap.numel() else 0.0
