"""Bounded-domain GROUP BY SUM (port of the JAX package's
``ops/aggregate.groupby_sum_bounded``)."""

from __future__ import annotations

from typing import Tuple

import torch

from .hopper_kernels import MAX_KEYS, groupby_sum_outer

__all__ = ["groupby_sum_bounded"]


def groupby_sum_bounded(
    keys: torch.Tensor,
    vals: torch.Tensor,
    num_keys: int,
    f64_bits: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GROUP BY SUM for a bounded integer key domain [0, num_keys):
    returns (sums[num_keys], counts[num_keys] int64); keys outside the
    domain are dropped.

    float32 ``vals`` with ``num_keys <= 65536`` and fewer than 2^24 rows
    (the reference's gate for its kernel, kept so both packages dispatch
    alike) go to B3 (``hopper_kernels.groupby_sum_outer``). Other values
    sum in one index_add_: integers in two's-complement int64, floats in
    their own type. Integer ``vals`` widen as their torch type says, so
    a UINT16/UINT32 column (held in the signed storage of its width)
    is passed as ``data.view(torch.uint16)`` / ``view(torch.uint32)`` to
    widen by zero extension as the reference's unsigned types do.
    ``f64_bits=True`` (exact FLOAT64 sums over IEEE bits) is not ported
    yet."""
    if f64_bits:
        raise NotImplementedError(
            "f64_bits=True needs the exact FLOAT64 accumulator (ops/f64acc.py), "
            "not ported yet (ROADMAP.md, Open items, section 1, item 2)"
        )
    if vals.dtype == torch.float32 and num_keys <= MAX_KEYS and keys.shape[0] < (1 << 24):
        return groupby_sum_outer(keys, vals, num_keys)
    keys = keys.to(torch.int64)
    seg = torch.where((keys >= 0) & (keys < num_keys), keys, num_keys)
    if not vals.is_floating_point():
        vals = vals.to(torch.int64)
    sums = torch.zeros(num_keys + 1, dtype=vals.dtype, device=vals.device)
    sums.index_add_(0, seg, vals)
    counts = torch.bincount(seg, minlength=num_keys + 1)
    return sums[:num_keys], counts[:num_keys]
