"""Device-memory budget and retryable over-budget semantics (port of the
JAX package's ``utils/memory.py``).

Ops that grow buffers data-dependently (the exchange capacity escalation
in ``parallel/table_ops.py``) estimate their device footprint before they
dispatch and, over the budget, either raise ``MemoryBudgetExceeded`` (a
``RetryableError``: Spark's task retry applies) or split the batch and
re-run, instead of driving the allocator into an out-of-memory error.

The budget of a CUDA device is half of ``torch.cuda.mem_get_info``'s
total, less the bytes the caching allocator holds live
(``torch.cuda.memory_allocated``), floored at 64 MiB: the reference's
``bytes_limit * 0.5`` less its live ``bytes_in_use``. A CPU device keeps
the reference's 4 GiB. The knob ``SRJTORCH_DEVICE_MEMORY_BUDGET`` (bytes,
read live) overrides the probe, as the reference's budget knob does, and
the ``budget`` context manager overrides both inside a ``with`` block.
The count of forced splits is the registry counter
``memory.split_retries`` (``utils/metrics``, registry-direct, so it
counts whether or not the metrics gate is armed); ``split_retry_count()``
reads it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..columnar.column import resolve_device
from . import knobs, metrics
from .errors import RetryableError

__all__ = [
    "MemoryBudgetExceeded",
    "device_memory_budget",
    "exchange_bytes_estimate",
    "split_retry_count",
    "budget",
]


class MemoryBudgetExceeded(RetryableError):
    """A requested device buffer footprint exceeds the memory budget.
    Retryable: the caller may split the batch (ops with split-retry do so
    themselves) or the task may re-run elsewhere."""


_MIN_BUDGET = 64 << 20  # floor after the live bytes are taken off
_CPU_BUDGET = 4 << 30  # the reference's CPU-tier default
_OVERRIDE: Optional[int] = None
_TOTAL = {}  # CUDA device index -> total bytes (probed once)
_SPLIT_COUNTER = "memory.split_retries"


def split_retry_count() -> int:
    """How many batch splits the memory tier has forced in this process
    (the registry counter ``memory.split_retries``)."""
    return metrics.registry().counter(_SPLIT_COUNTER).value


def _note_split() -> None:
    metrics.registry().counter(_SPLIT_COUNTER).inc()
    metrics.event("memory.split_retry")


@contextlib.contextmanager
def budget(nbytes: Optional[int]):
    """Override the budget of every device for the duration of a ``with``
    block (bytes; ``None`` restores the knob or the probe). An explicit 0 is a real
    budget: everything is over it."""
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = None if nbytes is None else int(nbytes)
    try:
        yield
    finally:
        _OVERRIDE = prev


def device_memory_budget(device=None) -> int:
    """Usable bytes of ``device`` for one op's working buffers (``None``
    means the card, and raises without one). The override wins; else a
    CUDA device's half total less its live allocated bytes (floored at
    64 MiB), or 4 GiB for the CPU. ``SRJTORCH_DEVICE_MEMORY_BUDGET``
    replaces the probe; an explicit 0 is a real budget."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    env = knobs.get_int("SRJTORCH_DEVICE_MEMORY_BUDGET")
    if env is not None:
        return env
    dev = resolve_device(device)
    if dev.type != "cuda":
        return _CPU_BUDGET
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _TOTAL:
        _TOTAL[idx] = int(torch.cuda.mem_get_info(idx)[1])
    return max(_TOTAL[idx] // 2 - int(torch.cuda.memory_allocated(idx)), _MIN_BUDGET)


def exchange_bytes_estimate(row_bytes: int, n_parts: int, capacity: int) -> int:
    """Per-device bytes an all-to-all exchange needs at a per-destination
    ``capacity``: each shard holds its own [n_parts, capacity] bucket
    matrix a lane, doubled for the send/receive pair the collective keeps
    live."""
    return 2 * n_parts * capacity * max(row_bytes, 1)
