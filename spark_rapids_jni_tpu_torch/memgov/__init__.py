"""Device memory governor: byte-weighted admission control, the spillable
buffer catalog, and the pressure loop that connects them (port of the
JAX package's ``memgov/``).

The reference stack never lets tasks race each other into a device
out-of-memory error: the plugin gates concurrent tasks on the GPU with a
semaphore and backs every cached batch with a spill framework
(device->host->disk). This package is that subsystem, in three parts:

- **admission** (``admission.py``): a byte-weighted semaphore over
  ``utils/memory.device_memory_budget()``. ``op_boundary``
  (``utils/dispatch.py``) acquires it with each op's footprint estimate
  before dispatch, on the OUTERMOST boundary of a thread only. FIFO
  fairness, an optional ``SRJTORCH_ADMISSION_MAX_CONCURRENT`` cap, and
  waits that cooperate with ``utils/deadline.py``; sustained over-budget
  demand raises the retryable ``MemoryBudgetExceeded``, so the retry
  orchestrator's split path engages.
- **catalog** (``catalog.py``): ``SpillableHandle``s wrapping device
  tensors (pipeline build tables, out-of-core partitions, cached
  subresults) with pin/unpin semantics, LRU-ordered demotion
  device->host->disk under pressure, and transparent re-materialization
  on access, bit for bit.
- **pressure** (``pressure.py``): invoked by the admission controller
  when an acquire would block; it spills unpinned catalog entries until
  the request fits.

Activation: ``SRJTORCH_SPILL_ENABLED`` arms the governor explicitly;
unset, it arms exactly when an operator declared a budget
(``SRJTORCH_DEVICE_MEMORY_BUDGET``). The decision is frozen at import,
so that disarmed the hot path in ``op_boundary`` is one reserved-keyword
pop and one boolean read; ``enable()`` arms a live process. Counters are
registry-direct (``memgov.admitted/queued/rejected/spilled_bytes/
respilled``, the ``memgov.queue_wait_us`` and ``memgov.spill_us``
histograms), and ``stats_section()`` reports them.

Environment:

    SRJTORCH_SPILL_ENABLED            "1" arms, "0" disarms even with a
                                      budget; unset: armed iff
                                      SRJTORCH_DEVICE_MEMORY_BUDGET is set
    SRJTORCH_DEVICE_MEMORY_BUDGET     device byte budget (read live)
    SRJTORCH_ADMISSION_MAX_CONCURRENT admitted-op cap (0: bytes only)
    SRJTORCH_ADMISSION_MAX_WAIT_SEC   queue wait before the retryable
                                      MemoryBudgetExceeded (default 30)
    SRJTORCH_SPILL_DIR                disk-tier directory (default: a
                                      per-process dir under the system
                                      tempdir)
    SRJTORCH_HOST_MEMORY_BUDGET       host-tier bytes before host entries
                                      demote to disk (0: unlimited)
    SRJTORCH_MEMGOV_HEADROOM          input bytes -> footprint multiplier
                                      of the default estimate (2.0)
    SRJTORCH_MEMGOV_DROP_SMCACHE      the reference's last-resort cache
                                      drop; the port has no such cache
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from ..utils import knobs
from .admission import Admission, AdmissionController
from .catalog import (
    TIER_DEVICE,
    TIER_DISK,
    TIER_HOST,
    BufferCatalog,
    SpillableHandle,
    tree_leaves,
)

__all__ = [
    "Admission",
    "AdmissionController",
    "BufferCatalog",
    "SpillableHandle",
    "TIER_DEVICE",
    "TIER_HOST",
    "TIER_DISK",
    "controller",
    "catalog",
    "admit",
    "ensure_fits",
    "estimate_call_bytes",
    "enable",
    "disable",
    "is_enabled",
    "enabled",
    "in_admission",
    "stats_section",
    "reset",
]


def _env_enabled() -> bool:
    # no explicit arming: govern exactly when an operator declared a budget
    return knobs.get_bool(
        "SRJTORCH_SPILL_ENABLED",
        default=knobs.is_set("SRJTORCH_DEVICE_MEMORY_BUDGET"),
    )


_enabled = _env_enabled()


def enable() -> None:
    """Arm the governor (op_boundary admission + pressure spilling)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enabled():
    """Scoped arming (tests pair it with a budget for a deterministic
    capacity)."""
    global _enabled
    prev = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = prev


# ---------------------------------------------------------------------------
# process-wide singletons (one device, one budget, one catalog)
# ---------------------------------------------------------------------------

# RLock: controller() builds its catalog through catalog() while holding it
_lock = threading.RLock()
_catalog: Optional[BufferCatalog] = None
_controller: Optional[AdmissionController] = None


def catalog() -> BufferCatalog:
    """The process-wide spillable buffer catalog. With manifests armed, a
    fresh catalog re-attaches surviving spill files of dead owners and
    reclaims the rest (``persist.startup`` never raises)."""
    global _catalog
    if _catalog is None:
        with _lock:
            if _catalog is None:
                cat = BufferCatalog()
                from . import persist
                if persist.manifests_enabled():
                    persist.startup(cat)
                _catalog = cat
    return _catalog


def controller() -> AdmissionController:
    """The process-wide admission controller (it shares the catalog, so
    the pressure loop spills what the process actually cached)."""
    global _controller
    if _controller is None:
        with _lock:
            if _controller is None:
                _controller = AdmissionController(catalog=catalog())
    return _controller


def reset() -> None:
    """Fresh singletons (tests): closes the catalog, dropping every entry
    and its spill files, and discards queued admission state. The enable
    gate is left as it is."""
    global _catalog, _controller
    with _lock:
        cat, _catalog, _controller = _catalog, None, None
    if cat is not None:
        cat.close()
    _tls.depth = 0
    _tls.current = None


# ---------------------------------------------------------------------------
# op-boundary integration (utils/dispatch.py)
# ---------------------------------------------------------------------------

# per-thread nesting guard, as in utils/retry.py: only the OUTERMOST
# op_boundary of a thread owns an admission; a nested op's footprint is
# part of its parent's, and double-admitting would deadlock the semaphore
_tls = threading.local()


def in_admission() -> bool:
    """True while this thread holds an op_boundary admission."""
    return getattr(_tls, "depth", 0) > 0


def _headroom() -> float:
    return knobs.get_float("SRJTORCH_MEMGOV_HEADROOM")


def _call_bytes(obj) -> int:
    """The bytes of a call's arrays: tensors (through Tables, Columns and
    containers) and numpy arrays. Anything else (a scalar, a string, a
    plan) holds none, as a leaf without ``nbytes`` in the reference."""
    import numpy as np
    import torch

    from ..columnar.column import Column
    from ..columnar.table import Table

    if isinstance(obj, (torch.Tensor, Table, Column)):
        return sum(int(t.element_size()) * int(t.numel()) for t in tree_leaves(obj))
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, (tuple, list)):
        return sum(_call_bytes(v) for v in obj)
    if isinstance(obj, dict):
        return sum(_call_bytes(v) for v in obj.values())
    return 0


def estimate_call_bytes(args=(), kwargs=None) -> int:
    """Default per-op footprint: the summed bytes of every array in the
    call (Tables and Columns walked to their tensors) times
    ``SRJTORCH_MEMGOV_HEADROOM``. Ops with data-dependent buffer growth
    pass an explicit ``memory_bytes=`` instead."""
    return int(_call_bytes((tuple(args), kwargs or {})) * _headroom())


def admit(name: str, args=(), kwargs=None, nbytes=None) -> Optional[Admission]:
    """Acquire the byte-weighted admission for one op dispatch, or None
    when the governor is disarmed or an enclosing boundary already holds
    one. The caller MUST release the returned Admission."""
    if not _enabled or getattr(_tls, "depth", 0) > 0:
        return None
    if nbytes is None:
        nbytes = estimate_call_bytes(args, kwargs)
    adm = controller().acquire(int(nbytes), name=name)
    _tls.depth = 1
    _tls.current = adm
    adm._on_release = _clear_tls
    return adm


def _clear_tls() -> None:
    _tls.depth = 0
    _tls.current = None


def ensure_fits(nbytes: int, name: str = "op") -> None:
    """Non-queueing fit check for an in-op footprint escalation (the
    exchange's capacity doubling): run the pressure loop until ``nbytes``
    fits the budget, else raise the retryable ``MemoryBudgetExceeded`` so
    that the caller splits instead of driving the card out of memory. A
    no-op when the governor is disarmed. The thread's held admission, if
    any, does not count against its own escalation: it GROWS to the
    escalated footprint."""
    if not _enabled:
        return
    controller().ensure_fits(
        int(nbytes), name=name, admission=getattr(_tls, "current", None)
    )


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def stats_section() -> dict:
    """The governor's stats: registry counters (always on) plus the
    admission and catalog snapshots when the singletons exist (a stats
    poll never creates them)."""
    from ..utils import metrics

    reg = metrics.registry()
    out = {
        "enabled": _enabled,
        "admitted": reg.value("memgov.admitted"),
        "queued": reg.value("memgov.queued"),
        "rejected": reg.value("memgov.rejected"),
        "spilled_bytes": reg.value("memgov.spilled_bytes"),
        "spills": reg.value("memgov.spills"),
        "respilled": reg.value("memgov.respilled"),
        "rematerialized_bytes": reg.value("memgov.rematerialized_bytes"),
        "spill_failures": reg.value("memgov.spill_failures"),
        "queue_wait_us": reg.value("memgov.queue_wait_us", default=None),
        "spill_us": reg.value("memgov.spill_us", default=None),
    }
    if _controller is not None:
        out["admission"] = _controller.snapshot()
    if _catalog is not None:
        out["catalog"] = _catalog.snapshot()
    return out
