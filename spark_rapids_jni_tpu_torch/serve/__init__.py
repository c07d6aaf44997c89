"""Concurrent multi-query serving runtime (the port of the JAX package's
``serve/``).

This package arbitrates QUERIES the way memgov arbitrates bytes:

- **Scheduler** (`scheduler.py`): ``submit(fn_or_pipeline, tenant=,
  deadline_s=, priority=, memory_bytes=) -> QueryHandle`` executing
  concurrently across ``SRJTORCH_SERVE_MAX_CONCURRENT`` dispatch slots
  that run straight into the existing op_boundary -> memgov admission
  -> sidecar-pool path, with each query's deadline/cancel token
  installed context-locally (the deadline machinery propagates it down
  every blocking layer).
- **Per-tenant QoS**: bounded per-tenant FIFO queues feeding a
  stride-scheduled (weighted-fair) dispatcher — one tenant's storm
  cannot starve another's trickle, and nothing buffers unboundedly.
- **Graceful degradation**: queue-full / dead-on-arrival / pressure /
  dark-pool submissions fast-fail AT ADMISSION with the retryable
  ``Overloaded`` taxonomy member carrying a ``retry_after_s`` hint —
  shedding is lowest-priority-first and never mid-flight.

The journal adds **crash recoverability**: with
``SRJTORCH_JOURNAL_DIR`` set, every admitted query is journaled (fsync'd,
CRC-framed) BEFORE its handle returns, state transitions are recorded
after-the-fact, and a restarted coordinator replays the journal —
answering duplicate idempotency keys from the recorded digest and
resubmitting journaled-but-incomplete work through
``journal.recover()``. See ``journal.py``.
"""

from . import journal
from .journal import DigestAnswer, recover
from .scheduler import (
    QueryHandle,
    Scheduler,
    SHED_CAUSES,
    leak_report,
    live_scheduler_count,
    scheduler,
    shutdown_scheduler,
    stats_section,
    submit,
)

__all__ = [
    "DigestAnswer",
    "QueryHandle",
    "Scheduler",
    "SHED_CAUSES",
    "journal",
    "recover",
    "leak_report",
    "live_scheduler_count",
    "scheduler",
    "shutdown_scheduler",
    "stats_section",
    "submit",
]
