"""Byte-weighted admission control over the device memory budget (port of
the JAX package's ``memgov/admission.py``).

The reference plugin's GpuSemaphore gates concurrent tasks on the GPU so
that they cannot race each other into an out-of-memory error. This is
that gate in BYTES rather than task slots: every outermost
``op_boundary`` dispatch acquires ``nbytes`` from a budget-sized
semaphore before it runs and releases it when it completes.

Semantics, as the reference's:

- **FIFO fairness**: waiters queue in arrival order and only the head
  waiter may admit, so a stream of small requests cannot starve a large
  one.
- **Occupancy** counts admitted op footprints PLUS the catalog's
  device-resident bytes: cached buffers and in-flight ops share one
  budget.
- **Pressure before queueing**: an acquire that would block first runs
  the pressure loop (``pressure.py``) to demote unpinned catalog
  entries; only demand the catalog cannot absorb waits.
- **Deadline-cooperative waits** (``utils/deadline.py``): a wait never
  outlives the query budget; a dead budget raises ``DeadlineExceeded``.
- **Bounded waits**: a request that cannot be admitted within
  ``SRJTORCH_ADMISSION_MAX_WAIT_SEC``, or that could never fit, raises
  the retryable ``MemoryBudgetExceeded``, so the retry orchestrator's
  split path engages.
- **Concurrency cap**: ``SRJTORCH_ADMISSION_MAX_CONCURRENT`` (default 0,
  bytes only) also bounds the admitted ops.

The default capacity is ``utils/memory.device_memory_budget()``: on the
card, half of ``torch.cuda.mem_get_info``'s total less the bytes the
caching allocator holds live, or the ``SRJTORCH_DEVICE_MEMORY_BUDGET``
override. Lock order is admission -> catalog, and the catalog never
calls back into admission.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils.memory import MemoryBudgetExceeded, device_memory_budget

__all__ = ["Admission", "AdmissionController"]


def _registry():
    from ..utils import metrics

    return metrics.registry()


class Admission:
    """A held byte reservation; release exactly once (idempotent)."""

    __slots__ = ("nbytes", "name", "_controller", "_released", "_on_release")

    def __init__(self, controller: "AdmissionController", nbytes: int, name: str):
        self.nbytes = nbytes
        self.name = name
        self._controller = controller
        self._released = False
        self._on_release: Optional[Callable[[], None]] = None

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            self._controller._release(self)
        finally:
            if self._on_release is not None:
                self._on_release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class AdmissionController:
    """The byte-weighted FIFO semaphore. ``capacity_fn`` resolves the live
    budget on every admission decision."""

    def __init__(
        self,
        capacity_fn: Optional[Callable[[], int]] = None,
        catalog=None,
        max_concurrent: Optional[int] = None,
        max_wait_s: Optional[float] = None,
        clock=time.monotonic,
    ):
        from ..utils import knobs

        self._capacity_fn = capacity_fn or device_memory_budget
        if catalog is None:
            from .catalog import BufferCatalog

            catalog = BufferCatalog()
        self._catalog = catalog
        if max_concurrent is None:
            max_concurrent = knobs.get_int("SRJTORCH_ADMISSION_MAX_CONCURRENT")
        self._max_concurrent = int(max_concurrent)
        self._max_wait_s = (
            knobs.get_float("SRJTORCH_ADMISSION_MAX_WAIT_SEC")
            if max_wait_s is None
            else float(max_wait_s)
        )
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._in_use = 0
        self._active = 0

    # -- introspection -------------------------------------------------------

    @property
    def catalog(self):
        return self._catalog

    def capacity(self) -> int:
        return int(self._capacity_fn())

    def in_use(self) -> int:
        return self._in_use  # one machine word, read for monitoring only

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "capacity": self.capacity(),
                "in_use_bytes": self._in_use,
                "catalog_device_bytes": self._catalog.device_bytes(),
                "active": self._active,
                "queue_depth": len(self._queue),
                "max_concurrent": self._max_concurrent,
                "max_wait_s": self._max_wait_s,
            }

    def _occupancy_locked(self) -> int:
        return self._in_use + self._catalog.device_bytes()

    def _update_gauges_locked(self) -> None:
        reg = _registry()
        reg.gauge("memgov.in_use_bytes").set(self._in_use)
        reg.gauge("memgov.active_ops").set(self._active)
        reg.gauge("memgov.queue_depth").set(len(self._queue))

    # -- the semaphore -------------------------------------------------------

    def acquire(self, nbytes: int, name: str = "op") -> Admission:
        """Block until ``nbytes`` fits (FIFO order), spilling catalog
        entries under pressure. Raises ``DeadlineExceeded`` when the
        active query budget dies first, ``MemoryBudgetExceeded`` when the
        demand is hopeless or outwaits the admission bound. The whole
        acquire is one ``memgov.admission_wait`` span in a traced query."""
        from ..utils import tracing

        with tracing.span(
            "memgov.admission_wait", op=name, nbytes=int(nbytes)
        ):
            return self._acquire(int(nbytes), name)

    def _acquire(self, nbytes: int, name: str) -> Admission:
        from ..utils import deadline as deadline_mod
        from ..utils import metrics

        nbytes = max(int(nbytes), 0)
        reg = _registry()
        t0 = self._clock()
        ticket = object()
        queued = False
        tried_pressure = False
        with self._cond:
            self._queue.append(ticket)
            try:
                while True:
                    cap = self.capacity()
                    at_head = self._queue[0] is ticket
                    conc_ok = (
                        self._max_concurrent <= 0
                        or self._active < self._max_concurrent
                    )
                    if at_head and conc_ok:
                        need = self._occupancy_locked() + nbytes - cap
                        # relieve when there is something to spill (or
                        # once, for the last-resort valve): a blocked
                        # waiter must not spin the pressure loop on a
                        # drained catalog every poll slice
                        if need > 0 and (
                            self._catalog.spillable_device_bytes() > 0
                            or not tried_pressure
                        ):
                            tried_pressure = True
                            from . import pressure

                            pressure.relieve(need, self._catalog, name=name)
                            need = self._occupancy_locked() + nbytes - cap
                        if need <= 0:
                            self._queue.popleft()
                            self._in_use += nbytes
                            self._active += 1
                            reg.counter("memgov.admitted").inc()
                            reg.histogram("memgov.queue_wait_us").record(
                                (self._clock() - t0) * 1e6
                            )
                            self._update_gauges_locked()
                            self._cond.notify_all()
                            return Admission(self, nbytes, name)
                        # hopeless demand never waits: the request cannot
                        # fit even with every spillable gone, or nothing
                        # is left to spill and nothing in flight could
                        # release
                        spillable = self._catalog.spillable_device_bytes()
                        if (
                            nbytes + self._in_use - cap > spillable
                            and self._active == 0
                        ) or (spillable == 0 and self._active == 0):
                            reg.counter("memgov.rejected").inc()
                            metrics.event(
                                "memgov.reject", op=name, nbytes=nbytes,
                                capacity=cap, in_use=self._in_use,
                            )
                            raise MemoryBudgetExceeded(
                                f"admission: {name} needs {nbytes} device bytes "
                                f"(budget {cap}, {self._occupancy_locked()} occupied, "
                                f"nothing left to spill or release); split the "
                                f"batch"
                            )
                    if not queued:
                        queued = True
                        reg.counter("memgov.queued").inc()
                        metrics.event(
                            "memgov.queue", op=name, nbytes=nbytes,
                            in_use=self._in_use,
                        )
                    d = deadline_mod.current()
                    if d is not None and d.done():
                        reg.counter("memgov.deadline_denied").inc()
                        raise d.exceeded(f"memgov admission ({name})")
                    waited = self._clock() - t0
                    if waited >= self._max_wait_s:
                        reg.counter("memgov.rejected").inc()
                        metrics.event(
                            "memgov.reject", op=name, nbytes=nbytes,
                            waited_s=round(waited, 3),
                        )
                        raise MemoryBudgetExceeded(
                            f"admission: {name} waited {waited:.2f}s for "
                            f"{nbytes} device bytes (budget {self.capacity()}, "
                            f"{self._in_use} admitted); sustained over-budget "
                            f"demand — split the batch"
                        )
                    step = min(0.02, self._max_wait_s - waited)
                    if d is not None:
                        # wake just past the deadline edge, not a poll late
                        step = min(step, max(d.remaining(), 0.0) + 0.001)
                    self._cond.wait(max(step, 0.001))
            finally:
                try:
                    self._queue.remove(ticket)
                except ValueError:
                    pass  # admitted (popped): the success path
                self._update_gauges_locked()
                self._cond.notify_all()

    def _release(self, adm: Admission) -> None:
        with self._cond:
            self._in_use -= adm.nbytes
            self._active -= 1
            self._update_gauges_locked()
            self._cond.notify_all()

    def ensure_fits(self, nbytes: int, name: str = "op",
                    admission: Optional[Admission] = None) -> None:
        """Non-queueing fit check for an in-op footprint escalation (the
        exchange's capacity doubling): the escalated footprint must fit
        the budget, spilling under pressure, else the retryable
        ``MemoryBudgetExceeded`` is raised so the caller splits.
        ``admission`` is the escalating op's own reservation: the
        escalated footprint replaces its estimate, so on success the
        reservation GROWS to ``nbytes`` (it never shrinks)."""
        from ..utils import metrics

        reg = _registry()
        nbytes = max(int(nbytes), 0)
        with self._cond:
            cap = self.capacity()
            held = 0
            if admission is not None and not admission._released:
                held = min(admission.nbytes, self._in_use)
            need = self._occupancy_locked() - held + nbytes - cap
            if need > 0:
                from . import pressure

                pressure.relieve(need, self._catalog, name=name)
                need = self._occupancy_locked() - held + nbytes - cap
            if need > 0:
                reg.counter("memgov.rejected").inc()
                metrics.event(
                    "memgov.reject", op=name, nbytes=nbytes, capacity=cap,
                    escalation=True,
                )
                raise MemoryBudgetExceeded(
                    f"{name}: escalated footprint {nbytes} bytes cannot fit "
                    f"the device budget ({cap} bytes, "
                    f"{self._occupancy_locked()} occupied); split the batch"
                )
            if admission is not None and not admission._released and \
                    nbytes > admission.nbytes:
                self._in_use += nbytes - admission.nbytes
                admission.nbytes = nbytes
                self._update_gauges_locked()

    def drain_for_tests(self) -> None:
        """Zero the semaphore (tests recovering from a leaked admission;
        production code releases through ``Admission``)."""
        with self._cond:
            self._in_use = 0
            self._active = 0
            self._queue.clear()
            self._update_gauges_locked()
            self._cond.notify_all()
