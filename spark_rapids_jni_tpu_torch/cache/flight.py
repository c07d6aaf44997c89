"""Single-flight latch (port of the JAX package's ``cache/flight.py``):
N concurrent callers with one key run ONE computation and fan the result
out.

The first caller in becomes the leader and computes; every later caller
with the same key attaches as a waiter on the flight's event, settled
under one lock. Waiters poll the event in short slices so that the
ambient deadline scope stays live: cancelling or expiring an ATTACHED
waiter raises out of ITS wait only (``deadline.check``), never touching
the shared leg.

Failure isolation: a leader's failure is NOT fanned out. Faults are
per-leg, so a waiter whose leader failed computes independently, counted
under ``cache.share_fallback``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

from ..utils import deadline as deadline_mod
from ..utils import metrics, tracing

__all__ = ["SingleFlight"]

# waiter poll slice: short enough that cancellation/expiry of a waiter
# is observed promptly, long enough to stay off the scheduler's back
_WAIT_SLICE_S = 0.02


def _durable(name: str):
    return metrics.registry().counter(name)


class _Flight:
    """One in-flight computation: leader's outcome + the fan-out latch."""

    __slots__ = ("event", "result", "ok", "waiters")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.ok = False
        self.waiters = 0


class SingleFlight:
    """key -> in-flight computation map under one lock."""

    def __init__(self, name: str):
        self._lock = threading.Lock()
        self._flights: Dict = {}
        self._name = name

    def run(self, key, thunk: Callable):
        """Run ``thunk`` as the key's leader, or attach to the leader
        already running it. Exactly one thunk executes per key per
        flight; waiters receive the leader's result object (results are
        immutable Tables — sharing is safe)."""
        with self._lock:
            fl = self._flights.get(key)
            if fl is None:
                fl = _Flight()
                self._flights[key] = fl
                leader = True
            else:
                fl.waiters += 1
                leader = False
        if leader:
            try:
                out = thunk()
                fl.result = out
                fl.ok = True
                return out
            finally:
                # pop BEFORE set: once waiters wake, a new caller must
                # start a fresh flight, not attach to a finished one
                with self._lock:
                    self._flights.pop(key, None)
                fl.event.set()
        # -- attached waiter --------------------------------------------------
        _durable("cache.share").inc()
        tracing.event_span("cache.attach", flight=self._name)
        while not fl.event.wait(_WAIT_SLICE_S):
            # raises DeadlineExceeded when THIS waiter's budget expires
            # or its CancelToken trips — the leader and the other
            # waiters are untouched (waiter cancellation never cancels
            # the shared leg)
            deadline_mod.check("cache.attach")
        if fl.ok:
            return fl.result
        # leader failed: faults are per-leg — compute independently
        _durable("cache.share_fallback").inc()
        return thunk()

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._flights)
