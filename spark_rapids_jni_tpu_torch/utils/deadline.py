"""Per-query deadline budgets, cooperative cancellation and the circuit
breaker (port of the JAX package's ``utils/deadline.py``).

- **Deadline**: a wall-clock budget carried in a context-local
  (``contextvars``) object every blocking layer consults:
  ``remaining()`` / ``expired()`` / ``check()``. One budget spans the
  whole dynamic extent of a query: nested scopes can only SHRINK the
  remaining time, never extend it.
- **CancelToken**: cooperative cancellation any layer can trip
  (``cancel(reason)``) or poll (``cancelled()``). Nested scopes share
  the enclosing scope's token, so tripping the query's token cancels
  every layer beneath it.
- **DeadlineExceeded** (``utils/errors.py``): the error an exhausted
  budget raises. A DeviceError, so dispatch classification passes it
  through unchanged, but neither retryable (a retry cannot make time)
  nor fatal (the device is fine).
- **CircuitBreaker**: the fail-fast state machine (CLOSED -> OPEN after
  ``threshold`` consecutive failures, HALF_OPEN after ``cooldown_s``,
  one probe decides). Its states and transitions write registry-direct
  into ``utils/metrics``.

Activation: ``SRJTORCH_DEADLINE_SEC`` installs an ambient per-query
budget (the OUTERMOST ``op_boundary`` opens the scope, so the knob bounds
every op including its retries and backoff sleeps); per call,
``some_op(..., deadline_s=2.5)`` on any wrapped op; or
``deadline.scope(2.5)`` for an explicit region.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import threading
import time
from typing import Optional

from . import knobs
from .errors import DeadlineExceeded

__all__ = [
    "CancelToken",
    "Deadline",
    "CircuitBreaker",
    "scope",
    "op_scope",
    "current",
    "remaining",
    "check",
    "cancel",
    "default_budget",
    "set_default_budget",
    "BREAKER_STATE_CODES",
]


class CancelToken:
    """Cooperative cancellation flag: any layer trips it, every layer
    polls it. Idempotent — the FIRST cancel's reason wins (it names the
    root cause; later trips are echoes)."""

    __slots__ = ("_lock", "_flag", "_reason")

    def __init__(self):
        self._lock = threading.Lock()
        self._flag = False
        self._reason: Optional[str] = None

    def cancel(self, reason: str = "cancelled") -> None:
        with self._lock:
            if not self._flag:
                self._flag = True
                self._reason = str(reason)

    def cancelled(self) -> bool:
        # this poll sits on every cancel point of every hot path: a
        # bool read is GIL-atomic, monotonic False->True, and a racing
        # reader that misses the flip just polls again one layer down
        return self._flag  # srjt-race: allow-unguarded(lock-free cancel-point poll; GIL-atomic monotonic flag, next poll sees the flip)

    @property
    def reason(self) -> Optional[str]:
        # written once under _lock before _flag flips; read only after
        # cancelled() observed True
        return self._reason  # srjt-race: allow-unguarded(written once under _lock before _flag flips; only read after cancelled() observed True)


class Deadline:
    """A wall-clock budget plus a cancel token.

    ``budget_s=None`` is the unbounded deadline (token-only): it never
    expires, but its token still cancels — the shape an interactive
    "stop this query" control wants without forcing a time limit.
    """

    __slots__ = ("budget_s", "token", "_t_end", "_clock")

    def __init__(
        self,
        budget_s: Optional[float] = None,
        token: Optional[CancelToken] = None,
        clock=time.monotonic,
    ):
        if budget_s is not None and budget_s <= 0:
            raise ValueError(f"deadline budget must be > 0, got {budget_s}")
        self.budget_s = None if budget_s is None else float(budget_s)
        self.token = token if token is not None else CancelToken()
        self._clock = clock
        self._t_end = math.inf if budget_s is None else clock() + float(budget_s)

    def remaining(self) -> float:
        """Seconds left (may be negative once expired; +inf unbounded)."""
        return self._t_end - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self._t_end

    def cancelled(self) -> bool:
        return self.token.cancelled()

    def done(self) -> bool:
        """True when no further work should START under this deadline."""
        return self.token.cancelled() or self.expired()

    def cancel(self, reason: str = "cancelled") -> None:
        self.token.cancel(reason)

    def exceeded(self, what: str = "op") -> DeadlineExceeded:
        """Build (don't raise) the error describing why this deadline is
        done — cancel reason when the token tripped first, the budget
        otherwise."""
        if self.token.cancelled() and not self.expired():
            return DeadlineExceeded(f"{what}: cancelled ({self.token.reason})")
        b = "unbounded" if self.budget_s is None else f"{self.budget_s:g}s"
        return DeadlineExceeded(
            f"{what}: deadline budget exhausted (budget={b})"
        )

    def check(self, what: str = "op") -> None:
        """Cancel point: raise DeadlineExceeded when done, else return."""
        if self.done():
            raise self.exceeded(what)


# ---------------------------------------------------------------------------
# context-local propagation
# ---------------------------------------------------------------------------

_current: contextvars.ContextVar = contextvars.ContextVar(
    "srjtorch_deadline", default=None
)


def current() -> Optional[Deadline]:
    """The active Deadline for this context, or None."""
    return _current.get()


def remaining() -> float:
    """Seconds left in the active scope; +inf with no active deadline."""
    d = _current.get()
    return math.inf if d is None else d.remaining()


def check(what: str = "op") -> None:
    """Module-level cancel point: no-op without an active deadline."""
    d = _current.get()
    if d is not None:
        d.check(what)


def cancel(reason: str = "cancelled") -> bool:
    """Trip the active scope's token; False when no scope is active."""
    d = _current.get()
    if d is None:
        return False
    d.cancel(reason)
    return True


@contextlib.contextmanager
def scope(
    budget_s: Optional[float] = None,
    token: Optional[CancelToken] = None,
    clock=time.monotonic,
):
    """Install a Deadline for the dynamic extent of the with-block.

    Nesting discipline: the effective budget is
    ``min(budget_s, enclosing remaining)`` — an inner scope can shrink
    the time left but never extend past the query's budget — and, with
    no explicit ``token``, the enclosing scope's token is SHARED, so
    cancelling the query cancels every nested layer.
    """
    outer = _current.get()
    eff = None if budget_s is None else float(budget_s)
    tok = token
    if outer is not None:
        rem = outer.remaining()
        if not math.isinf(rem):
            # an already-expired outer still yields a valid (instantly
            # done) inner deadline rather than a constructor error
            rem = max(rem, 1e-9)
            eff = rem if eff is None else min(eff, rem)
        if tok is None:
            tok = outer.token
    d = Deadline(eff, token=tok, clock=clock)
    if outer is not None:
        # clamp the absolute edge too: remaining() and the constructor
        # read the clock at different instants, and even that epsilon
        # must not let an inner scope outlive the query's deadline
        d._t_end = min(d._t_end, outer._t_end)
    handle = _current.set(d)
    try:
        yield d
    finally:
        _current.reset(handle)


# ---------------------------------------------------------------------------
# ambient per-query budget (SRJTORCH_DEADLINE_SEC)
# ---------------------------------------------------------------------------


def _parse_env_budget() -> Optional[float]:
    # typed registry accessor (utils/knobs.py): malformed / <= 0 warns
    # and keeps the default — None, "no ambient budget", the seed posture
    return knobs.get_float("SRJTORCH_DEADLINE_SEC")


_default_budget: Optional[float] = _parse_env_budget()


def default_budget() -> Optional[float]:
    """The ambient per-query budget (SRJTORCH_DEADLINE_SEC), or None."""
    return _default_budget


def set_default_budget(budget_s: Optional[float]) -> None:
    """Programmatic override of the ambient budget (tests, embedders)."""
    global _default_budget
    if budget_s is not None and float(budget_s) <= 0:
        raise ValueError(f"deadline budget must be > 0, got {budget_s}")
    _default_budget = None if budget_s is None else float(budget_s)


@contextlib.contextmanager
def op_scope(budget_s: Optional[float] = None):
    """Dispatch-entry helper: an explicit
    per-call budget opens a nested scope; with none, the OUTERMOST
    dispatch under an ambient SRJTORCH_DEADLINE_SEC opens the per-query
    scope; otherwise the enclosing scope (or no deadline at all) rides
    through unchanged. Yields the active Deadline or None.

    utils/dispatch.py's op_boundary INLINES this same policy on its hot
    path (so the fully-disarmed case pays no context manager) — a
    semantic change here must land there in lockstep.
    """
    if budget_s is None:
        if _current.get() is not None or _default_budget is None:
            yield _current.get()
            return
        budget_s = _default_budget
    with scope(budget_s) as d:
        yield d


# ---------------------------------------------------------------------------
# circuit breaker (the sidecar path's fail-fast degradation machine)
# ---------------------------------------------------------------------------

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

# gauge encoding for the metrics registry (JSON-clean, orderable)
BREAKER_STATE_CODES = {STATE_CLOSED: 0, STATE_OPEN: 1, STATE_HALF_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a half-open probe.

    State machine::

        CLOSED --(threshold consecutive failures)--> OPEN
        OPEN   --(cooldown_s elapsed, next request)--> HALF_OPEN
        HALF_OPEN --(probe success)--> CLOSED
        HALF_OPEN --(probe failure)--> OPEN  (cooldown restarts)

    While OPEN, ``allow()`` returns False and counts a fast-fail — the
    caller degrades immediately (the sidecar client runs the op on the
    host engine without dialing). While HALF_OPEN exactly ONE in-flight
    probe is allowed; concurrent requests keep fast-failing until the
    probe settles.

    Observability is registry-direct (utils/metrics; the always-on
    durable-counter contract): ``<name>.state`` gauge
    (0 closed / 1 open / 2 half_open), ``<name>.opened_total`` /
    ``.half_opened_total`` / ``.closed_total`` / ``.fast_fails_total``
    counters, and a ``<name>.transition`` event (gated, like all
    events) carrying the trip cause.
    """

    def __init__(
        self,
        name: str = "sidecar.breaker",
        threshold: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        clock=time.monotonic,
    ):
        self.name = name
        self._lock = threading.Lock()
        self._clock = clock
        # env values ride the knobs warn-and-default posture; a
        # fractional threshold (0 < v < 1) additionally clamps to 1 so
        # int() truncation can never produce a lazily-crashing 0
        self._threshold = (
            max(1, int(knobs.get_float("SRJTORCH_BREAKER_THRESHOLD")))
            if threshold is None
            else int(threshold)
        )
        self._cooldown_s = (
            knobs.get_float("SRJTORCH_BREAKER_COOLDOWN_SEC")
            if cooldown_s is None
            else float(cooldown_s)
        )
        if self._threshold < 1:
            raise ValueError(
                f"breaker threshold must be >= 1, got {self._threshold}"
            )
        if self._cooldown_s <= 0:
            raise ValueError(
                f"breaker cooldown must be > 0, got {self._cooldown_s}"
            )
        self._state = STATE_CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probe_in_flight = False
        self._last_trip_cause: Optional[str] = None
        self._transitions = {STATE_CLOSED: 0, STATE_OPEN: 0, STATE_HALF_OPEN: 0}
        self._fast_fails = 0
        self._gauge().set(BREAKER_STATE_CODES[STATE_CLOSED])

    # -- metrics plumbing ----------------------------------------------------

    def _gauge(self):
        from . import metrics

        return metrics.registry().gauge(f"{self.name}.state")

    def _transition_locked(self, new_state: str, cause: str) -> None:
        from . import metrics

        self._state = new_state
        self._transitions[new_state] += 1
        suffix = {
            STATE_OPEN: "opened_total",
            STATE_HALF_OPEN: "half_opened_total",
            STATE_CLOSED: "closed_total",
        }[new_state]
        metrics.registry().counter(f"{self.name}.{suffix}").inc()
        self._gauge().set(BREAKER_STATE_CODES[new_state])
        metrics.event(
            f"{self.name}.transition", state=new_state, cause=cause,
            consecutive_failures=self._failures,
        )

    # -- configuration -------------------------------------------------------

    def configure(
        self, threshold: Optional[int] = None, cooldown_s: Optional[float] = None
    ) -> None:
        """Replace the knobs and reset the state machine (tests, and
        operators re-tuning a live process)."""
        with self._lock:
            if threshold is not None:
                if int(threshold) < 1:
                    raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
                self._threshold = int(threshold)
            if cooldown_s is not None:
                if float(cooldown_s) <= 0:
                    raise ValueError(f"breaker cooldown must be > 0, got {cooldown_s}")
                self._cooldown_s = float(cooldown_s)
            self._reset_locked()

    def reset(self) -> None:
        """Back to CLOSED with zeroed local history (registry counters
        are cumulative and keep their totals)."""
        with self._lock:
            self._reset_locked()

    def _reset_locked(self) -> None:
        self._state = STATE_CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probe_in_flight = False
        self._last_trip_cause = None
        self._transitions = {STATE_CLOSED: 0, STATE_OPEN: 0, STATE_HALF_OPEN: 0}
        self._fast_fails = 0
        self._gauge().set(BREAKER_STATE_CODES[STATE_CLOSED])

    # -- the state machine ---------------------------------------------------

    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May this request ride the device path? False == fast-fail
        (degrade immediately, no dial). Entering half-open happens here,
        lazily, on the first request after the cooldown."""
        from . import metrics

        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN and self._clock() >= self._open_until:
                self._transition_locked(STATE_HALF_OPEN, cause="cooldown_elapsed")
                self._probe_in_flight = True
                return True
            if self._state == STATE_HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            self._fast_fails += 1
            metrics.registry().counter(f"{self.name}.fast_fails_total").inc()
            return False

    def record_success(self) -> None:
        """A device-path request round-tripped: reset the consecutive-
        failure run; a successful half-open probe closes the breaker."""
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            if self._state != STATE_CLOSED:
                self._transition_locked(STATE_CLOSED, cause="probe_success")

    def abort_probe(self) -> None:
        """Release the half-open probe slot with NO health verdict (the
        probe was interrupted, not answered) so the breaker cannot wedge
        in half-open fast-failing forever."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self, cause: str = "failure") -> None:
        """One supervision failure. Trips OPEN at the threshold (or
        instantly from HALF_OPEN: the probe failed, the path is still
        bad) and (re)starts the cooldown."""
        with self._lock:
            self._failures += 1
            self._probe_in_flight = False
            if self._state == STATE_HALF_OPEN or (
                self._state == STATE_CLOSED and self._failures >= self._threshold
            ):
                self._last_trip_cause = cause
                self._open_until = self._clock() + self._cooldown_s
                self._transition_locked(STATE_OPEN, cause=cause)
            elif self._state == STATE_OPEN:
                # stragglers failing while open keep the cooldown fresh
                self._open_until = self._clock() + self._cooldown_s

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-clean state for runtime.stats_report()."""
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "opened_total": self._transitions[STATE_OPEN],
                "half_opened_total": self._transitions[STATE_HALF_OPEN],
                "closed_total": self._transitions[STATE_CLOSED],
                "fast_fails_total": self._fast_fails,
                "last_trip_cause": self._last_trip_cause,
                "threshold": self._threshold,
                "cooldown_s": self._cooldown_s,
            }
