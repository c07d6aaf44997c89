"""Retry orchestrator: bounded backoff, retry-with-split and the
capacity re-try accounting (port of the JAX package's ``utils/retry.py``;
the RmmRapidsRetryIterator analog).

``FatalDeviceError`` (the executor must be replaced) is NEVER retried
here; ``RetryableError`` (transient: Spark's task retry re-runs the
batch) is, and ``DataCorruption`` is a RetryableError whose re-run reads
fresh bytes. Three strategies:

1. **Bounded retry + exponential backoff + jitter**
   (``call_with_retry``): up to ``max_attempts`` attempts, sleeping
   ``base * 2^attempt`` ms (capped at ``max_delay_ms``) with seeded
   multiplicative jitter between them.
2. **Retry-with-split** (``retry_with_split``): on a
   RESOURCE_EXHAUSTED-class failure (``MemoryBudgetExceeded``, the
   reference's ``RESOURCE_EXHAUSTED`` marker, or the card's ``CUDA out
   of memory``) halve the batch, run the halves (each again under
   bounded retry, recursively up to ``split_depth``) and reassemble them
   with the port's ``ops/copying.slice_table`` / ``concatenate``.
3. **Capacity re-try** lives in ``parallel/shuffle.py``
   (``on_overflow="retry"``); this module only counts it
   (``record_capacity_retry``, ``stats()["capacity_retries"]``).

Knobs (read once at import; ``configure`` / ``enabled`` override):
``SRJTORCH_RETRY_ENABLED``, ``SRJTORCH_RETRY_MAX_ATTEMPTS``,
``SRJTORCH_RETRY_BASE_DELAY_MS``, ``SRJTORCH_RETRY_MAX_DELAY_MS``,
``SRJTORCH_RETRY_JITTER``, ``SRJTORCH_RETRY_SPLIT_DEPTH``,
``SRJTORCH_RETRY_SEED``.

Deadline interplay (``utils/deadline.py``): no attempt (or split) starts
once the active budget is gone or its token tripped, and a backoff that
would cross the deadline raises ``DeadlineExceeded`` at once instead of
sleeping; ``retry.deadline_exceeded`` / ``retry.backoff_truncated_total``
count the two outcomes. With the orchestrator armed every ``op_boundary``
op retries RetryableErrors; disarmed (the default) they propagate to the
caller unchanged.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from . import knobs
from .errors import DeadlineExceeded, FatalDeviceError, RetryableError
from .knobs import env_float  # noqa: F401  historical home; re-exported

__all__ = [
    "env_float",
    "RetryPolicy",
    "call_with_retry",
    "retry_with_split",
    "is_resource_exhausted",
    "configure",
    "policy",
    "enable",
    "disable",
    "is_enabled",
    "enabled",
    "stats",
    "reset_stats",
]


class RetryPolicy:
    """Immutable-ish bundle of retry knobs; see module docstring for
    the matching SRJTORCH_RETRY_* environment schema."""

    __slots__ = (
        "max_attempts",
        "base_delay_ms",
        "max_delay_ms",
        "jitter",
        "split_depth",
        "sleep",
        "_rng",
    )

    def __init__(
        self,
        max_attempts: int = 4,
        base_delay_ms: float = 25.0,
        max_delay_ms: float = 1000.0,
        jitter: float = 0.25,
        split_depth: int = 3,
        seed: Optional[int] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_delay_ms < 0 or max_delay_ms < 0:
            raise ValueError("backoff delays must be non-negative")
        if not (0 <= jitter < 1):
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        if split_depth < 0:
            raise ValueError(f"split_depth must be >= 0, got {split_depth}")
        self.max_attempts = int(max_attempts)
        self.base_delay_ms = float(base_delay_ms)
        self.max_delay_ms = float(max_delay_ms)
        self.jitter = float(jitter)
        self.split_depth = int(split_depth)
        self.sleep = sleep
        self._rng = random.Random(seed)

    @classmethod
    def from_env(cls, env=None) -> "RetryPolicy":
        seed = knobs.get_int("SRJTORCH_RETRY_SEED", env=env)
        return cls(
            max_attempts=int(knobs.get_float("SRJTORCH_RETRY_MAX_ATTEMPTS", env=env)),
            base_delay_ms=knobs.get_float("SRJTORCH_RETRY_BASE_DELAY_MS", env=env),
            max_delay_ms=knobs.get_float("SRJTORCH_RETRY_MAX_DELAY_MS", env=env),
            jitter=knobs.get_float("SRJTORCH_RETRY_JITTER", env=env),
            split_depth=int(knobs.get_float("SRJTORCH_RETRY_SPLIT_DEPTH", env=env)),
            seed=seed,
        )

    def backoff_ms(self, attempt: int) -> float:
        """Delay before re-running attempt ``attempt + 1`` (0-based):
        exponential with multiplicative jitter (so a fleet of executors
        retrying the same stall does not re-stampede in lockstep),
        clamped LAST — ``max_delay_ms`` is a hard ceiling, never
        exceeded by jitter."""
        raw = self.base_delay_ms * (2.0**attempt)
        if self.jitter:
            raw *= self._rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)
        return min(raw, self.max_delay_ms)


class _Stats:
    """Cross-thread counters for observability and chaos assertions."""

    __slots__ = ("lock", "attempts", "retries", "splits", "capacity_retries",
                 "fatal", "exhausted", "backoff_ms_total",
                 "deadline_exceeded", "backoff_truncated")

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.attempts = 0
        self.retries = 0
        self.splits = 0
        self.capacity_retries = 0
        self.fatal = 0
        self.exhausted = 0
        self.backoff_ms_total = 0.0
        self.deadline_exceeded = 0
        self.backoff_truncated = 0

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "attempts": self.attempts,
                "retries": self.retries,
                "splits": self.splits,
                "capacity_retries": self.capacity_retries,
                "fatal": self.fatal,
                "exhausted": self.exhausted,
                "backoff_ms_total": self.backoff_ms_total,
                "deadline_exceeded": self.deadline_exceeded,
                "backoff_truncated": self.backoff_truncated,
            }


_stats = _Stats()


def stats() -> dict:
    return _stats.snapshot()


def reset_stats() -> None:
    with _stats.lock:
        _stats.reset()


def record_capacity_retry(n: int = 1) -> None:
    """Called by the shuffle capacity re-try loop (parallel/shuffle.py)."""
    with _stats.lock:
        _stats.capacity_retries += n
    from . import metrics

    metrics.counter("shuffle.capacity_retries").inc(n)


# ---------------------------------------------------------------------------
# module-level policy + arming (env once, programmatic any time)
# ---------------------------------------------------------------------------

try:
    _policy = RetryPolicy.from_env()
except ValueError as _e:  # out-of-range knobs degrade, never crash import
    import warnings

    warnings.warn(f"retry: invalid SRJTORCH_RETRY_* configuration ({_e}); using defaults")
    _policy = RetryPolicy()
_enabled = knobs.get_bool("SRJTORCH_RETRY_ENABLED")
_lock = threading.Lock()

# per-thread nesting guard: only the OUTERMOST armed op_boundary owns
# the retry loop. Without it, layered boundaries (exchange_by_key ->
# all_to_all_exchange) would multiply attempts (max_attempts^depth)
# and stack backoff sleeps before a persistent failure surfaces.
_tls = threading.local()


def in_attempt() -> bool:
    """True while a call_with_retry attempt is executing on this
    thread (utils/dispatch.py consults this to keep nested boundaries
    from opening their own retry loops)."""
    return getattr(_tls, "depth", 0) > 0


def policy() -> RetryPolicy:
    return _policy


def configure(**kwargs) -> RetryPolicy:
    """Replace the module policy (same keywords as RetryPolicy)."""
    global _policy
    with _lock:
        _policy = RetryPolicy(**kwargs)
        return _policy


def enable() -> None:
    """Arm op-boundary retry (utils/dispatch.py consults this)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enabled(**kwargs):
    """Scoped arming for tests / chaos runs; keyword overrides install a
    temporary policy (e.g. ``with retry.enabled(base_delay_ms=1): ...``)."""
    global _policy, _enabled
    prev_policy, prev_enabled = _policy, _enabled
    if kwargs:
        configure(**kwargs)
    _enabled = True
    try:
        yield _policy
    finally:
        _policy, _enabled = prev_policy, prev_enabled


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------


def _raise_deadline_exceeded(d, op_name: str, cause):
    """The deadline budget died mid-orchestration: count it — the
    ``retry.deadline_exceeded`` counter is how stats_report tells "gave
    up on budget" from "exhausted attempts" — and raise DeadlineExceeded
    chained to the last transient failure (the root cause the budget ran
    out retrying)."""
    from . import metrics

    with _stats.lock:
        _stats.deadline_exceeded += 1
    metrics.counter("retry.deadline_exceeded").inc()
    metrics.event(
        "retry.deadline_exceeded", op=op_name,
        cls=None if cause is None else type(cause).__name__,
    )
    raise d.exceeded(op_name) from cause


def is_resource_exhausted(exc: BaseException) -> bool:
    """RESOURCE_EXHAUSTED-class: the failure scales with input size, so
    splitting the batch (not just waiting) is the productive retry."""
    from .memory import MemoryBudgetExceeded

    text = str(exc)
    # the card's allocator OOM is RESOURCE_EXHAUSTED's counterpart
    # (utils/errors.py classifies it as retryable for the same reason)
    return (isinstance(exc, MemoryBudgetExceeded) or "RESOURCE_EXHAUSTED" in text
            or "CUDA out of memory" in text)


def call_with_retry(
    fn: Callable[..., Any],
    *args,
    op_name: str = "op",
    policy: Optional[RetryPolicy] = None,
    **kwargs,
):
    """Run ``fn(*args, **kwargs)`` under bounded retry + backoff.

    RetryableError retries up to ``policy.max_attempts`` total attempts;
    the final failure re-raises the LAST error. FatalDeviceError never
    retries — re-running batches on a dead device strands the executor
    (the reference's CudaFatalTest contract).

    Deadline discipline (utils/deadline.py): under an active deadline
    scope the orchestrator never STARTS an attempt once the budget is
    gone or the cancel token tripped — it raises DeadlineExceeded
    (chained to the last transient failure) instead — and a backoff
    that would cross the deadline raises immediately rather than
    sleeping out budget no attempt can use, so the worst case is
    bounded by the budget, not by max_attempts x max_delay, and the
    residual budget goes back to the caller.
    """
    from . import deadline as deadline_mod
    from . import metrics

    pol = policy if policy is not None else _policy
    last: Optional[RetryableError] = None
    try:
        for attempt in range(pol.max_attempts):
            d = deadline_mod.current()
            if d is not None and d.done():
                _raise_deadline_exceeded(d, op_name, last)
            with _stats.lock:
                _stats.attempts += 1
            metrics.counter("retry.attempts").inc()
            _tls.depth = getattr(_tls, "depth", 0) + 1
            try:
                return fn(*args, **kwargs)
            except FatalDeviceError as e:
                with _stats.lock:
                    _stats.fatal += 1
                metrics.counter("retry.fatal").inc()
                metrics.event("retry.fatal", op=op_name, cls=type(e).__name__)
                raise
            except DeadlineExceeded:
                # the budget died INSIDE the attempt (an interrupted hang, a
                # sidecar request whose socket deadline was the remaining
                # budget): same "gave up on budget" outcome as the loop-top
                # guard, counted the same way
                with _stats.lock:
                    _stats.deadline_exceeded += 1
                metrics.counter("retry.deadline_exceeded").inc()
                metrics.event("retry.deadline_exceeded", op=op_name, attempt=attempt)
                raise
            except RetryableError as e:
                last = e
                if attempt == pol.max_attempts - 1:
                    break
                delay_ms = pol.backoff_ms(attempt)
                if d is not None:
                    if d.done():
                        _raise_deadline_exceeded(d, op_name, last)
                    rem_ms = d.remaining() * 1000.0
                    if delay_ms >= rem_ms:
                        # the backoff would cross the deadline, so the
                        # post-sleep outcome is already determined (the
                        # loop-top guard would refuse the next attempt):
                        # count the truncation, RETURN the residual budget
                        # to the caller, and raise now instead of sleeping
                        # out wall-clock nothing can use
                        with _stats.lock:
                            _stats.backoff_truncated += 1
                        metrics.counter("retry.backoff_truncated_total").inc()
                        metrics.event(
                            "retry.backoff_truncated", op=op_name, attempt=attempt,
                            delay_ms=round(delay_ms, 3),
                            remaining_ms=round(rem_ms, 3),
                        )
                        _raise_deadline_exceeded(d, op_name, last)
                with _stats.lock:
                    _stats.retries += 1
                    _stats.backoff_ms_total += delay_ms
                # per-error-class counters (the chaos assertions read these:
                # one injected fault == one retry of its class)
                cls = type(e).__name__
                metrics.counter("retry.retries").inc()
                metrics.counter(f"retry.retries.{cls}").inc()
                metrics.histogram("retry.backoff_ms").record(delay_ms)
                metrics.event(
                    "retry.backoff", op=op_name, attempt=attempt, cls=cls,
                    delay_ms=round(delay_ms, 3),
                )
                # the retry history lands ON the
                # enclosing op span (utils/dispatch.py opens it around the
                # whole boundary) — attempts-so-far overwrites each round,
                # so a finished span reads "how many re-runs this op cost"
                from . import tracing

                tracing.annotate(retry_attempts=attempt + 1, retry_error=cls)
                if delay_ms > 0:
                    pol.sleep(delay_ms / 1000.0)
            finally:
                _tls.depth -= 1
        with _stats.lock:
            _stats.exhausted += 1
        metrics.counter("retry.exhausted").inc()
        metrics.counter(f"retry.exhausted.{type(last).__name__}").inc()
        metrics.event("retry.exhausted", op=op_name, cls=type(last).__name__)
        raise last
    finally:
        # a retried error's traceback holds this frame, and this frame
        # held the error: a cycle that would keep every frame's tensors
        # (an attempt's inputs) alive until the cycle collector ran
        last = None


def _default_split(batch):
    from ..ops.copying import slice_table

    n = batch.num_rows
    mid = n // 2
    return slice_table(batch, 0, mid), slice_table(batch, mid, n)


def _default_combine(parts: Sequence[Any]):
    from ..ops.copying import concatenate

    return concatenate(list(parts))


def _batch_rows(batch) -> int:
    n = getattr(batch, "num_rows", None)
    return int(n) if n is not None else len(batch)


def retry_with_split(
    fn: Callable[[Any], Any],
    batch,
    *,
    split: Optional[Callable[[Any], tuple]] = None,
    combine: Optional[Callable[[List[Any]], Any]] = None,
    op_name: str = "op",
    policy: Optional[RetryPolicy] = None,
):
    """Run ``fn(batch)`` under bounded retry; on RESOURCE_EXHAUSTED-class
    exhaustion halve the batch and recurse (up to ``policy.split_depth``
    levels), reassembling with ``combine`` — the RmmRapidsRetryIterator
    splitAndRetry analog.

    Defaults treat ``batch`` as a ``columnar.Table``: ``split`` is a
    row-range halving (ops.copying.slice_table) and ``combine`` is
    row-wise ``concatenate``. Pass both for any other batch shape.

    Non-exhaustion RetryableErrors never split (halving does not fix a
    flaky transport); they surface after bounded retry. FatalDeviceError
    propagates immediately.
    """
    pol = policy if policy is not None else _policy
    split = split if split is not None else _default_split
    combine = combine if combine is not None else _default_combine

    def run(b, depth: int):
        try:
            return call_with_retry(fn, b, op_name=op_name, policy=pol)
        except RetryableError as e:
            # the reassembly loop consults the deadline/cancel token
            # BETWEEN attempts: never start a split whose halves cannot
            # finish inside the budget (call_with_retry guards each
            # attempt, but the split decision itself is a cancel point)
            from . import deadline as deadline_mod

            d = deadline_mod.current()
            if d is not None and d.done():
                _raise_deadline_exceeded(d, op_name, e)
            if (
                not is_resource_exhausted(e)
                or depth >= pol.split_depth
                or _batch_rows(b) < 2
            ):
                raise
            with _stats.lock:
                _stats.splits += 1
            from . import metrics

            cls = type(e).__name__
            metrics.counter("retry.splits").inc()
            metrics.counter(f"retry.splits.{cls}").inc()
            metrics.event(
                "retry.split", op=op_name, depth=depth, cls=cls,
                rows=_batch_rows(b),
            )
            lo, hi = split(b)

            # each half is a CHILD span of the
            # op span (or the parent half's span on deeper recursion),
            # so a split cascade reads as a tree of shrinking batches
            def _half(x):
                from . import tracing

                with tracing.span(
                    "retry.split", depth=depth + 1, rows=_batch_rows(x)
                ):
                    return run(x, depth + 1)

            return combine([_half(lo), _half(hi)])

    return run(batch, 0)
