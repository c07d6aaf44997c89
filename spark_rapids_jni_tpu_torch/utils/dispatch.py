"""Op-boundary dispatch wrapper: the JNI-entry-point preamble (port of the
JAX package's ``utils/dispatch.py``).

Every reference JNI export runs one preamble: device binding, exception
translation and an NVTX range (``RowConversionJni.cpp:42-57``).
``op_boundary`` is that preamble for the port: the fault-injection hook,
the tracing span and profiler ranges, backend-error classification
(fatal against retryable), the deadline scope and cancel point, and,
with the retry orchestrator armed, bounded retry with backoff.

Tier names. ``note_tier`` counts which formulation served a tiered
dispatch in ``dispatch.tier.<tier>``. The reference reports ``pallas``
(its kernel tier), ``xla`` (its fallback formulation) and ``degrade`` (a
kernel failure it absorbed). The port reports ``cuda`` where the
reference reports ``pallas`` (a hand-written kernel served the call) and
``torch`` where it reports ``xla`` (the plain PyTorch version served it:
a CPU tensor, or a shape the kernel does not take). ``degrade`` never
occurs: the port has no fallback, and a kernel's failure is the op's
error. ``TIER_NAMES`` holds the map.

Memory governance. The reference's boundary also admits the outermost op
through its memory governor (``memgov``); the port has no governor yet,
so its boundary has no such branch. The reserved ``memory_bytes=``
keyword is popped and ignored, so that callers stay source-compatible.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, Optional

from . import deadline, faultinj, metrics, tracing
from .errors import DeviceError, classify

__all__ = ["op_boundary", "note_tier", "TIER_NAMES"]

# the reference's tier name -> the port's
TIER_NAMES = {"pallas": "cuda", "xla": "torch", "degrade": "degrade"}

# counted registry-direct (durable bookkeeping, independent of the
# metrics gate); handles are cached, one dict read a note after the first
_tier_handles: Dict[str, object] = {}
_tier_handles_lock = threading.Lock()


def note_tier(tier: str, op: Optional[str] = None) -> None:
    """Record the serving tier of the current dispatch (see above)."""
    c = _tier_handles.get(tier)
    if c is None:
        with _tier_handles_lock:
            c = _tier_handles.get(tier)
            if c is None:
                c = metrics.registry().counter(f"dispatch.tier.{tier}")
                _tier_handles[tier] = c
    c.inc()
    if metrics.is_enabled() and op is not None:
        metrics.event("dispatch.tier", op=op, tier=tier)
    if tracing.is_enabled():
        tracing.annotate(tier=tier)


def _run_boundary(attempt, name: str):
    """Retry arming + metrics timing. Only the OUTERMOST boundary owns
    the retry loop: a nested op's RetryableError propagates to the outer
    attempt, so a persistent failure costs max_attempts re-runs, not
    max_attempts^depth. Written out twice so that the disarmed-metrics
    path touches no clock."""
    from . import retry

    if not metrics.is_enabled():
        if retry.is_enabled() and not retry.in_attempt():
            return retry.call_with_retry(attempt, op_name=name)
        return attempt()
    t0 = time.perf_counter()
    try:
        if retry.is_enabled() and not retry.in_attempt():
            return retry.call_with_retry(attempt, op_name=name)
        return attempt()
    finally:
        metrics.record_op(name, time.perf_counter() - t0)


def op_boundary(name: str):
    """Wrap a public op with the dispatch preamble.

    - ``faultinj.maybe_inject(name)`` fires configured faults first,
      INSIDE the retry attempt, so an injected RetryableError exercises
      the recovery path;
    - ``tracing.func_range(name)`` opens the op's ``record_function`` and
      NVTX ranges around the body (tracing armed only);
    - backend exceptions are classified into Fatal/Retryable
      (``utils/errors.classify``: a refused kernel launch is
      ``FatalDeviceError`` with its text intact, the card's ``CUDA out
      of memory`` is ``RetryableError``); ValueError / TypeError /
      KeyError / IndexError, DeviceErrors and the port's own documented
      API errors (any exception class defined in a module of this
      package or the reference's) pass through unchanged;
    - DEADLINE: every wrapped op takes a reserved ``deadline_s=`` keyword
      that opens a per-call budget scope; with none, the OUTERMOST
      boundary under an ambient ``SRJTORCH_DEADLINE_SEC`` opens the
      per-query scope. Nested boundaries are cancel points of the
      enclosing budget;
    - RETRY: armed, a RetryableError re-runs the op under the module
      policy (FatalDeviceError never does); disarmed (the default) it
      propagates to the caller unchanged;
    - METRICS: armed, each dispatch records ``op.<name>.calls`` and the
      host wall time ``op.<name>.wall_us`` over the whole boundary,
      retries included; nothing here synchronizes the card;
    - the reserved ``memory_bytes=`` keyword is popped and ignored (the
      reference's memory-governor admission is not ported yet).

    Disarmed, the boundary pops two keywords and reads the gates'
    booleans, the ambient budget and a context variable: no clock, no
    torch call, no NVTX call.
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            budget_s = kwargs.pop("deadline_s", None)
            kwargs.pop("memory_bytes", None)

            def attempt():
                faultinj.maybe_inject(name)
                with tracing.func_range(name):
                    try:
                        return fn(*args, **kwargs)
                    except DeviceError:
                        raise
                    except (ValueError, TypeError, KeyError, IndexError):
                        raise
                    except Exception as e:  # backend / runtime failures
                        if type(e).__module__.startswith("spark_rapids_jni_tpu"):
                            # the op's own documented API errors (CastError,
                            # ParquetReadError, ...) are results, not failures
                            raise
                        raise classify(e) from e

            # one deadline scope a query, owned by the boundary that
            # opened it (the retry nesting guard's discipline)
            def scoped():
                dl = deadline.current()
                bs = budget_s
                if bs is None and dl is None:
                    bs = deadline.default_budget()
                if bs is not None:
                    with deadline.scope(bs) as d:
                        d.check(name)
                        return _run_boundary(attempt, name)
                if dl is not None:
                    dl.check(name)  # nested boundary: cancel point only
                return _run_boundary(attempt, name)

            # the op span covers the WHOLE boundary (deadline scope, every
            # attempt, every backoff); a nested boundary's span is a child,
            # and the outermost one with no active trace auto-roots a
            # one-op trace
            if tracing.is_enabled():
                with tracing.op_span(name):
                    return scoped()
            return scoped()

        return wrapper

    return deco
