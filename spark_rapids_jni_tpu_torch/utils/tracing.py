"""Per-query tracing with cross-process propagation, and the card's
profiler ranges (port of the JAX package's ``utils/tracing.py``).

- **TraceContext**: trace_id / span_id / parent_id plus a sampled flag,
  carried context-locally (``contextvars``) beside ``deadline.scope``:
  one context spans a query's whole dynamic extent, threads entered via
  ``contextvars.copy_context()`` included.
- **Span**: one timed region with annotations. ``span(name, **ann)``
  opens a child of the active span; ``op_span`` (``utils/dispatch.py``'s
  entry) also AUTO-ROOTS a one-op trace at the outermost boundary when
  no context is active.
- **Gated no-op stubs**: with ``SRJTORCH_TRACE_ENABLED`` off every entry
  point is one boolean read and a shared null object (no ids minted, no
  clock read, no allocation, no torch call).
- **Cross-process propagation**: ``wire_context()`` packs the active
  context into a fixed 17-byte blob (trace_id, parent span id, flags;
  ``struct "<QQB"``); the receiving process installs it with
  ``remote_scope`` so its spans parent to the caller's span.
- **Flight recorder** (``utils/trace_sink.py``): every finished root
  trace lands in a bounded ring; slow and failed queries flush to the
  span log with their span tree and a metrics delta.

The reference's XProf hooks become the card's: ``func_range`` opens a
``torch.profiler.record_function`` range (what a ``torch.profiler``
trace shows around the op's kernels) and, once CUDA is initialised in
the process, an NVTX range (``torch.cuda.nvtx.range_push`` /
``range_pop``: the reference's ``CUDF_FUNC_RANGE``, what ``nsys`` shows).
``profile_to`` records a ``torch.profiler`` session with CPU and CUDA
activities into ``log_dir`` as a Chrome trace.

Knobs (``utils/knobs.py``): ``SRJTORCH_TRACE_ENABLED``,
``SRJTORCH_TRACE_LOG``, ``SRJTORCH_TRACE_SAMPLE``,
``SRJTORCH_SLOW_QUERY_SEC``, ``SRJTORCH_TRACE_RING``,
``SRJTORCH_TRACE_MAX_SPANS``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import struct
import threading
import time
from typing import Optional

from . import knobs

__all__ = [
    "set_enabled",
    "is_enabled",
    "enabled",
    "func_range",
    "profile_to",
    "TraceContext",
    "Span",
    "QueryTrace",
    "span",
    "op_span",
    "closed_span",
    "event_span",
    "annotate",
    "start_trace",
    "current_context",
    "current_span",
    "wire_context",
    "decode_wire_context",
    "remote_scope",
    "TRACE_CTX_LEN",
]

# one module bool, rebound plainly (the metrics._enabled discipline)
_enabled = knobs.get_bool("SRJTORCH_TRACE_ENABLED")


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enabled():
    """Scoped arming for tests and benches (mirrors metrics.enabled)."""
    global _enabled
    prev = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = prev


@contextlib.contextmanager
def func_range(name: str):
    """Profiler ranges over an op: a ``record_function`` range, plus an
    NVTX range once CUDA is initialised (a CPU-only process, or one that
    never touched the card, opens none). No-op when tracing is off: no
    torch call at all, the NVTX-disabled contract."""
    if not _enabled:
        yield
        return
    import torch

    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Record a host + device profile of the body into ``log_dir`` as a
    Chrome trace (``trace.<pid>.json``; the nsys-profile analog for a
    region). Gate-aware: with tracing disabled the body runs unprofiled.
    Exception-safe: a profiler start that raises after arming part of
    the session is torn down before the error surfaces, so the next
    ``profile_to`` does not fail on a session it did not start."""
    if not _enabled:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
    except BaseException:
        try:
            prof.stop()
        except Exception:  # srjt-lint: allow-broad-except(best-effort teardown of a partially-armed profiler session; the original start_trace error is what surfaces)
            pass
        raise
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.json"))


# ---------------------------------------------------------------------------
# distributed spans: ids, context, and the context-local carrier
# ---------------------------------------------------------------------------

# wire blob (cross-process propagation): trace_id, parent span id,
# flags (bit 0 = sampled). Fixed size so the sidecar worker and the
# exchange peer read exactly TRACE_CTX_LEN bytes after the header.
_TRACE_BLOB = struct.Struct("<QQB")
TRACE_CTX_LEN = _TRACE_BLOB.size  # 17


def _new_id() -> int:
    """64-bit random span/trace id (armed paths only — never minted
    when the gate is off)."""
    return int.from_bytes(os.urandom(8), "little") or 1


class _NullSpan:
    """Shared no-op handed out when tracing is disabled or the trace is
    unsampled: annotate() is a pass, so instrumented sites stay
    branch-free."""

    __slots__ = ()
    span_id = 0
    depth = 0

    def annotate(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """One timed region of a trace. Created only through the module
    entry points; finished (duration computed, record emitted) by the
    ``span()`` context manager. ``annotate()`` is owner-thread writes
    (or race-settle-lock writes, the hedge winner mark) — the record is
    built only at finish, after all writers are done."""

    __slots__ = ("ctx", "name", "span_id", "parent_id", "depth",
                 "t_wall", "_t0", "annotations", "status")

    def __init__(self, ctx: "TraceContext", name: str,
                 parent_id: Optional[int], depth: int, annotations):
        self.ctx = ctx
        self.name = name
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.depth = depth
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        self.annotations = dict(annotations) if annotations else {}
        self.status = "ok"

    def annotate(self, **kw) -> None:
        self.annotations.update(kw)

    def _record(self, dur_s: float) -> dict:
        rec = {
            "kind": "span",
            "trace": f"{self.ctx.trace_id:016x}",
            "span": f"{self.span_id:016x}",
            "parent": (None if self.parent_id is None
                       else f"{self.parent_id:016x}"),
            "name": self.name,
            "ts": round(self.t_wall, 6),
            "dur_us": round(dur_s * 1e6, 1),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "status": self.status,
        }
        if self.annotations:
            rec["annotations"] = self.annotations
        return rec


class _Anchor:
    """Parent-only carrier for a REMOTE context (the caller's span id
    decoded off the wire): spans created under it parent to the remote
    span, but there is no local Span object to finish."""

    __slots__ = ("span_id", "depth")

    def __init__(self, span_id: int):
        self.span_id = span_id
        self.depth = 0


class TraceContext:
    """One query's trace identity plus its per-process span buffer.
    The buffer is BOUNDED (``SRJTORCH_TRACE_MAX_SPANS``; overflow counted,
    the span LOG is never capped) and SEALED when the root finishes —
    a straggling hedge loser that completes after the query settled
    still reaches the log, it just misses the in-memory record."""

    __slots__ = ("trace_id", "sampled", "remote", "_lock", "_spans",
                 "_dropped", "_sealed", "_counters0", "_max_spans")

    def __init__(self, trace_id: Optional[int] = None, sampled: bool = True,
                 remote: bool = False):
        self.trace_id = _new_id() if trace_id is None else int(trace_id)
        self.sampled = bool(sampled)
        self.remote = bool(remote)
        self._lock = threading.Lock()
        self._spans: list = []
        self._dropped = 0
        self._sealed = False
        self._counters0: Optional[dict] = None
        self._max_spans = knobs.get_int("SRJTORCH_TRACE_MAX_SPANS")

    def add(self, rec: dict) -> None:
        with self._lock:
            if self._sealed:
                return  # straggler past the root finish: log-only
            if len(self._spans) < self._max_spans:
                self._spans.append(rec)
            else:
                self._dropped += 1

    def seal(self):
        """Freeze the buffer; returns (spans, dropped)."""
        with self._lock:
            self._sealed = True
            return list(self._spans), self._dropped


# the active (context, span-like) pair; span-like is the innermost OPEN
# Span (or a remote _Anchor) new spans parent to
_current: contextvars.ContextVar = contextvars.ContextVar(
    "srjtorch_trace_ctx", default=None
)


def current_context() -> Optional[TraceContext]:
    a = _current.get()
    return None if a is None else a[0]


def current_span():
    """The innermost open Span (or remote anchor), or None."""
    a = _current.get()
    return None if a is None else a[1]


def _sink():
    from . import trace_sink

    return trace_sink


def _record_and_emit(ctx: TraceContext, rec: dict, depth: int) -> None:
    """The one record pipeline every finished span goes through:
    in-memory buffer, span log, stage-summary counters."""
    ctx.add(rec)
    sink = _sink()
    sink.emit_span(rec)
    sink.note_span(rec["dur_us"], depth)


def _finish_span(sp: Span) -> None:
    dur_s = time.perf_counter() - sp._t0
    _record_and_emit(sp.ctx, sp._record(dur_s), sp.depth)


@contextlib.contextmanager
def span(name: str, **annotations):
    """A child span of the active trace. No-op (shared null span) when
    tracing is disabled or no sampled context is active — random
    instrumented layers never mint stray traces; roots come only from
    ``start_trace`` (the serve scheduler) and ``op_span`` (the
    outermost op boundary). An escaping exception marks the span
    status ``error`` (and propagates)."""
    if not _enabled:
        yield _NULL_SPAN
        return
    a = _current.get()
    if a is None or not a[0].sampled:
        yield _NULL_SPAN
        return
    ctx, parent = a
    sp = Span(ctx, name, parent.span_id, parent.depth + 1, annotations)
    tok = _current.set((ctx, sp))
    try:
        yield sp
    except BaseException as e:
        sp.status = "error"
        sp.annotations.setdefault("error", type(e).__name__)
        raise
    finally:
        _current.reset(tok)
        _finish_span(sp)


def event_span(name: str, **annotations) -> None:
    """An instantaneous event recorded as a zero-duration closed child
    span: how a layer stamps a decision into the query's span tree
    without opening a region. Same no-op contract as ``closed_span``: nothing happens
    without an active sampled context."""
    closed_span(name, 0.0, **annotations)


def closed_span(name: str, dur_s: float, t_wall: Optional[float] = None,
                **annotations) -> None:
    """Record an already-elapsed region (e.g. the serve queue wait,
    measured between submit and dispatch) as a finished child span of
    the active trace. No-op without an active sampled context."""
    if not _enabled:
        return
    a = _current.get()
    if a is None or not a[0].sampled:
        return
    ctx, parent = a
    sp = Span(ctx, name, parent.span_id, parent.depth + 1, annotations)
    sp.t_wall = time.time() - dur_s if t_wall is None else t_wall
    _record_and_emit(ctx, sp._record(max(float(dur_s), 0.0)), sp.depth)


def annotate(**kw) -> None:
    """Annotate the innermost open span (no-op when none is active) —
    the retry orchestrator stamps attempt counts through this without
    knowing which layer's span it lands on."""
    if not _enabled:
        return
    a = _current.get()
    if a is None or not a[0].sampled:
        return
    sp = a[1]
    if isinstance(sp, Span):
        sp.annotations.update(kw)


# ---------------------------------------------------------------------------
# roots: per-query traces (serve scheduler, outermost op boundary)
# ---------------------------------------------------------------------------


class QueryTrace:
    """One root span + its context: the handle the query's OWNER holds
    across threads (the serve scheduler stores it on the QueryHandle;
    ``op_span`` holds it for one dispatch). ``activate()`` installs it
    on the executing thread; ``finish(status)`` is idempotent — it
    seals the context, computes the metrics delta, and hands the
    completed trace to the flight recorder (which flushes slow / shed /
    failed queries to the span log automatically)."""

    __slots__ = ("ctx", "root", "_lock", "_finished")

    def __init__(self, ctx: TraceContext, root: Span):
        self.ctx = ctx
        self.root = root
        self._lock = threading.Lock()
        self._finished = False

    @contextlib.contextmanager
    def activate(self):
        tok = _current.set((self.ctx, self.root))
        try:
            yield self
        finally:
            _current.reset(tok)

    def annotate(self, **kw) -> None:
        self.root.annotations.update(kw)

    def finish(self, status: str = "ok") -> None:
        with self._lock:
            if self._finished:
                return
            self._finished = True
        if not self.ctx.sampled:
            # an UNSAMPLED query trace: the context existed only so
            # inner layers saw "a trace is active (and declined)" —
            # nothing was buffered, nothing is recorded
            return
        dur_s = time.perf_counter() - self.root._t0
        self.root.status = status
        _record_and_emit(self.ctx, self.root._record(dur_s),
                         self.root.depth)
        sink = _sink()
        spans, dropped = self.ctx.seal()
        delta = None
        if self.ctx._counters0 is not None:
            from . import metrics

            delta = {
                k: v - self.ctx._counters0.get(k, 0)
                for k, v in metrics.counters_snapshot().items()
                if v != self.ctx._counters0.get(k, 0)
            }
        sink.record_trace({
            "kind": "trace",
            "trace": f"{self.ctx.trace_id:016x}",
            "name": self.root.name,
            "status": status,
            "ts": round(self.root.t_wall, 6),
            "duration_s": round(dur_s, 6),
            "pid": os.getpid(),
            "annotations": self.root.annotations,
            "spans": spans,
            "dropped_spans": dropped,
            "metrics_delta": delta or {},
        })


def _sampled() -> bool:
    frac = knobs.get_float("SRJTORCH_TRACE_SAMPLE")
    if frac is None or frac >= 1.0:
        return True
    if frac <= 0.0:
        return False
    return random.random() < frac


def start_trace(name: str, **annotations) -> Optional[QueryTrace]:
    """Open a ROOT span + context for one query. Returns None only
    when tracing is DISABLED (callers keep a None-guard, the
    one-boolean-read contract). When the SAMPLER declines, an
    UNSAMPLED QueryTrace is returned instead: activating it installs
    a not-sampled context, so every layer inside the query — span(),
    wire_context(), and crucially op_span's auto-root — sees "a trace
    decision was made" and stays silent, rather than each outermost op
    boundary re-rolling the sampler and minting one-op fragment
    traces. The start-of-query counters snapshot (sampled roots only)
    feeds the flight recorder's metrics-delta."""
    if not _enabled:
        return None
    if not _sampled():
        _sink().note_unsampled()
        ctx = TraceContext(sampled=False)
        return QueryTrace(ctx, Span(ctx, name, None, 0, None))
    from . import metrics

    ctx = TraceContext()
    ctx._counters0 = metrics.counters_snapshot()
    root = Span(ctx, name, None, 0, annotations)
    _sink().note_trace()
    return QueryTrace(ctx, root)


@contextlib.contextmanager
def op_span(name: str):
    """utils/dispatch.py's entry: a child span when a trace is active,
    else a fresh auto-rooted one-op trace (mirroring the deadline
    ``op_scope`` outermost-only policy) — a standalone runtime call is
    a one-op query, traceable without the serving layer."""
    if not _enabled:
        yield _NULL_SPAN
        return
    a = _current.get()
    if a is not None:
        with span(f"op.{name}") as sp:
            yield sp
        return
    qt = start_trace(f"op.{name}")
    if qt is None:
        yield _NULL_SPAN
        return
    status = "ok"
    try:
        with qt.activate():
            yield qt.root
    except BaseException:
        status = "failed"
        raise
    finally:
        qt.finish(status)


# ---------------------------------------------------------------------------
# cross-process propagation (the TRACE wire bit / traced fetch verb)
# ---------------------------------------------------------------------------


def wire_context() -> Optional[bytes]:
    """The active sampled context packed for the wire (17 bytes:
    trace_id, the CURRENT span id as the remote parent, flags), or None
    when tracing is off / no sampled context is active — the caller
    only sets its TRACE flag bit when this returns bytes, so legacy
    peers never see the blob."""
    if not _enabled:
        return None
    a = _current.get()
    if a is None or not a[0].sampled:
        return None
    return _TRACE_BLOB.pack(a[0].trace_id, a[1].span_id, 1)


def decode_wire_context(blob: bytes):
    """(trace_id, parent_span_id, sampled) off a wire blob."""
    tid, parent, flags = _TRACE_BLOB.unpack(blob)
    return tid, parent, bool(flags & 1)


@contextlib.contextmanager
def remote_scope(trace_id: int, parent_span_id: int, sampled: bool = True):
    """Install a REMOTE context (decoded off the wire) for one
    request's dynamic extent: spans created inside parent to the
    caller's span and stream to THIS process's span log — the root
    lives in the submitting process; tracemerge joins the logs by
    trace_id."""
    if not _enabled or not sampled:
        yield
        return
    ctx = TraceContext(trace_id=trace_id, remote=True)
    tok = _current.set((ctx, _Anchor(parent_span_id)))
    try:
        yield
    finally:
        _current.reset(tok)
