"""Span emitter and slow-query flight recorder (port of the JAX
package's ``utils/trace_sink.py``); ``utils/tracing.py`` owns the
context and span front door.

- **Span log**: ``SRJTORCH_TRACE_LOG=<base>`` makes every process append
  its finished spans to ``<base>.<pid>.jsonl``, one JSON object a line,
  one file a process, one ``write()`` a line.
- **Flight recorder**: every finished ROOT trace lands in a ring of the
  last ``SRJTORCH_TRACE_RING`` traces; failed, cancelled or expired
  queries, and those slower than ``SRJTORCH_SLOW_QUERY_SEC``, are FLUSHED
  to the span log with their span tree and a metrics delta.
  ``explain_last()`` renders the worst recent query as an annotated span
  tree (the reference's ``runtime.explain_last`` wraps it; the port's
  ``runtime`` module is not ported yet).

The stage-summary counters (``trace.spans`` / ``trace.traces`` /
``trace.flushed``, the ``trace.max_depth`` gauge and the
``trace.span_us`` histogram) are registry-direct. Nothing here runs
unless the tracing gate armed a span in the first place.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import List, Optional

from . import knobs

__all__ = [
    "emit_span",
    "note_span",
    "note_trace",
    "note_unsampled",
    "record_trace",
    "recorder",
    "FlightRecorder",
    "set_log_path",
    "log_path",
    "resolved_log_path",
    "close_log",
    "explain_last",
    "render_trace",
    "stage_summary",
    "stats_section",
    "reset_for_tests",
]

_log_lock = threading.Lock()
_log_base: Optional[str] = knobs.get_str("SRJTORCH_TRACE_LOG") or None
_log_file = None
_log_file_path: Optional[str] = None


def log_path() -> Optional[str]:
    """The configured span-log BASE path (the per-process file adds a
    ``.<pid>`` suffix; see ``resolved_log_path``)."""
    return _log_base


def resolved_log_path() -> Optional[str]:
    """The per-process span-log file this process appends to, or None:
    ``<base>.<pid>.jsonl`` — per-process files keep worker and client
    logs separate for the tracemerge join, with no cross-process write
    interleaving to reason about."""
    if _log_base is None:
        return None
    root, ext = os.path.splitext(_log_base)
    return f"{root}.{os.getpid()}{ext or '.jsonl'}"


def set_log_path(base: Optional[str]) -> None:
    """Install (or clear) the span-log base path. The per-process file
    opens lazily on the first span."""
    global _log_base, _log_file, _log_file_path
    with _log_lock:
        if _log_file is not None:
            try:
                _log_file.close()
            finally:
                _log_file = None
                _log_file_path = None
        _log_base = base


def close_log() -> None:
    set_log_path(_log_base)


def _write_line(rec: dict) -> None:
    """One JSON line to the per-process span log; a bad path degrades
    the log, never the op being traced."""
    global _log_file, _log_file_path
    if _log_base is None:
        return
    line = json.dumps(rec, default=str) + "\n"
    with _log_lock:
        path = resolved_log_path()
        if path is None:
            return
        if _log_file is None or _log_file_path != path:
            if _log_file is not None:
                try:
                    _log_file.close()
                except OSError:
                    pass
                _log_file = None
            d = os.path.dirname(path)
            try:
                if d:
                    os.makedirs(d, exist_ok=True)
                _log_file = open(path, "a")
                _log_file_path = path
            except OSError:
                return
        try:
            _log_file.write(line)
            _log_file.flush()
        except (OSError, ValueError):
            pass


def emit_span(rec: dict) -> None:
    """Stream one finished span record to the per-process log."""
    _write_line(rec)


def _registry():
    from . import metrics

    return metrics.registry()


def note_span(dur_us: float, depth: int) -> None:
    """Stage-summary accounting for one finished span (registry-direct;
    metrics.reset() scopes it per bench stage)."""
    reg = _registry()
    reg.counter("trace.spans").inc()
    reg.histogram("trace.span_us").record(dur_us)
    reg.gauge("trace.max_depth").set_max(depth)


def note_trace() -> None:
    _registry().counter("trace.traces").inc()


def note_unsampled() -> None:
    _registry().counter("trace.unsampled").inc()


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of the last N completed query traces. ``record``
    decides the auto-flush: non-ok status (shed / failed / cancelled /
    expired / error) always flushes; an ok trace flushes when it ran
    longer than ``SRJTORCH_SLOW_QUERY_SEC`` (unset: never). Flushing
    appends the FULL trace record — span tree + metrics delta — to the
    span log, so a storm's evidence is on disk even if the process
    dies before anyone calls explain_last()."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = knobs.get_int("SRJTORCH_TRACE_RING")
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._recorded = 0
        self._flushed = 0

    def record(self, rec: dict) -> None:
        slow_s = knobs.get_float("SRJTORCH_SLOW_QUERY_SEC")
        flush = rec.get("status") != "ok" or (
            slow_s is not None and rec.get("duration_s", 0.0) > slow_s
        )
        if flush:
            rec = dict(rec)
            rec["flushed"] = True
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1
            if flush:
                self._flushed += 1
        reg = _registry()
        if flush:
            reg.counter("trace.flushed").inc()
            _write_line(rec)

    def last(self, n: int = 1) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        return items[-n:]

    def worst(self) -> Optional[dict]:
        """The worst recent query: failures outrank successes, then
        duration decides — the trace explain_last() renders."""
        with self._lock:
            items = list(self._ring)
        if not items:
            return None
        return max(
            items,
            key=lambda r: (
                0 if r.get("status") == "ok" else 1,
                r.get("duration_s", 0.0),
            ),
        )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ring": len(self._ring),
                "capacity": self._ring.maxlen,
                "recorded": self._recorded,
                "flushed": self._flushed,
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record_trace(rec: dict) -> None:
    recorder().record(rec)


def reset_for_tests() -> None:
    """Fresh recorder + closed log handle (tests only)."""
    global _recorder
    with _recorder_lock:
        _recorder = None
    close_log()


# ---------------------------------------------------------------------------
# rendering (runtime.explain_last)
# ---------------------------------------------------------------------------


def _fmt_span(s: dict) -> str:
    dur = s.get("dur_us", 0.0)
    dur_txt = f"{dur / 1e3:.2f}ms" if dur < 1e6 else f"{dur / 1e6:.3f}s"
    ann = s.get("annotations") or {}
    ann_txt = "".join(f" {k}={v}" for k, v in sorted(ann.items()))
    status = s.get("status", "ok")
    status_txt = "" if status == "ok" else f" [{status}]"
    return f"{s.get('name')} {dur_txt}{status_txt} (pid {s.get('pid')}){ann_txt}"


def render_trace(rec: dict) -> str:
    """An annotated span tree for one recorded trace: the
    ``explain_last`` rendering. Spans are nested by parent id and
    ordered by start time; spans whose parent is missing from the
    record (in-memory cap overflow, cross-process children) are listed
    under an ``(unparented)`` marker rather than dropped."""
    spans = list(rec.get("spans") or [])
    by_id = {s["span"]: s for s in spans}
    children: dict = {}
    roots: List[dict] = []
    orphans: List[dict] = []
    for s in spans:
        p = s.get("parent")
        if p is None:
            roots.append(s)
        elif p in by_id:
            children.setdefault(p, []).append(s)
        else:
            orphans.append(s)
    lines = [
        f"trace {rec.get('trace')} {rec.get('name')} "
        f"status={rec.get('status')} {rec.get('duration_s', 0.0):.3f}s"
        + ("  [flushed]" if rec.get("flushed") else "")
    ]
    delta = rec.get("metrics_delta") or {}
    if delta:
        top = sorted(delta.items(), key=lambda kv: -abs(kv[1]))[:8]
        lines.append(
            "  metrics-delta: "
            + ", ".join(f"{k}+{v}" for k, v in top)
        )
    if rec.get("dropped_spans"):
        lines.append(f"  ({rec['dropped_spans']} spans dropped at the "
                     "in-memory cap; the span log has them all)")

    def walk(s: dict, indent: int) -> None:
        lines.append("  " * indent + "- " + _fmt_span(s))
        for c in sorted(children.get(s["span"], ()),
                        key=lambda x: x.get("ts", 0.0)):
            walk(c, indent + 1)

    for r in sorted(roots, key=lambda x: x.get("ts", 0.0)):
        walk(r, 1)
    if orphans:
        lines.append("  (unparented)")
        for s in sorted(orphans, key=lambda x: x.get("ts", 0.0)):
            walk(s, 2)
    return "\n".join(lines)


def explain_last() -> Optional[str]:
    """Render the WORST recent query (failures first, then duration)
    from the flight-recorder ring, or None when nothing was traced.
    This is the local-process view; the cross-process tree lives in the
    span logs (``analysis.tracemerge`` joins them)."""
    rec = recorder().worst()
    return None if rec is None else render_trace(rec)


# ---------------------------------------------------------------------------
# stage summary / stats sections
# ---------------------------------------------------------------------------


def stage_summary() -> dict:
    """The per-stage trace summary bench harnesses emit next to their
    ``{"metrics": ...}`` lines: span count, trace count, max tree
    depth, and the p99 span duration — enough to correlate a latency
    regression with the span that grew."""
    from . import metrics

    reg = _registry()
    h = reg.peek("trace.span_us")
    p99 = h.quantile(0.99) if isinstance(h, metrics.Histogram) else None
    return {
        "spans": reg.value("trace.spans"),
        "traces": reg.value("trace.traces"),
        "flushed": reg.value("trace.flushed"),
        "max_depth": reg.value("trace.max_depth"),
        "p99_span_us": None if p99 is None else round(p99, 1),
    }


def stats_section() -> dict:
    """The ``trace`` section of runtime.stats_report(): registry
    counters plus the flight recorder's ring state (None-safe before
    anything was traced — a stats poll never mints the recorder)."""
    out = dict(stage_summary())
    out["unsampled"] = _registry().value("trace.unsampled")
    out["log"] = resolved_log_path()
    with _recorder_lock:
        rec = _recorder
    out["recorder"] = None if rec is None else rec.snapshot()
    return out
