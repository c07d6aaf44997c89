"""Runtime metrics: counters, gauges, log2 histograms and a JSON-lines
event log (port of the JAX package's ``utils/metrics.py``).

- **Always-on registry, gated instrumentation.** ``registry()`` is
  always live: durable product counters (memory split-retries, the
  integrity tallies, the tier notes) write through it unconditionally.
  The hot-path instrumentation (per-op wall time in ``op_boundary``, the
  exchange's timings, the event log) is gated by
  ``SRJTORCH_METRICS_ENABLED`` / ``enable()``: disarmed, ``counter()`` /
  ``histogram()`` / ``timer()`` hand back no-op stubs and never touch a
  clock, so an instrumented hot path costs one boolean read.
- **Fixed log2 bucketing.** ``Histogram`` keeps 64 power-of-two buckets
  in a preallocated list: recording is index arithmetic plus one locked
  increment.
- **Structured event log.** ``SRJTORCH_METRICS_LOG=<path>`` (or
  ``set_log_path()``) appends one ``{"ts": ..., "event": ..., **fields}``
  object per line, only while metrics are armed; one ``write()`` a line
  keeps lines whole across processes sharing the file.

The reference's registry map is tracked by its lock-order and race
instrumentation when that is armed; the port has no such instrumentation
yet, and its registry map is a plain dict.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Optional

from . import knobs

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "KeyedEwma",
    "adaptive_timeout_s",
    "Registry",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "timer",
    "event",
    "record_op",
    "snapshot",
    "counters_snapshot",
    "fold_worker_counters",
    "reset",
    "enable",
    "disable",
    "is_enabled",
    "enabled",
    "disabled",
    "set_log_path",
    "log_path",
    "close_log",
    "render_report",
    "stage_report",
]

_N_BUCKETS = 64  # log2 buckets cover [1, 2^63); values clamp at the ends


class Counter:
    """Monotonic counter (thread-safe; a GIL-era ``+=`` is not atomic
    across the read/add/store bytecodes, so increments lock)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value  # srjt-race: allow-unguarded(single machine-word stats read; GIL-atomic — a reader sees a valid pre- or post-increment value, never a tear)

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value  # GIL-atomic word read


class Gauge:
    """Last-write-wins scalar (remote snapshots, pool sizes, ...)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def set_max(self, v) -> None:
        """Monotonic high-water update: compare-and-set under the
        gauge's own lock, so two concurrent observers can never let a
        smaller value overwrite a larger one (the trace.max_depth
        contract — an unlocked read-then-set is exactly the
        check-then-act the race tier polices)."""
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        return self._value  # srjt-race: allow-unguarded(last-write-wins scalar; a reference read is GIL-atomic and any concurrent set is a valid value)

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value  # GIL-atomic word read


class Histogram:
    """Fixed log2-bucket histogram: bucket k counts values in
    [2^(k-1), 2^k) (bucket 0 holds values < 1, i.e. zero/negative
    after int truncation). Preallocated — recording is allocation-free
    modulo interpreter internals, safe on hot paths."""

    __slots__ = ("_lock", "_buckets", "_count", "_sum", "_min", "_max")

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets = [0] * _N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    @staticmethod
    def bucket_index(value) -> int:
        iv = int(value)
        if iv <= 0:
            return 0
        b = iv.bit_length()  # 1 -> bucket 1 ([1,2)), 2..3 -> 2, 4..7 -> 3
        return b if b < _N_BUCKETS else _N_BUCKETS - 1

    def record(self, value) -> None:
        idx = self.bucket_index(value)
        with self._lock:
            self._buckets[idx] += 1
            self._count += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count  # srjt-race: allow-unguarded(single machine-word warm-up check; GIL-atomic, and quantile() re-reads under _lock)

    def quantile(self, q: float):
        """Approximate quantile read off the log2 buckets:
        the rank's bucket is found by cumulative count, then linearly
        interpolated across the bucket's [2^(k-1), 2^k) span and
        tightened by the recorded min/max. None when empty. Good to a
        factor of 2 by construction — exactly the precision an
        adaptive timeout or a hedge trigger needs, at zero extra
        hot-path cost (the recording side is unchanged)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self._count
            if total == 0:
                return None
            lo, hi = self._min, self._max
            rank = q * total
            if rank <= 1:
                return lo
            cum = 0
            for k, n in enumerate(self._buckets):
                if not n:
                    continue
                if cum + n >= rank:
                    if k == 0:
                        return min(max(0.0, lo), hi)
                    lower, upper = float(1 << (k - 1)), float(1 << k)
                    frac = (rank - cum) / n
                    est = lower + frac * (upper - lower)
                    return min(max(est, lo), hi)
                cum += n
            return hi

    def _reset(self) -> None:
        with self._lock:
            self._buckets = [0] * _N_BUCKETS
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def _snapshot(self) -> dict:
        with self._lock:
            buckets = {
                # bucket k spans [2^(k-1), 2^k); label by the inclusive
                # lower edge so readers can reconstruct the range
                ("0" if k == 0 else str(1 << (k - 1))): n
                for k, n in enumerate(self._buckets)
                if n
            }
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "buckets": buckets,
            }


class _NullMetric:
    """Shared no-op stub handed out when metrics are disabled: every
    mutator is a pass, so instrumented call sites stay branch-free."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def set_max(self, v) -> None:
        pass

    def record(self, value) -> None:
        pass

    @property
    def value(self):
        return 0

    @property
    def count(self):
        return 0

    def quantile(self, q: float):
        return None


_NULL = _NullMetric()


class KeyedEwma:
    """Bounded-memory per-key EWMA + jitter tracker: the
    health scorer's streaming state. Each key carries an exponentially
    weighted moving average of its samples plus an EWMA of the absolute
    deviation (the jitter — a worker whose heartbeat round-trips wander
    is as suspect as one whose mean drifts). The map is BOUNDED:
    at ``max_keys`` the least-recently-updated key is evicted, so a
    per-(worker, op) keying can never grow with workload cardinality."""

    __slots__ = ("_lock", "_alpha", "_max_keys", "_entries", "_seq")

    def __init__(self, alpha: float = 0.3, max_keys: int = 512):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if max_keys < 1:
            raise ValueError(f"max_keys must be >= 1, got {max_keys}")
        self._lock = threading.Lock()
        self._alpha = float(alpha)
        self._max_keys = int(max_keys)
        self._entries: Dict[str, list] = {}  # key -> [ewma, jitter, count, seq]
        self._seq = 0

    def update(self, key: str, value: float) -> float:
        """Fold one sample into ``key``'s EWMA; returns the new mean."""
        v = float(value)
        with self._lock:
            self._seq += 1
            e = self._entries.get(key)
            if e is None:
                if len(self._entries) >= self._max_keys:
                    oldest = min(self._entries, key=lambda k: self._entries[k][3])
                    del self._entries[oldest]
                self._entries[key] = [v, 0.0, 1, self._seq]
                return v
            dev = abs(v - e[0])
            e[0] += self._alpha * (v - e[0])
            e[1] += self._alpha * (dev - e[1])
            e[2] += 1
            e[3] = self._seq
            return e[0]

    def get(self, key: str, default=None):
        with self._lock:
            e = self._entries.get(key)
            return default if e is None else e[0]

    def jitter(self, key: str, default=None):
        with self._lock:
            e = self._entries.get(key)
            return default if e is None else e[1]

    def count(self, key: str) -> int:
        with self._lock:
            e = self._entries.get(key)
            return 0 if e is None else e[2]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                k: {"ewma": e[0], "jitter": e[1], "count": e[2]}
                for k, e in self._entries.items()
            }


class Registry:
    """Name -> metric map. get-or-create under one lock; the returned
    metric objects are internally locked, so holders increment without
    re-entering the registry."""

    def __init__(self):
        self._lock = threading.Lock()
        # srjt-race layer 2: the registry map is tracked when
        # SRJTORCH_RACE=1 — every metric lookup/registration is a checked
        # access (a plain dict otherwise; analysis/lockdep is
        # import-light, safe this early in the import order)
        from ..analysis.lockdep import track as _race_track

        self._metrics: Dict[str, object] = _race_track(
            {}, "metrics.registry"
        )

    def _get(self, name: str, cls):
        # the whole get-or-create runs under the lock; hot call sites
        # cache their metric handles (record_op)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls()
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"not {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def peek(self, name: str):
        """The live metric object for ``name``, or None — WITHOUT
        creating it (stats assembly and the adaptive-timeout reader
        must never mint histograms as a side effect). The map read is
        locked; the returned object carries its own lock."""
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default=0):
        """Scalar read with a default — snapshot assembly for counters
        that may never have been touched."""
        m = self.peek(name)
        if m is None:
            return default
        if isinstance(m, Histogram):
            return m._snapshot()
        return m.value

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} —
        plain JSON-serializable values only."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m._snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m._snapshot()
            else:
                out["histograms"][name] = m._snapshot()
        return out

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m._reset()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide registry. ALWAYS live: durable product counters
    (memory split-retries, worker-side op counts) go through here
    directly, independent of the SRJTORCH_METRICS_ENABLED gate — the gate
    governs hot-path instrumentation, not bookkeeping."""
    return _REGISTRY


# ---------------------------------------------------------------------------
# enable gate + gated convenience accessors
# ---------------------------------------------------------------------------

_enabled = knobs.get_bool("SRJTORCH_METRICS_ENABLED")


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enabled(log_path: Optional[str] = None):
    """Scoped arming for tests/benches; optionally installs a scoped
    event-log path."""
    global _enabled
    prev = _enabled
    prev_path = log_path_holder = None
    if log_path is not None:
        prev_path = _log_path
        set_log_path(log_path)
        log_path_holder = log_path
    _enabled = True
    try:
        yield _REGISTRY
    finally:
        _enabled = prev
        if log_path_holder is not None:
            set_log_path(prev_path)


@contextlib.contextmanager
def disabled():
    """Scoped disarming (the overhead-guard test's tool)."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def counter(name: str):
    """Gated accessor: the real counter when armed, a no-op stub when
    not — instrumented hot paths pay one boolean read disabled."""
    return _REGISTRY.counter(name) if _enabled else _NULL


def gauge(name: str):
    return _REGISTRY.gauge(name) if _enabled else _NULL


def histogram(name: str):
    return _REGISTRY.histogram(name) if _enabled else _NULL


# per-op handle cache: op_boundary resolves (calls counter, wall-us
# histogram) once per op name instead of two dict lookups per dispatch
_op_handles: Dict[str, tuple] = {}
_op_handles_lock = threading.Lock()


def record_op(name: str, seconds: float) -> None:
    """One op dispatch: count + wall-clock histogram (microseconds).
    Callers gate on is_enabled() BEFORE reading the clock."""
    h = _op_handles.get(name)
    if h is None:
        with _op_handles_lock:
            h = _op_handles.get(name)
            if h is None:
                h = (
                    _REGISTRY.counter(f"op.{name}.calls"),
                    _REGISTRY.histogram(f"op.{name}.wall_us"),
                )
                _op_handles[name] = h
    h[0].inc()
    h[1].record(seconds * 1e6)


@contextlib.contextmanager
def timer(name: str):
    """Time a region into the op metrics namespace (``op.<name>.calls``
    + ``op.<name>.wall_us``). No clock read when disabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_op(name, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# structured JSON-lines event log
# ---------------------------------------------------------------------------

_log_lock = threading.Lock()
_log_path: Optional[str] = knobs.get_str("SRJTORCH_METRICS_LOG") or None
_log_file = None


def log_path() -> Optional[str]:
    return _log_path


def set_log_path(path: Optional[str]) -> None:
    """Install (or clear, with None) the event-log destination. The
    file opens lazily on first event and appends — multiple processes
    (sidecar worker + client) may share one path."""
    global _log_path, _log_file
    with _log_lock:
        if _log_file is not None:
            try:
                _log_file.close()
            finally:
                _log_file = None
        _log_path = path


def close_log() -> None:
    set_log_path(_log_path)  # closes the handle, keeps the path


def event(name: str, **fields) -> None:
    """Append one structured event line. Cheap no-op unless metrics are
    enabled AND a log path is configured. One write() per line keeps
    lines atomic under O_APPEND across processes."""
    global _log_file
    if not _enabled or _log_path is None:
        return
    rec = {"ts": round(time.time(), 6), "event": name}
    rec.update(fields)
    line = json.dumps(rec, default=str) + "\n"
    with _log_lock:
        # re-check under the lock: a concurrent set_log_path(None)
        # between the fast-path guard above and here must not turn
        # into open(None) — a bad/ripped-out path degrades the log,
        # never the op being instrumented
        if _log_path is None:
            return
        if _log_file is None:
            try:
                _log_file = open(_log_path, "a")
            except OSError:
                return
        try:
            _log_file.write(line)
            _log_file.flush()
        except (OSError, ValueError):
            pass


# ---------------------------------------------------------------------------
# snapshots + reporting
# ---------------------------------------------------------------------------


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def counters_snapshot() -> Dict[str, int]:
    """COUNTERS only, as one flat name -> value dict — the cheap
    before/after pair the flight recorder diffs into a per-query
    metrics delta. Skips gauges and histograms: a delta of
    last-write-wins or bucketed state is not meaningful, and walking
    just the counters keeps the per-root-trace cost to one locked list
    copy plus word reads."""
    with _REGISTRY._lock:
        items = list(_REGISTRY._metrics.items())
    return {name: m.value for name, m in items if isinstance(m, Counter)}


def adaptive_timeout_s(hist_name: str, static_s: float):
    """Derive an ADAPTIVE socket deadline from an observed latency
    histogram recorded in MICROSECONDS: returns
    ``(budget_s, clamped)`` where ``budget_s`` is
    ``clamp(q99 × SRJTORCH_ADAPTIVE_TIMEOUT_MULT,
    [SRJTORCH_ADAPTIVE_TIMEOUT_FLOOR_S, static_s])`` once the histogram
    holds at least ``SRJTORCH_ADAPTIVE_TIMEOUT_MIN_SAMPLES`` samples, and
    the static knob unchanged before that (cold-start ops — first
    compile, first dial — keep the conservative deadline). ``clamped``
    is True only when observation actually SHRANK the deadline, so
    callers can count clamps without re-deriving. Reads the registry
    directly (never creates the histogram): adaptive deadlines are
    product behavior and must work with SRJTORCH_METRICS_ENABLED off."""
    if not knobs.get_bool("SRJTORCH_ADAPTIVE_TIMEOUT_ENABLED"):
        return static_s, False
    h = _REGISTRY.peek(hist_name)
    if not isinstance(h, Histogram):
        return static_s, False
    if h.count < knobs.get_int("SRJTORCH_ADAPTIVE_TIMEOUT_MIN_SAMPLES"):
        return static_s, False
    q99_us = h.quantile(0.99)
    if q99_us is None:
        return static_s, False
    budget = q99_us / 1e6 * knobs.get_float("SRJTORCH_ADAPTIVE_TIMEOUT_MULT")
    budget = max(budget, knobs.get_float("SRJTORCH_ADAPTIVE_TIMEOUT_FLOOR_S"))
    budget = min(budget, float(static_s))
    return budget, budget < float(static_s)


def fold_worker_counters(counters: Optional[dict], prefix: str = "sidecar.worker.") -> None:
    """Fold a sidecar WORKER's counter snapshot (the STATS verb's
    ``snapshot.counters`` map) into this process's registry under
    ``prefix`` — as GAUGES, because a remote snapshot is
    last-write-wins and folding increments would double-count on every
    poll."""
    for name, value in (counters or {}).items():
        _REGISTRY.gauge(
            name if name.startswith(prefix) else f"{prefix}{name}"
        ).set(value)


def reset() -> None:
    """Zero every metric (registered names survive; tests and bench
    stage boundaries use this)."""
    _REGISTRY.reset()


def stage_report(stage: str) -> dict:
    """Per-stage snapshot shape for bench emission: op timings, shuffle
    movement, and retry counts, with zero defaults so the schema is
    stable even when a stage never touched a section. The sections of
    subsystems the port does not have yet (memgov, sidecar pool, serve,
    cache, journal) keep the reference's schema and read 0."""
    from . import memory, retry

    snap = _REGISTRY.snapshot()
    ops = {}
    for name, h in snap["histograms"].items():
        if name.startswith("op.") and name.endswith(".wall_us") and h["count"]:
            op = name[len("op."):-len(".wall_us")]
            ops[op] = {
                "calls": h["count"],
                "wall_us_sum": round(h["sum"], 1),
                "wall_us_max": round(h["max"], 1) if h["max"] is not None else None,
            }
    rs = retry.stats()
    return {
        "stage": stage,
        "ops": ops,
        "shuffle": {
            "exchanges": _REGISTRY.value("shuffle.exchanges"),
            "bytes_exchanged": _REGISTRY.value("shuffle.bytes_exchanged"),
            "capacity_retries": _REGISTRY.value("shuffle.capacity_retries"),
        },
        "retry": rs,
        "memory": {"split_retries": memory.split_retry_count()},
        # memory-governor counters: admissions vs queue/reject
        # pressure, and the spill volume the squeeze artifacts audit
        "memgov": {
            "admitted": _REGISTRY.value("memgov.admitted"),
            "queued": _REGISTRY.value("memgov.queued"),
            "rejected": _REGISTRY.value("memgov.rejected"),
            "spilled_bytes": _REGISTRY.value("memgov.spilled_bytes"),
            "respilled": _REGISTRY.value("memgov.respilled"),
        },
        # robustness counters: budget give-ups vs truncated
        # backoffs, and the sidecar breaker's registry-direct gauges
        "deadline": {
            "deadline_exceeded": rs["deadline_exceeded"],
            "backoff_truncated": rs["backoff_truncated"],
        },
        "breaker": {
            "state": _REGISTRY.value("sidecar.breaker.state"),
            "opened": _REGISTRY.value("sidecar.breaker.opened_total"),
            "fast_fails": _REGISTRY.value("sidecar.breaker.fast_fails_total"),
        },
        # crash-tolerance counters: pool failovers/respawns and
        # the integrity layer's caught-corruption tally — the crash-storm
        # artifacts assert on exactly these
        "pool": {
            "live": _REGISTRY.value("sidecar.pool.live"),
            "failovers": _REGISTRY.value("sidecar.pool.failovers"),
            "respawns": _REGISTRY.value("sidecar.pool.respawns"),
            "rehydrations": _REGISTRY.value("sidecar.pool.rehydrations"),
        },
        "integrity": {
            "crc_mismatch": _REGISTRY.value("sidecar.integrity.crc_mismatch"),
            "frames_checked": _REGISTRY.value("sidecar.integrity.frames_checked"),
        },
        # tail-tolerance counters: gray-failure quarantine
        # verdicts and hedged-dispatch accounting — the gray-storm
        # artifacts assert quarantines/hedges_won > 0 from exactly these
        "health": {
            "quarantines": _REGISTRY.value("sidecar.pool.quarantines"),
            "reinstatements": _REGISTRY.value("sidecar.pool.reinstatements"),
            "probes": _REGISTRY.value("sidecar.pool.quarantine_probes"),
            "quarantined_now": _REGISTRY.value("sidecar.pool.quarantined"),
        },
        "hedge": {
            "launched": _REGISTRY.value("sidecar.pool.hedges_launched"),
            "won": _REGISTRY.value("sidecar.pool.hedges_won"),
            "cancelled": _REGISTRY.value("sidecar.pool.hedges_cancelled"),
            "suppressed": _REGISTRY.value("sidecar.pool.hedges_suppressed"),
            "adaptive_timeout_clamps": (
                _REGISTRY.value("sidecar.adaptive_timeout_clamps")
                + _REGISTRY.value("shuffle.tcp.adaptive_timeout_clamps")
            ),
        },
        # tracing counters: per-stage span volume — bench
        # harnesses pair this with the dedicated {"trace": ...} summary
        # line (trace_sink.stage_summary) so a BENCH latency regression
        # can be correlated with the span that grew
        "trace": {
            "spans": _REGISTRY.value("trace.spans"),
            "traces": _REGISTRY.value("trace.traces"),
            "flushed": _REGISTRY.value("trace.flushed"),
        },
        # serving counters: admission outcomes under load — the
        # chaos-under-load artifacts assert sheds surfaced as Overloaded
        # (serve.shed_total) and never as silent buffering or timeouts
        "serve": {
            "submitted": _REGISTRY.value("serve.submitted"),
            "completed": _REGISTRY.value("serve.completed"),
            "shed_total": _REGISTRY.value("serve.shed_total"),
            "expired_in_queue": _REGISTRY.value("serve.expired_in_queue"),
        },
        # caching counters: plan-cache hit economics, stage
        # (subresult) reuse, and in-flight sharing — the cache-tier
        # artifacts gate warm hit rate and share>0 from exactly these
        "cache": {
            "hits": _REGISTRY.value("cache.hits"),
            "misses": _REGISTRY.value("cache.misses"),
            "rebinds": _REGISTRY.value("cache.rebinds"),
            "share": _REGISTRY.value("cache.share"),
            "sub_hits": _REGISTRY.value("cache.sub_hits"),
            "sub_misses": _REGISTRY.value("cache.sub_misses"),
            "evictions": (_REGISTRY.value("cache.evictions")
                          + _REGISTRY.value("cache.sub_evictions")),
            "evict_injected": _REGISTRY.value("cache.evict_injected"),
        },
        # durability counters: journal append/replay volume,
        # manifest re-attach, and orphan reclamation — the restart-tier
        # artifacts assert replays/reattached/resumes > 0 from exactly
        # these
        "durability": {
            "journal_appends": _REGISTRY.value("journal.appends"),
            "journal_append_failures": _REGISTRY.value(
                "journal.append_failures"),
            "journal_replays": _REGISTRY.value("journal.replays"),
            "journal_replayed_records": _REGISTRY.value(
                "journal.replayed_records"),
            "journal_truncated_records": _REGISTRY.value(
                "journal.truncated_records"),
            "idempotent_hits": _REGISTRY.value("journal.idempotent_hits"),
            "recovered_resubmits": _REGISTRY.value(
                "journal.recovered_resubmits"),
            "manifests_written": _REGISTRY.value("memgov.manifests_written"),
            "reattached": _REGISTRY.value("memgov.reattached"),
            "orphans_reclaimed": _REGISTRY.value("memgov.orphans_reclaimed"),
            "partition_resumes": _REGISTRY.value("ooc.partition_resumes"),
        },
    }


def render_report(report: dict) -> str:
    """Human renderer for runtime.stats_report(): one aligned line per
    scalar, histograms as count/sum/max."""
    lines = []

    def emit(prefix: str, obj):
        if isinstance(obj, dict):
            if set(obj) >= {"count", "sum", "buckets"}:  # histogram leaf
                mx = obj.get("max")
                lines.append(
                    f"{prefix:<52} n={obj['count']} sum={obj['sum']:.1f}"
                    + (f" max={mx:.1f}" if isinstance(mx, (int, float)) else "")
                )
                return
            for k in sorted(obj):
                emit(f"{prefix}.{k}" if prefix else str(k), obj[k])
        else:
            lines.append(f"{prefix:<52} {obj}")

    emit("", report)
    return "\n".join(lines)
