"""Deterministic fault injection at the op-dispatch boundary (port of
the JAX package's ``utils/faultinj.py``, itself the counterpart of the
reference's CUPTI injector, ``faultinj.cu``): faults fire inside
``op_boundary`` (``utils/dispatch.py``), the choke point every public op
crosses.

- JSON config: ``SRJTORCH_FAULTINJ_CONFIG`` (a path, hot-reloaded when
  its mtime changes) or ``configure()``.
- Rule keys: an exact op name, a ``"prefix.*"`` family (longest prefix
  wins) or the ``"*"`` wildcard; any key may carry an ``@<tag>`` suffix
  that matches only in a process whose ``SRJTORCH_FAULTINJ_WORKER`` or
  ``SRJTORCH_FAULTINJ_RANK`` tag equals ``<tag>``. Resolution, most
  specific first: ``op@tag`` > ``op`` > longest ``prefix.*@tag`` >
  longest ``prefix.*`` > ``*@tag`` > ``*``.
- Kinds: ``fatal`` (FatalDeviceError), ``retryable`` (RetryableError),
  ``exception`` (plain RuntimeError), ``delay`` (sleeps ``delayMs``),
  ``hang`` (sleeps ``delayMs``, default 30 s, polling the context-local
  deadline and cancel token and raising DeadlineExceeded the moment the
  budget dies), ``spill_fail`` (a RetryableError for a spill choke
  point), ``crash`` (the process SIGKILLs itself), ``reject`` (the
  retryable ``Overloaded``; ``delayMs`` is its ``retry_after_s`` hint in
  ms), ``netsplit`` (ConnectionRefusedError), ``cache_evict``
  (``CacheEvictInjected``), and the producer-side kinds ``corrupt``
  (``maybe_corrupt`` flips up to 8 bytes at a seeded offset) and
  ``torn_write`` (``maybe_torn`` keeps a prefix of ``delayMs`` bytes, or
  half).
- Scheduling: ``percent`` probability, an ``interceptionCount`` budget,
  ``after`` (skip the first N matching dispatches) and ``ramp`` (scale
  the percent in linearly over the first ``ramp`` armed dispatches).
- Deterministic: one ``random.Random(seed)`` draws every decision, and
  only armed dispatches draw, so a seeded storm replays bit for bit.

Config schema::

    {
      "seed": 12345,
      "faults": {
        "convert_to_rows": {"type": "retryable", "percent": 50,
                             "interceptionCount": 2},
        "all_to_all_exchange": {"type": "delay", "percent": 30,
                                 "delayMs": 5, "after": 2, "ramp": 4},
        "multiply128": {"type": "hang", "percent": 100, "delayMs": 2000},
        "*": {"type": "fatal", "percent": 1}
      }
    }
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Dict, Optional

from .errors import FatalDeviceError, Overloaded, RetryableError

__all__ = [
    "configure",
    "configure_from_file",
    "disable",
    "maybe_inject",
    "maybe_corrupt",
    "maybe_torn",
    "is_enabled",
    "CacheEvictInjected",
]


class CacheEvictInjected(RuntimeError):
    """The ``cache_evict`` chaos payload: raised out of
    ``maybe_inject("cache.<layer>.<key>")`` at a cache's lookup choke
    point, which catches it, drops the entry and proceeds as a miss."""


class _Rule:
    __slots__ = ("kind", "percent", "budget", "delay_ms", "after", "ramp", "calls")

    def __init__(
        self,
        kind: str,
        percent: float,
        budget: Optional[int],
        delay_ms: float = 0.0,
        after: int = 0,
        ramp: int = 0,
    ):
        self.kind = kind
        self.percent = percent
        self.budget = budget  # None == unlimited
        self.delay_ms = delay_ms  # kind == "delay" only
        self.after = after  # matching dispatches to skip before arming
        self.ramp = ramp  # armed dispatches over which percent scales in
        self.calls = 0  # matching dispatches seen (scheduling state)


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.rules: Dict[str, _Rule] = {}
        self.rng = random.Random()
        self.path: Optional[str] = None
        self.mtime: float = 0.0
        self.enabled = False
        self.worker_tag: Optional[str] = None  # SRJTORCH_FAULTINJ_WORKER
        self.rank_tag: Optional[str] = None  # SRJTORCH_FAULTINJ_RANK


_state = _State()


def _parse(cfg: dict) -> None:
    # the process's worker tag is latched per configure (the spawned
    # worker reads its env-stamped slot name once, with the profile)
    from . import knobs as _k

    _state.worker_tag = _k.get_str("SRJTORCH_FAULTINJ_WORKER") or None
    _state.rank_tag = _k.get_str("SRJTORCH_FAULTINJ_RANK") or None
    _state.rules = {}
    for name, spec in (cfg.get("faults") or {}).items():
        kind = spec.get("type", "retryable")
        if kind not in ("fatal", "retryable", "exception", "delay", "hang",
                        "spill_fail", "crash", "corrupt", "reject",
                        "netsplit", "cache_evict", "torn_write"):
            raise ValueError(f"faultinj: unknown fault type {kind!r}")
        percent = float(spec.get("percent", 100))
        budget = spec.get("interceptionCount")
        # a hang exists to outlive deadlines: its default sleep is 30 s,
        # not the delay kind's 50 ms latency blip
        delay_ms = float(spec.get("delayMs", 30000.0 if kind == "hang" else 50))
        after = int(spec.get("after", 0))
        ramp = int(spec.get("ramp", 0))
        if delay_ms < 0 or after < 0 or ramp < 0:
            raise ValueError("faultinj: delayMs/after/ramp must be non-negative")
        _state.rules[name] = _Rule(
            kind, percent, None if budget is None else int(budget), delay_ms, after, ramp
        )
    _state.rng = random.Random(cfg.get("seed"))


def configure(cfg: dict) -> None:
    """Install a config programmatically (tests / in-process chaos)."""
    with _state.lock:
        _state.path = None
        _parse(cfg)
        _state.enabled = bool(_state.rules)


def configure_from_file(path: str) -> None:
    with _state.lock:
        with open(path) as f:
            _parse(json.load(f))
        _state.path = path
        _state.mtime = os.stat(path).st_mtime
        # file-backed configs stay active even when currently empty, so
        # the hot-reload poll keeps running (inotify-thread analog)
        _state.enabled = True


def disable() -> None:
    with _state.lock:
        _state.rules = {}
        _state.enabled = False
        _state.path = None


def is_enabled() -> bool:
    return _state.enabled


def _reload_if_changed() -> None:
    if _state.path is None:
        return
    try:
        m = os.stat(_state.path).st_mtime
    except OSError:
        return
    if m != _state.mtime:
        with open(_state.path) as f:
            _parse(json.load(f))
        _state.mtime = m


def _resolve_rule_locked(op_name: str) -> Optional[_Rule]:
    """Rule resolution, most-specific first: exact with one
    of this process's tags (``op@w1``, ``op@r2``) > plain exact >
    longest tag-suffixed prefix family (``prefix.*@w1``) > longest
    plain prefix family > tagged wildcard (``*@w1``) > bare ``*``.
    A process may carry BOTH a worker tag (SRJTORCH_FAULTINJ_WORKER) and a
    rank tag (SRJTORCH_FAULTINJ_RANK) — each specificity level
    tries the worker tag first, then the rank tag. Keys carrying a
    FOREIGN tag never match, so one profile can ramp a single gray
    worker — or partition a single exchange rank — while its peers
    run the same config clean."""
    tags = [t for t in (_state.worker_tag, _state.rank_tag) if t]
    for tag in tags:
        rule = _state.rules.get(f"{op_name}@{tag}")
        if rule is not None:
            return rule
    rule = _state.rules.get(op_name)
    if rule is not None:
        return rule
    for suffix in [f"@{t}" for t in tags] + [""]:
        best, best_len = None, -1
        for key, r in _state.rules.items():
            if suffix and not key.endswith(suffix):
                continue
            stem = key[: len(key) - len(suffix)] if suffix else key
            if "@" in stem:
                continue  # a foreign (or any) tag on the plain pass
            if (
                stem.endswith(".*")
                and op_name.startswith(stem[:-1])
                and len(stem) > best_len
            ):
                best, best_len = r, len(stem)
        if best is not None:
            return best
    for tag in tags:
        rule = _state.rules.get(f"*@{tag}")
        if rule is not None:
            return rule
    return _state.rules.get("*")


# rule families: each producer-side hook services only its own kinds,
# so a ``corrupt`` (or ``torn_write``) rule never burns scheduling
# state or budget on a ``maybe_inject`` dispatch — its choke point is
# the payload producer — and vice versa
_PRODUCER_FAMILIES = {"corrupt": "corrupt", "torn_write": "torn_write"}


def _draw_locked(op_name: str, family: str):
    """Locked half of fault arming shared by ``maybe_inject``,
    ``maybe_corrupt``, and ``maybe_torn``: resolve the rule, run the
    `after`/`ramp`/budget scheduling, draw the RNG, and return
    (kind, delay_ms) when the rule fires, else None. ``family`` selects
    which rule family this call site services ("inject", "corrupt", or
    "torn_write")."""
    _reload_if_changed()
    rule = _resolve_rule_locked(op_name)
    if rule is None:
        return None
    if _PRODUCER_FAMILIES.get(rule.kind, "inject") != family:
        return None
    if rule.budget is not None and rule.budget <= 0:
        return None
    # scheduling: count every matching dispatch; hold fire for the
    # first `after`, then ramp the effective percent over `ramp`
    # armed dispatches. The RNG draw happens only once armed, so a
    # seeded storm is bit-reproducible regardless of `after`.
    rule.calls += 1
    if rule.calls <= rule.after:
        return None
    percent = rule.percent
    if rule.ramp:
        armed = rule.calls - rule.after
        percent *= min(1.0, armed / rule.ramp)
    if _state.rng.uniform(0, 100) >= percent:
        return None
    if rule.budget is not None:
        rule.budget -= 1
    return rule.kind, rule.delay_ms


def maybe_inject(op_name: str) -> None:
    """Called by op_boundary before dispatch; raises the configured
    fault, sleeps (``delay`` kind), SIGKILLs the process (``crash``
    kind), or returns. Cheap when disabled (one attribute read).
    ``corrupt`` rules are inert here — they fire through
    ``maybe_corrupt`` at the payload producer."""
    if not _state.enabled:
        return
    with _state.lock:
        hit = _draw_locked(op_name, family="inject")
        if hit is None:
            return
        kind, delay_ms = hit
    if kind == "crash":
        # the kill-9 mid-op chaos: the request was consumed,
        # no response will ever be written, the peer sees a dead
        # transport. SIGKILL self — no atexit, no flush, no cleanup —
        # exactly the failure the pool's failover must survive.
        import signal

        os.kill(os.getpid(), signal.SIGKILL)
    if kind == "fatal":
        raise FatalDeviceError(f"injected fatal fault in {op_name}")
    if kind == "retryable":
        raise RetryableError(f"injected retryable fault in {op_name}")
    if kind == "reject":
        # the serving scheduler's admission chaos (serve/ calls
        # maybe_inject("serve.admit") on every submission): the shed
        # path fires deterministically — the scheduler counts it under
        # serve.shed_total like any organic shed, and the client sees
        # the same retryable Overloaded contract as a real storm.
        # delayMs carries the retry_after_s hint (in ms).
        raise Overloaded(
            f"injected admission reject in {op_name}",
            retry_after_s=delay_ms / 1000.0,
            cause="injected",
        )
    if kind == "netsplit":
        # the network-partition chaos: model the kernel
        # refusing the TCP connect to a partitioned peer. Raised as the
        # REAL OSError subclass so the exchange client's existing
        # (ConnectionError, OSError) -> retryable-UNAVAILABLE
        # classification — and everything above it (per-peer breaker,
        # liveness, epoch-fenced recovery) — exercises exactly the
        # production path. Key it exchange.connect@r<N> to partition
        # one rank.
        raise ConnectionRefusedError(
            f"injected netsplit in {op_name}: connection refused"
        )
    if kind == "cache_evict":
        # the cache-eviction chaos: key it
        # ``cache.*`` (or a specific ``cache.plan.<fp>`` /
        # ``cache.sub.<fp>`` op) to force eviction of the entry being
        # looked up, mid-query. The cache layer converts this into
        # drop-and-recompute — never a caller-visible failure.
        raise CacheEvictInjected(f"injected cache eviction in {op_name}")
    if kind == "spill_fail":
        # the memory governor's demotion chaos (memgov/catalog.py calls
        # maybe_inject("memgov.spill") around every spill): same
        # retryable class, distinct message — the catalog catches it,
        # counts memgov.spill_failures, and leaves the entry resident
        raise RetryableError(f"injected spill failure in {op_name}")
    if kind == "delay":
        # latency, not failure: sleeps OUTSIDE the injector lock so a
        # delay storm cannot serialize every other dispatch behind it
        # the injected delay IS the chaos payload; deadline scopes see it
        # as op latency
        time.sleep(delay_ms / 1000.0)  # srjt-lint: allow-blocking(the injected delay IS the chaos payload; deadline scopes observe it as op latency)
        return
    if kind == "hang":
        _hang(op_name, delay_ms)  # outside the lock, like delay
        return
    raise RuntimeError(f"injected exception in {op_name}")


def _hang(op_name: str, delay_ms: float) -> None:
    """``hang`` kind: the wedged-dispatch analog that sleeps far past
    any deadline — but cooperatively. The sleep polls the context-local
    deadline/cancel token (utils/deadline.py) in small slices and
    raises DeadlineExceeded the moment the budget dies or the token
    trips: exactly the interrupt a real wedged kernel lacks and the
    deadline subsystem exists to provide. With no active deadline the
    full hang is slept — a chaos profile pointing ``hang`` at an
    unbudgeted op surfaces as the wall-clock it costs, which is the
    correct loud failure for a mis-armed harness."""
    from . import deadline as deadline_mod

    end = time.monotonic() + delay_ms / 1000.0
    while True:
        d = deadline_mod.current()
        if d is not None and d.done():
            raise d.exceeded(f"hang fault in {op_name}")
        now = time.monotonic()
        if now >= end:
            return
        step = end - now
        if d is not None:
            # wake just past the deadline edge, not a poll interval late
            step = min(step, max(d.remaining(), 0.0) + 0.005)
        time.sleep(min(step, 0.05))


def maybe_corrupt(op_name: str, data: bytes) -> bytes:
    """Chaos hook for payload producers (the sidecar worker crosses it
    on every response, keyed ``sidecar.worker.<OP>``): when a matched
    ``corrupt`` rule fires, return a byte-flipped COPY of ``data`` —
    the producer computes its CRC over the original first, so the
    corruption models the transport flipping bits after checksumming
    and the integrity layer MUST catch it. Honors the same
    `after`/`ramp`/budget scheduling as every other kind. Returns
    ``data`` unchanged when disabled, unmatched, or empty."""
    if not _state.enabled or not data:
        return data
    with _state.lock:
        hit = _draw_locked(op_name, family="corrupt")
        if hit is None:
            return data
        # up to 8 contiguous bytes XOR 0xFF at a seeded offset: enough
        # to defeat any checksum, deterministic under the profile seed
        off = _state.rng.randrange(len(data))
    buf = bytearray(data)
    for i in range(off, min(off + 8, len(buf))):
        buf[i] ^= 0xFF
    from . import metrics

    metrics.event("faultinj.corrupt", op=op_name, offset=off, nbytes=len(data))
    return bytes(buf)


def maybe_torn(op_name: str, data: bytes) -> bytes:
    """Chaos hook for durable-write producers:
    when a matched ``torn_write`` rule fires, return a PREFIX of
    ``data`` — modeling the process dying (or the disk filling) mid
    ``write(2)``, the failure journal/manifest replay must truncate
    past. Key it ``journal.append`` (the query journal crosses it on
    every record) or ``memgov.manifest`` (the spill-manifest writer).
    ``delayMs`` carries the bytes KEPT when positive (clamped to
    len-1 so the tear is never a no-op); otherwise half the record is
    kept. Honors the same `after`/`ramp`/budget scheduling as every
    other kind. Returns ``data`` unchanged when disabled, unmatched,
    or too short to tear."""
    if not _state.enabled or len(data) < 2:
        return data
    with _state.lock:
        hit = _draw_locked(op_name, family="torn_write")
        if hit is None:
            return data
        _kind, delay_ms = hit
    keep = int(delay_ms) if delay_ms > 0 else len(data) // 2
    keep = max(1, min(keep, len(data) - 1))
    from . import metrics

    metrics.event("faultinj.torn_write", op=op_name, kept=keep,
                  nbytes=len(data))
    return data[:keep]


# env-var activation, like CUDA_INJECTION64_PATH + FAULT_INJECTOR_CONFIG_PATH.
# A bad/missing config degrades the injector, never the host process
# (the reference's injector has the same stance).
from . import knobs as _knobs

_env_cfg = _knobs.get_str("SRJTORCH_FAULTINJ_CONFIG")
if _env_cfg:
    try:
        configure_from_file(_env_cfg)
    except Exception as e:  # srjt-lint: allow-broad-except(malformed chaos config degrades the injector, never the host process — the reference injector's stance)
        import warnings

        warnings.warn(f"faultinj: ignoring SRJTORCH_FAULTINJ_CONFIG ({e})", stacklevel=1)
