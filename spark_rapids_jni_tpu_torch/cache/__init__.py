"""The caching tier (port of the JAX package's ``cache/``).

Three cooperating layers, each knob-gated and OFF by default (with every
knob down this package is inert and ``compile_cached`` is exactly
``plan.compile_ir``):

1. **Compiled-plan cache** (``SRJTORCH_PLAN_CACHE``, ``plancache.py``):
   entries keyed on the plan's *parameterized* fingerprint (structure
   with literal values slotted out) plus the catalog schema signature. A
   hit skips rewrite->verify->compile; fresh literal values are bound
   into the cached optimized plan and only re-lowered. Artifacts are
   verifier-green at insert (``verify_for_cache``) and carry their
   obligation ledger forward.
2. **Subresult cache** (``SRJTORCH_SUBRESULT_CACHE``, ``subresult.py``):
   scan and aggregate stage outputs registered as memgov catalog entries
   (``kind="cache"``), so eviction, spill tiering and byte accounting
   ride the governor. Keys carry per-table generation stamps
   (``tablegen.py``); ``invalidate_table`` bumps a stamp and drops the
   dependents.
3. **In-flight sharing** (``SRJTORCH_CACHE_SHARING``, ``flight.py``):
   concurrent submissions of the same (plan, literals, tables) attach to
   ONE in-flight execution through a single-flight latch.

Cached plans also carry an observed-cost EWMA (``predicted_cost_s``).
All counters are registry-direct under ``cache.*``, and
``stats_section()`` reports them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..plan.compiler import compile_ir
from ..utils import knobs, metrics
from . import tablegen
from .flight import SingleFlight
from .plancache import PlanCache, catalog_signature, table_stamps
from .subresult import SubresultCache

__all__ = [
    "CachedQuery",
    "compile_cached",
    "invalidate_table",
    "is_enabled",
    "plan_cache",
    "reset",
    "stats_section",
    "subresult_cache",
    "table_generation",
]

_lock = threading.Lock()
_plan_cache: Optional[PlanCache] = None
_subresult_cache: Optional[SubresultCache] = None
# plan-level single-flight: shares whole-query executions across
# concurrent identical submissions (subresult.py has its own latch for
# stage-level sharing)
_plan_flight = SingleFlight("plan")

# the counters stats_section reports (all registry-durable, survive
# stage_report resets)
_COUNTER_NAMES = (
    "hits", "misses", "rebinds", "rebind_fallbacks",
    "insert_verified", "insert_rejected", "evictions", "evict_injected",
    "share", "share_fallback",
    "sub_hits", "sub_misses", "sub_evictions", "sub_corrupt",
    "invalidations",
)


def is_enabled() -> bool:
    return knobs.get_bool("SRJTORCH_PLAN_CACHE")


def plan_cache() -> PlanCache:
    """The process singleton, sized from knobs at first use."""
    global _plan_cache
    with _lock:
        if _plan_cache is None:
            _plan_cache = PlanCache(
                max_entries=knobs.get_int("SRJTORCH_CACHE_PLAN_ENTRIES"),
                max_variants=knobs.get_int("SRJTORCH_CACHE_PLAN_VARIANTS"),
            )
        return _plan_cache


def subresult_cache() -> SubresultCache:
    global _subresult_cache
    with _lock:
        if _subresult_cache is None:
            _subresult_cache = SubresultCache(
                max_bytes=knobs.get_int("SRJTORCH_CACHE_SUBRESULT_BYTES"),
            )
        return _subresult_cache


class CachedQuery:
    """What the serve scheduler runs when the plan cache is armed: a
    callable over a cached ``CompiledPlan`` that (a) single-flights
    identical concurrent submissions, (b) feeds observed wall time back
    into the structure's cost EWMA, and (c) passes the compiled plan's
    memory estimate through for memgov pre-admission."""

    __slots__ = ("_cp", "_ck", "_vkey", "_pc")

    def __init__(self, cp, ck, vkey, pc: PlanCache):
        self._cp = cp
        self._ck = ck
        self._vkey = vkey
        self._pc = pc

    @property
    def estimated_memory_bytes(self):
        return getattr(self._cp, "estimated_memory_bytes", None)

    @property
    def partition_memory_bytes(self):
        # when the cached binding degraded to
        # out-of-core, serve admission wants the per-partition peak
        return getattr(self._cp, "partition_memory_bytes", None)

    @property
    def name(self):
        return getattr(self._cp, "name", "plan")

    @property
    def compiled(self):
        return self._cp

    @property
    def predicted_cost_s(self) -> Optional[float]:
        """The structure's observed-cost EWMA — the scheduler's
        admission forecast input. None until the first completed run."""
        return self._pc.predicted_cost(self._ck)

    def __call__(self):
        if self._vkey is not None and knobs.get_bool("SRJTORCH_CACHE_SHARING"):
            # key on the exact submission: structure + literal values +
            # table stamps — anything less would fan one answer out to
            # queries that asked different questions
            return _plan_flight.run((self._ck, self._vkey), self._run_once)
        return self._run_once()

    def _run_once(self):
        t0 = time.perf_counter()
        out = self._cp()
        self._pc.observe_cost(self._ck, time.perf_counter() - t0)
        return out


def compile_cached(plan, tables: Dict, name: str = "plan"):
    """The serve tier's compile entry point. Off-knob this IS
    ``compile_ir``; armed, it returns a ``CachedQuery`` over the
    cached/rebound/freshly-compiled plan."""
    if not knobs.get_bool("SRJTORCH_PLAN_CACHE"):
        return compile_ir(plan, tables, name=name)
    sub = (subresult_cache()
           if knobs.get_bool("SRJTORCH_SUBRESULT_CACHE") else None)
    cp, ck, vkey = plan_cache().get_or_compile(
        plan, tables, name=name, subcache=sub
    )
    return CachedQuery(cp, ck, vkey, plan_cache())


def table_generation(table):
    """The (serial, generation) stamp cache keys carry for ``table``."""
    return tablegen.stamp(table)


def invalidate_table(table):
    """The explicit invalidation hook: callers that mutate/reload a
    table's content in place call this — the generation bump makes
    every derived cache key unreachable, and cached subresults that
    reference the table are proactively dropped. Returns the new
    stamp."""
    serial, _ = tablegen.stamp(table)
    new_stamp = tablegen.bump(table)
    with _lock:
        sc = _subresult_cache
    if sc is not None:
        sc.invalidate_serial(serial)
    return new_stamp


def stats_section() -> dict:
    """The ``cache`` section of runtime.stats_report(): knob posture,
    durable counters, and per-layer snapshots."""
    reg = metrics.registry()
    out = {
        "enabled": {
            "plan": knobs.get_bool("SRJTORCH_PLAN_CACHE"),
            "subresult": knobs.get_bool("SRJTORCH_SUBRESULT_CACHE"),
            "sharing": knobs.get_bool("SRJTORCH_CACHE_SHARING"),
        },
        "counters": {n: reg.value(f"cache.{n}") for n in _COUNTER_NAMES},
    }
    with _lock:
        pc, sc = _plan_cache, _subresult_cache
    if pc is not None:
        out["plan"] = pc.snapshot()
    if sc is not None:
        out["subresult"] = sc.snapshot()
    try:
        from .. import memgov

        entries, nbytes = memgov.catalog().kind_stats("cache")
        out["governed"] = {"entries": entries, "bytes": nbytes}
    except Exception:  # srjt-lint: allow-broad-except(stats reporting must never fail the report)
        pass
    return out


def reset() -> None:
    """Test hook: drop both caches (unregistering governed subresult
    entries) and all table-generation records."""
    global _plan_cache, _subresult_cache
    with _lock:
        pc, sc = _plan_cache, _subresult_cache
        _plan_cache = None
        _subresult_cache = None
    if pc is not None:
        pc.clear()
    if sc is not None:
        sc.clear()
    tablegen.reset()
