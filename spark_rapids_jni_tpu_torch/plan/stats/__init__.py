"""Statistics subsystem entry point (port of the JAX package's
``plan/stats/__init__.py``).

``table_stats(name, table)`` is the lazy, cached way in: sketches are
collected on first use per (table identity, generation) and cached
against ``cache/tablegen.py`` generation stamps, so invalidation rides
the exact discipline the plan/subresult caches already trust — bump
the generation (``invalidate_table``) and the stale sketch can never
be served again, because the stamp IS the cache key.

The cache is process-global and lock-guarded; it holds at most
``_MAX_CACHED`` table sketch-sets (FIFO eviction) so stats memory
stays bounded whatever the serving tier churns through — see the
PACKAGING "stats memory" note for the per-table bound.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ...utils import knobs
from .sketches import (ColumnSketch, TableStats, collect_table,
                       hll_estimate, selectivity, sketch_column,
                       DEFAULT_SELECTIVITY)
from .model import (Estimator, calibration_factor, choose_ooc_partitions,
                    load_calibration, plan_cost, reset_calibration,
                    row_width)

__all__ = [
    "ColumnSketch", "TableStats", "collect_table", "sketch_column",
    "selectivity", "hll_estimate", "DEFAULT_SELECTIVITY",
    "Estimator", "plan_cost", "row_width", "calibration_factor",
    "load_calibration", "reset_calibration", "choose_ooc_partitions",
    "enabled", "table_stats", "stats_for_tables", "make_estimator",
    "invalidate_table", "reset",
]

_MAX_CACHED = 256

_lock = threading.Lock()
# (tablegen serial, generation) -> TableStats; insertion-ordered for
# FIFO eviction — guarded by _lock
_cache: Dict[Tuple[int, int], TableStats] = {}


def enabled() -> bool:
    return knobs.get_bool("SRJTORCH_STATS_ENABLED")


def table_stats(table) -> TableStats:
    """Sketches for one bound table, collected lazily and cached
    against the table's generation stamp."""
    # lazy: cache/__init__ imports plan.compiler, which imports this
    # package — tablegen must load after plan is fully initialized
    from ...cache import tablegen

    key = tablegen.stamp(table)
    with _lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit
    ts = collect_table(
        table,
        bins=max(2, knobs.get_int("SRJTORCH_STATS_HISTOGRAM_BINS")),
        hll_bits=min(14, max(4, knobs.get_int("SRJTORCH_STATS_HLL_BITS"))),
        max_rows=max(1, knobs.get_int("SRJTORCH_STATS_MAX_ROWS")),
    )
    with _lock:
        while len(_cache) >= _MAX_CACHED:
            _cache.pop(next(iter(_cache)))
        _cache[key] = ts
    return ts


def stats_for_tables(tables) -> Dict[str, TableStats]:
    return {name: table_stats(t) for name, t in tables.items()}


def make_estimator(tables) -> Optional[Estimator]:
    """The compiler's one-stop: an Estimator over every bound table,
    or None when stats are knobbed off (the compiler then falls back
    to its hand-tuned heuristics)."""
    if not enabled():
        return None
    return Estimator(stats_for_tables(tables))


def invalidate_table(table) -> None:
    """Bump the table's generation: every cached sketch keyed to the
    old stamp is dropped AND unreachable (the new stamp is a new key),
    so a stale sketch cannot survive by construction."""
    from ...cache import tablegen

    serial, _gen = tablegen.stamp(table)
    tablegen.bump(table)
    with _lock:
        for key in [k for k in _cache if k[0] == serial]:
            _cache.pop(key)


def reset() -> None:
    """Drop every cached sketch and the memoized calibration (tests)."""
    with _lock:
        _cache.clear()
    reset_calibration()
