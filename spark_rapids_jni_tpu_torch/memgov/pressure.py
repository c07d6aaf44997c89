"""The pressure loop: turn blocked admissions into demotions (port of the
JAX package's ``memgov/pressure.py``).

When an admission would block (``admission.py``), the governor first
reclaims: unpinned catalog entries demote device->host in LRU order until
the request fits (``catalog.spill_until``), and the request queues only
for the demand the catalog cannot absorb.

The reference's last resort, ``MEMGOV_DROP_SMCACHE``, clears its memoized
jit(shard_map) executables when nothing spillable remains. The port has
no such cache (eager PyTorch compiles no per-callable program), so the
branch looks for the reference's module name under the port's package,
finds nothing and drops nothing: ``memgov.smcache_dropped`` stays 0, as
in the reference when its parallel tier is not loaded.

Metrics are registry-direct: ``memgov.pressure_events`` counts
invocations; the per-spill counters and histograms live with the catalog.
"""

from __future__ import annotations

import sys

from ..utils import knobs

__all__ = ["relieve"]


def _drop_smcache_armed() -> bool:
    return knobs.get_bool("SRJTORCH_MEMGOV_DROP_SMCACHE")


def relieve(need_bytes: int, catalog, name: str = "op") -> int:
    """Free up to ``need_bytes`` of accounted device bytes by demoting
    catalog entries (LRU, unpinned only). Returns the bytes reclaimed;
    the caller re-checks its admission condition, and relieve never
    raises for coming up short."""
    from ..utils import metrics

    reg = metrics.registry()
    reg.counter("memgov.pressure_events").inc()
    freed = catalog.spill_until(need_bytes, name=name)
    if (
        freed < need_bytes
        and catalog.spillable_device_bytes() == 0
        and _drop_smcache_armed()
    ):
        # a sys.modules lookup, not an import: the port has no such module
        smc = sys.modules.get(__name__.rsplit(".", 2)[0] + ".parallel._smcache")
        if smc is not None:
            n = smc.clear()
            if n:
                reg.counter("memgov.smcache_dropped").inc(n)
                metrics.event("memgov.smcache_dropped", entries=n, op=name)
    metrics.event(
        "memgov.pressure", op=name, need=int(need_bytes), freed=freed
    )
    return freed
