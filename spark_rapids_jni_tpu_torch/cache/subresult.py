"""Subresult cache (port of the JAX package's ``cache/subresult.py``):
stage outputs as governed memgov catalog entries.

Scan- and aggregate-stage results are registered with the memory
governor's ``BufferCatalog`` (``kind="cache"``), so eviction, spill
tiering and byte accounting ride the governor: a cached subresult can
demote host-ward under pressure and re-materializes (CRC-checked from
disk) on the next hit; a corrupt or closed entry is a miss that
recomputes, never stale bytes.

Keys are ``("sub", param_fp, literal_values, table_stamps, catalog_sig)``
tuples: the parameterized fingerprint of the subtree, the literal
bindings that specialize it, the generation stamps of every table it
scans (``tablegen.py``: a changed table makes the old key unreachable),
and the schema signature of the bound catalog. The compute side is
single-flighted per key.

Capacity: ``SRJTORCH_CACHE_SUBRESULT_BYTES`` bounds what the cache itself
retains (LRU unregistration) on top of the governor's own pressure loop.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict

from ..utils import faultinj, metrics, tracing
from ..utils.faultinj import CacheEvictInjected
from .flight import SingleFlight
from .plancache import _lru_touch, _pop_oldest

__all__ = ["SubresultCache"]


def _durable(name: str):
    return metrics.registry().counter(name)


class _SubEntry:
    __slots__ = ("regkey", "handle", "nbytes")

    def __init__(self, regkey: str, handle, nbytes: int):
        self.regkey = regkey
        self.handle = handle
        self.nbytes = nbytes


def _regkey(key) -> str:
    return "cache.sub." + hashlib.sha1(repr(key).encode()).hexdigest()[:16]


class SubresultCache:
    """key -> governed SpillableHandle map with LRU byte-capping."""

    def __init__(self, max_bytes: int):
        self._lock = threading.RLock()
        from ..analysis.lockdep import track as _race_track

        self._entries: Dict = _race_track({}, "cache.sub.entries")
        self._bytes = 0
        self._max_bytes = int(max_bytes)
        self._flight = SingleFlight("sub")

    # -- the hook _Exec.run calls --------------------------------------------

    def lookup_or_compute(self, key, thunk: Callable):
        """The compiled-stage hook: return the cached subtree result,
        or compute it (single-flighted) and insert. Every failure mode
        of the cached side — injected eviction, spill-tier corruption,
        a concurrently-closed handle — degrades to recompute."""
        try:
            # chaos choke point: a `cache_evict` rule keyed cache.* (or
            # this specific subtree's op) forces the entry out mid-query
            faultinj.maybe_inject(f"cache.sub.{key[1]}")
        except CacheEvictInjected:
            self.evict(key)
            _durable("cache.evict_injected").inc()
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                _lru_touch(self._entries, key)
        if e is not None:
            try:
                out = e.handle.get()
                _durable("cache.sub_hits").inc()
                tracing.event_span("cache.sub.hit", fp=key[1])
                return out
            except Exception:  # srjt-lint: allow-broad-except(any rematerialization failure degrades to a recompute miss)
                # DataCorruption from the spill tier, or the governor
                # closed it under us: drop and recompute — the CRC
                # layer's whole point is that rot is a MISS, not an
                # answer
                self.evict(key)
                _durable("cache.sub_corrupt").inc()

        def _compute():
            out = thunk()
            _durable("cache.sub_misses").inc()
            tracing.event_span("cache.sub.miss", fp=key[1])
            self._insert(key, out)
            return out

        return self._flight.run(key, _compute)

    # -- bookkeeping ---------------------------------------------------------

    def _insert(self, key, table) -> None:
        from .. import memgov

        cat = memgov.catalog()
        h = cat.register(_regkey(key), table, kind="cache")
        evicted = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                # same key re-registered: catalog already closed the
                # old handle (register replaces); only fix accounting
                self._bytes -= old.nbytes
            self._entries[key] = _SubEntry(_regkey(key), h, h.nbytes)
            self._bytes += h.nbytes
            while self._bytes > self._max_bytes and len(self._entries) > 1:
                _, victim = _pop_oldest(self._entries)
                self._bytes -= victim.nbytes
                evicted.append(victim)
        for victim in evicted:
            cat.unregister(victim.regkey)
            _durable("cache.sub_evictions").inc()

    def evict(self, key) -> bool:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self._bytes -= e.nbytes
        if e is None:
            return False
        from .. import memgov

        memgov.catalog().unregister(e.regkey)
        _durable("cache.sub_evictions").inc()
        return True

    def invalidate_serial(self, serial: int) -> int:
        """Drop every entry whose key references table ``serial`` (the
        proactive half of invalidation — the key-shape half is that a
        bumped generation makes future lookups miss anyway)."""
        with self._lock:
            doomed = [
                k for k in self._entries
                if any(s[1][0] == serial for s in k[3])
            ]
        n = 0
        for k in doomed:
            if self.evict(k):
                n += 1
        if n:
            _durable("cache.invalidations").inc(n)
        return n

    def clear(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            self._bytes = 0
        from .. import memgov

        cat = memgov.catalog()
        for e in entries:
            cat.unregister(e.regkey)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self._max_bytes,
                "inflight": self._flight.inflight_count(),
            }
