"""Compiled-plan cache (port of the JAX package's ``cache/plancache.py``).

Entries key on ``(parameterized fingerprint, catalog signature)``: the
plan's structure with literal values slotted out
(``plan.rewrites.parameterized_fingerprint``) plus the dtype schema of
the bound tables, so "the same dashboard query, another date" maps to
ONE entry. A hit skips rewrite->verify->compile:

- exact-variant hit: the same literal values over the same table objects
  return the retained ``CompiledPlan`` itself;
- rebind hit: fresh literal values are substituted into the cached
  OPTIMIZED plan (``rebind_literals``) and only re-lowered
  (``plan.compiler.lower_ir``); the rewrite fixpoint and the verifier do
  not run again.

At INSERT the compiled artifact must be verifier-green
(``verify_for_cache``: obligations discharge, estimates consistent) or it
is not cached; every hit carries the original obligation ledger forward.

Rebind soundness: slot tags pin the literal type class (and an explicit
dtype), so substitution cannot change an inferred schema; rewrite rules
copy and reorder literals but never fold them, so mapping old values to
new BY VALUE reproduces the plan a fresh rewrite would produce. When the
mapping would be ambiguous (one old value, two new values) or a value
does not round-trip equality (NaN), the cache falls back to a full
compile, counted under ``cache.rebind_fallbacks``.

Cached entries also carry an observed-cost EWMA (``observe_cost``), the
admission-cost forecast a serving scheduler sheds on.
"""

from __future__ import annotations

import hashlib
import math
import threading
from typing import Dict, Optional, Tuple

from ..plan.compiler import CompiledPlan, compile_ir, lower_ir
from ..plan.nodes import Aggregate, Node, Scan
from ..plan.rewrites import parameterized_fingerprint, rebind_literals
from ..plan.verifier import verify_for_cache
from ..utils import faultinj, metrics, tracing
from ..utils.faultinj import CacheEvictInjected
from . import tablegen

__all__ = ["PlanCache", "arm_subresults", "catalog_signature",
           "table_stamps"]

# cost EWMA weight for the newest observation
_COST_ALPHA = 0.3


def _durable(name: str):
    return metrics.registry().counter(name)


def catalog_signature(tables: Dict) -> str:
    """Schema signature of the bound tables: a cached optimized plan is
    only valid against the column dtypes it was rewritten for (rules
    consult the catalog), so the signature is part of the entry key."""
    items = tuple(sorted(
        (name, tuple((n, int(c.dtype.id), c.dtype.scale)
                     for n, c in zip(t.names, t.columns)))
        for name, t in tables.items()
    ))
    return hashlib.sha1(repr(items).encode()).hexdigest()[:12]


def table_stamps(tables: Dict) -> Tuple:
    """Sorted (name, (serial, generation)) stamps of the bound tables —
    the identity/invalidation component of variant and subresult keys."""
    return tuple(sorted((name, tablegen.stamp(t))
                        for name, t in tables.items()))


def _values_ok(values) -> bool:
    """False when any literal value does not round-trip equality (NaN):
    such a value can neither key a variant nor anchor a rebind map."""
    for v in values:
        try:
            if v != v:
                return False
        except Exception:
            return False
    return True


def _subtree_tables(node: Node):
    """Names of the tables the subtree scans, sorted."""
    names = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, Scan):
            names.add(n.table)
        stack.extend(n.inputs())
    return tuple(sorted(names))


def arm_subresults(cp: CompiledPlan, tables: Dict, sig: str,
                   subcache) -> None:
    """Point the compiled plan's stage executors at the subresult
    cache: Scan and Aggregate stages (and the plan root) get a
    ``("sub", param_fp, literal_values, table_stamps, catalog_sig)``
    cache key, and ``_Exec.run`` routes through
    ``subcache.lookup_or_compute`` instead of computing. Must run
    BEFORE the plan is published to other threads (keys are written
    once here, read-only afterwards)."""
    if subcache is None:
        return
    cp.subcache = subcache
    seen = set()
    stack = [cp.optimized]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.extend(node.inputs())
        if not (node is cp.optimized or isinstance(node, (Scan, Aggregate))):
            continue
        ex = cp.exec_for(node)
        if ex is None:
            continue  # fused away or not lowered standalone
        pf = parameterized_fingerprint(node)
        if not _values_ok(pf.values):
            continue  # NaN literal: the key would never hit
        refs = _subtree_tables(node)
        if any(t not in tables for t in refs):
            continue
        stamps = tuple((t, tablegen.stamp(tables[t])) for t in refs)
        ex.cache_key = ("sub", pf.key, pf.values, stamps, sig)


class _PlanEntry:
    """One parameterized structure: the cached optimized plan + its
    provenance, bound variants, and the observed-cost EWMA."""

    __slots__ = ("opt_plan", "obligations", "rewrites", "raw_nodes",
                 "bindings", "rebindable", "variants", "cost_ewma_s")

    def __init__(self, opt_plan: Node, obligations, rewrites, raw_nodes,
                 bindings, rebindable: bool):
        self.opt_plan = opt_plan
        self.obligations = obligations
        self.rewrites = rewrites
        self.raw_nodes = raw_nodes
        self.bindings = bindings  # raw-plan (tag, value, dtype_key) triples
        self.rebindable = rebindable
        self.variants: Dict = {}  # vkey -> CompiledPlan, LRU order
        self.cost_ewma_s: Optional[float] = None


def _lru_touch(d, key) -> None:
    """move_to_end without OrderedDict: pop + reinsert (the LRU maps are
    plain dicts, whose insertion order is a language guarantee)."""
    d[key] = d.pop(key)


def _pop_oldest(d):
    """Evict the least-recently-touched entry (the insertion-order
    head; every hit reinserts at the tail via ``_lru_touch``)."""
    k = next(iter(d))
    return k, d.pop(k)


def _rebindable(raw_bindings, opt_plan: Node) -> bool:
    """A structure is literal-rebindable when the optimized plan's
    literals and the raw plan's literals cover each other by value-key
    (null fills excepted — rewrite-synthesized and binding-independent).
    Any folding/elimination a future rule might introduce breaks the
    containment and demotes the entry to exact-variant hits only."""
    if not _values_ok(tuple(b[1] for b in raw_bindings)):
        return False
    raw_keys = set(raw_bindings)
    opt_keys = set(parameterized_fingerprint(opt_plan).bindings)
    if not raw_keys <= opt_keys:
        return False
    return all(k in raw_keys for k in opt_keys if k[0] != "null")


class PlanCache:
    """(param_fp, catalog_sig) -> _PlanEntry under one lock; compiles
    run OUTSIDE the lock (two concurrent misses may both compile — the
    single-flight latch shares executions, not compilations)."""

    def __init__(self, max_entries: int, max_variants: int):
        self._lock = threading.RLock()
        self._entries: Dict = {}
        self._max_entries = int(max_entries)
        self._max_variants = int(max_variants)

    # -- the serve integration point -----------------------------------------

    def get_or_compile(self, plan: Node, tables: Dict, name: str = "plan",
                       subcache=None) -> Tuple[CompiledPlan, tuple, tuple]:
        """The cache-armed replacement for ``compile_ir``: returns
        ``(compiled, entry_key, variant_key)`` — the keys identify the
        structure (for cost observation) and the exact submission (for
        single-flight sharing)."""
        pf = parameterized_fingerprint(plan)
        sig = catalog_signature(tables)
        ck = (pf.key, sig)
        try:
            # chaos choke point (`cache_evict` keyed cache.*): the
            # whole structure entry is dropped mid-submission and the
            # lookup proceeds as a miss
            faultinj.maybe_inject(f"cache.plan.{pf.key}")
        except CacheEvictInjected:
            with self._lock:
                self._entries.pop(ck, None)
            _durable("cache.evict_injected").inc()
        stamps = table_stamps(tables)
        vkey = (pf.values, stamps) if _values_ok(pf.values) else None
        entry: Optional[_PlanEntry] = None
        cp: Optional[CompiledPlan] = None
        with self._lock:
            entry = self._entries.get(ck)
            if entry is not None:
                _lru_touch(self._entries, ck)
                if vkey is not None:
                    cp = entry.variants.get(vkey)
                    if cp is not None:
                        _lru_touch(entry.variants, vkey)
        if cp is not None:
            _durable("cache.hits").inc()
            tracing.event_span("cache.hit", fp=pf.key, kind="exact")
            return cp, ck, vkey
        if entry is not None:
            cp = self._rebind(entry, pf, tables, name)
            if cp is not None:
                arm_subresults(cp, tables, sig, subcache)
                self._put_variant(ck, vkey, cp)
                _durable("cache.hits").inc()
                _durable("cache.rebinds").inc()
                tracing.event_span("cache.hit", fp=pf.key, kind="rebind")
                return cp, ck, vkey
            _durable("cache.rebind_fallbacks").inc()
        # -- miss: full compile, verify, insert -------------------------------
        cp = compile_ir(plan, tables, name=name)
        _durable("cache.misses").inc()
        tracing.event_span("cache.miss", fp=pf.key)
        arm_subresults(cp, tables, sig, subcache)
        violations = verify_for_cache(cp, tables, where=f"cache.{name}")
        if violations:
            # not verifier-green: run it, never cache it
            _durable("cache.insert_rejected").inc()
            return cp, ck, vkey
        _durable("cache.insert_verified").inc()
        fresh = _PlanEntry(cp.optimized, cp.obligations, cp.rewrites_fired,
                           cp._raw_nodes, pf.bindings,
                           _rebindable(pf.bindings, cp.optimized))
        if vkey is not None:
            fresh.variants[vkey] = cp
        evicted = 0
        with self._lock:
            prev = self._entries.get(ck)
            if prev is not None:
                # concurrent miss raced us: keep the incumbent (its
                # variants/EWMA are warmer), just add our variant
                if vkey is not None and vkey not in prev.variants:
                    prev.variants[vkey] = cp
                    while len(prev.variants) > self._max_variants:
                        _pop_oldest(prev.variants)
            else:
                self._entries[ck] = fresh
                while len(self._entries) > self._max_entries:
                    _pop_oldest(self._entries)
                    evicted += 1
        if evicted:
            _durable("cache.evictions").inc(evicted)
        return cp, ck, vkey

    def _rebind(self, entry: _PlanEntry, pf, tables: Dict,
                name: str) -> Optional[CompiledPlan]:
        """Bind fresh literal values into the cached optimized plan and
        re-lower. None when the entry cannot be rebound soundly (the
        caller falls back to a full compile)."""
        if not entry.rebindable:
            return None
        if len(entry.bindings) != len(pf.bindings):
            return None  # same key implies same arity; refuse if not
        if not _values_ok(pf.values):
            return None
        mapping: Dict = {}
        for old, new in zip(entry.bindings, pf.bindings):
            if old[0] != new[0] or old[2] != new[2]:
                return None  # tag/dtype drift — refuse to guess
            if old in mapping and not _same(mapping[old], new[1]):
                return None  # ambiguous: one old value, two new values
            mapping[old] = new[1]
        rebound = rebind_literals(entry.opt_plan, mapping)
        return lower_ir(rebound, tables, name=name,
                        raw_nodes=entry.raw_nodes,
                        rewrites_fired=entry.rewrites,
                        obligations=entry.obligations)

    def _put_variant(self, ck, vkey, cp: CompiledPlan) -> None:
        if vkey is None:
            return
        with self._lock:
            entry = self._entries.get(ck)
            if entry is None:
                return
            entry.variants.pop(vkey, None)
            entry.variants[vkey] = cp
            while len(entry.variants) > self._max_variants:
                _pop_oldest(entry.variants)

    # -- cost forecasting ----------------------------------------------------

    def observe_cost(self, ck, seconds: float) -> None:
        if not (isinstance(seconds, float) and math.isfinite(seconds)):
            return
        with self._lock:
            entry = self._entries.get(ck)
            if entry is None:
                return
            if entry.cost_ewma_s is None:
                entry.cost_ewma_s = seconds
            else:
                entry.cost_ewma_s = (_COST_ALPHA * seconds
                                     + (1.0 - _COST_ALPHA) * entry.cost_ewma_s)

    def predicted_cost(self, ck) -> Optional[float]:
        with self._lock:
            entry = self._entries.get(ck)
            return None if entry is None else entry.cost_ewma_s

    # -- maintenance ---------------------------------------------------------

    def evict(self, ck) -> bool:
        with self._lock:
            if self._entries.pop(ck, None) is None:
                return False
        _durable("cache.evictions").inc()
        return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "max_entries": self._max_entries,
                "variants": sum(len(e.variants)
                                for e in self._entries.values()),
                "rebindable": sum(1 for e in self._entries.values()
                                  if e.rebindable),
            }


def _same(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:
        return False
