"""Out-of-core partitioned execution (port of the JAX package's
``plan/ooc.py``).

The memory governor can spill *buffers*, but a query whose working set
exceeds ``SRJTORCH_DEVICE_MEMORY_BUDGET`` would split-retry until it
failed. This module turns that case into a scheduled data movement: when
the compiler's whole-plan peak exceeds the admitted budget and the plan
has the partitionable shape, the query runs as K hash-partitioned slices
streamed through the SAME compiled plan, with the partials merged by the
distributed tier's coordinator merge (``distribute.merge_partials``).

The decision is a verified rewrite: the selected Aggregate becomes a
``UnionAll`` of per-partition aggregates filtered by
``part_hash(keys, K) == i``, recorded as a ``partition_for_ooc``
obligation that the verifier discharges structurally
(``verifier._d_partition_ooc``). The rewrite is EXACT:

- every row of one group carries the same key tuple, so the murmur3
  partition id puts each group whole into exactly one branch;
- the physical partitioner (``parallel.shuffle.hash_partition``, B1 on
  the card for one INT32 or INT64 key) uses a STABLE argsort over the
  same ``ops.hashing.hash_partition_map`` the plan predicate lowers to,
  so each group's accumulation sequence is the in-core one and the
  partials are bit-identical;
- the plan's root Sort totally orders the group keys, so the post-merge
  re-sort reproduces the in-core row order.

Execution streams the partitions under ONE plan-level memgov admission
sized to the PER-PARTITION peak (nested admissions skip, the outermost
discipline). Inputs are registered as spill-backed ``kind="partition"``
catalog entries; the in-flight partition is PINNED so that the pressure
loop cannot evict what the current step computes over; a prefetch thread
re-materializes the NEXT partition's spill-in while the current one
computes. (The reference's prefetch also pings its sidecar pool; the
port has no sidecar pool yet, so that half is absent.) Each completed
partition's partial is checkpointed in the catalog under a stable
fingerprinted key, so a retried run RESUMES from the last complete
partition and lineage-recomputes only the hole.

Cache safety: ``OutOfCorePlan`` delegates ``optimized`` (and every other
attribute it does not own) to the inner ``CompiledPlan``; the plan cache
keys and rebinds on the UN-partitioned structure, and a cache hit
re-enters ``maybe_out_of_core`` through ``lower_ir``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, Optional, Tuple

from ..utils import knobs, metrics
from . import exprs as ex
from .nodes import Aggregate, Exchange, Filter, Node, Project, Scan, Sort, UnionAll
from .rewrites import Obligation, _make_obligation, fingerprint

__all__ = ["OutOfCorePlan", "maybe_out_of_core", "partition_rewrite"]

_MAX_AUTO_PARTITIONS = 64

# re-entrancy guard: the per-partition lower_ir calls inside
# OutOfCorePlan.__call__ must never select out-of-core again (a
# partition that still overflows the budget falls back to the
# split-retry path rather than recursing)
_tls = threading.local()


def _reg():
    return metrics.registry()


@dataclasses.dataclass(frozen=True)
class _OocTarget:
    """The partitionable shape: ``Sort(Aggregate(spine(Scan)))`` where
    the Sort totally orders the group keys and every group key traces
    through the spine's Projects as a pure column ref down to the
    Scan."""

    sort: Sort
    agg: Aggregate
    table: str
    key_cols: Tuple[str, ...]


def find_target(opt_plan: Node) -> Optional[_OocTarget]:
    """Match the (conservative) partitionable plan shape, or None.

    Requirements, each load-bearing for bit-identity:
    - root ``Sort`` whose key columns cover the aggregate keys (total
      order over the output -> the merged re-sort reproduces the
      in-core row order exactly);
    - keyed ``Aggregate`` (no grouping sets — ROLLUP expands to a
      UnionAll before this runs, and its branches do not share one key
      set);
    - the aggregate input is a unary spine of Filter/Project (and
      world-1 Exchange) over a single Scan, with every group key a pure
      rename through the Projects — those resolved names are the
      physical partition keys ``hash_partition`` uses, guaranteeing the
      executor's slices select exactly the rewrite's branch rows.
    """
    if not isinstance(opt_plan, Sort):
        return None
    agg = opt_plan.input
    if not isinstance(agg, Aggregate) or not agg.keys \
            or agg.grouping_sets is not None:
        return None
    sort_cols = {c for c, _ in opt_plan.keys}
    if not set(agg.keys) <= sort_cols:
        return None
    names = list(agg.keys)
    n = agg.input
    while True:
        if isinstance(n, Filter):
            n = n.input
        elif isinstance(n, Exchange):
            if n.world != 1:
                return None  # a distributed plan partitions via its exchanges
            n = n.input
        elif isinstance(n, Project):
            mapping = {out: ex.is_col(e) for out, e in n.exprs}
            resolved = [mapping.get(name) for name in names]
            if any(r is None for r in resolved):
                return None  # a key is computed, not a rename
            names = resolved
            n = n.input
        elif isinstance(n, Scan):
            if n.columns is not None and not set(names) <= set(n.columns):
                return None
            return _OocTarget(opt_plan, agg, n.table, tuple(names))
        else:
            return None


def partition_rewrite(agg: Aggregate, parts: int) -> UnionAll:
    """The ``partition_for_ooc`` rewrite output: branch ``i`` aggregates
    exactly the rows whose key tuple hashes to partition ``i``. Ordered
    ``i = 0..parts-1`` branches give the verifier disjointness and
    completeness by construction (the partition ids partition rows)."""
    branches = []
    for i in range(parts):
        pred = ex.ppart(agg.keys, parts) == ex.plit(i)
        branches.append(
            Aggregate(Filter(agg.input, pred), keys=agg.keys, aggs=agg.aggs)
        )
    return UnionAll(tuple(branches))


def _auto_partitions(est_bytes: int, budget: int) -> int:
    """Smallest K whose per-partition estimate fits HALF the budget —
    headroom for the checkpointed partial, the prefetched next
    partition, and the merge — capped at ``_MAX_AUTO_PARTITIONS``."""
    target = max(1, budget // 2)
    for k in range(2, _MAX_AUTO_PARTITIONS + 1):
        if -(-est_bytes // k) <= target:
            return k
    return _MAX_AUTO_PARTITIONS


def maybe_out_of_core(cp, tables: Dict):
    """Compiler tail hook (``compile_ir``/``lower_ir``): when the plan's
    estimated peak exceeds the armed device budget and the plan has the
    partitionable shape, wrap it for streamed partitioned execution.
    Everything else returns ``cp`` unchanged — the hook is free unless
    ``SRJTORCH_OOC_ENABLED`` is set."""
    if not knobs.get_bool("SRJTORCH_OOC_ENABLED"):
        return cp
    if getattr(_tls, "active", False):
        return cp
    from .. import memgov

    if not memgov.is_enabled():
        return cp
    budget = knobs.get_int("SRJTORCH_DEVICE_MEMORY_BUDGET") or 0
    if budget <= 0 or cp.estimated_memory_bytes <= budget:
        return cp
    target = find_target(cp.optimized)
    if target is None:
        return cp
    parts = knobs.get_int("SRJTORCH_OOC_PARTITIONS") or 0
    if parts < 2:
        # K comes from the cost model (calibrated per-partition peak
        # against half the budget); the knob is an explicit override, and
        # the uncalibrated ladder is the fallback when even max_parts
        # cannot fit
        from .stats.model import choose_ooc_partitions

        parts = choose_ooc_partitions(
            cp.estimated_memory_bytes, budget,
            max_parts=_MAX_AUTO_PARTITIONS,
        ) or _auto_partitions(cp.estimated_memory_bytes, budget)
    union = partition_rewrite(target.agg, parts)
    catalog = {t: {n: c.dtype for n, c in zip(tbl.names, tbl.columns)}
               for t, tbl in tables.items()}
    ob = _make_obligation("partition_for_ooc", target.agg, union, catalog)
    partitioned = Sort(union, target.sort.keys)
    _reg().counter("plan.ooc.selected").inc()
    metrics.event(
        "plan.ooc.selected", query=cp.name, partitions=parts,
        est_bytes=cp.estimated_memory_bytes, budget_bytes=budget,
    )
    return OutOfCorePlan(cp, partitioned, ob, target, parts)


class OutOfCorePlan:
    """A ``CompiledPlan`` degraded to streamed partitioned execution.

    Delegates every attribute it does not own to the inner plan
    (``optimized``, ``stages``, ``schema``, ``estimated_memory_bytes``,
    ``exec_for`` — the whole audit/cache surface), and overrides only:

    - ``obligations``: the inner ledger plus the ``partition_for_ooc``
      record (any stale partition obligation from a cached ledger is
      replaced — the budget, and so K, may differ per binding);
    - ``partition_memory_bytes``: the per-partition peak estimate the
      serve scheduler admits INSTEAD of the whole-plan peak;
    - ``__call__``: the streamed pin/prefetch/checkpoint/resume/merge
      loop.
    """

    def __init__(self, inner, partitioned: Sort, obligation: Obligation,
                 target: _OocTarget, partitions: int):
        self._inner = inner
        self.partitioned = partitioned
        self.partition_obligation = obligation
        self.partitions = int(partitions)
        self.obligations = [
            ob for ob in inner.obligations if ob.rule != "partition_for_ooc"
        ] + [obligation]
        self.partition_memory_bytes = max(
            1, -(-inner.estimated_memory_bytes // self.partitions)
        )
        self._target = target
        self._fp = fingerprint(partitioned)
        self.last_report: Optional[dict] = None

    def __getattr__(self, name):
        try:
            inner = object.__getattribute__(self, "_inner")
        except AttributeError:
            raise AttributeError(name)
        return getattr(inner, name)

    @property
    def rewrites_fired(self) -> Dict[str, int]:
        out = self._inner.rewrites_fired
        out["partition_for_ooc"] = out.get("partition_for_ooc", 0) + 1
        return out

    # -- checkpoint keys (stable across retries: resume depends on a
    # -- retried __call__ finding the prior attempt's partials) --------------
    def _in_key(self, i: int) -> str:
        return f"ooc.{self._inner.name}.{self._fp}.in.{i}"

    def _part_key(self, i: int) -> str:
        return f"ooc.{self._inner.name}.{self._fp}.part.{i}"

    def _release(self, cat, inputs: bool = True, partials: bool = True) -> None:
        for i in range(self.partitions):
            if inputs:
                cat.unregister(self._in_key(i))
            if partials:
                cat.unregister(self._part_key(i))

    def __call__(self):
        from .. import memgov
        from ..ops.copying import slice_table
        from ..parallel.shuffle import hash_partition
        from ..utils import deadline, faultinj
        from ..utils.errors import DataCorruption, RetryableError
        from .compiler import lower_ir
        from .distribute import merge_partials

        inner = self._inner
        reg = _reg()
        cat = memgov.catalog()
        parts = self.partitions
        t0 = time.perf_counter()
        spills0 = (reg.counter("memgov.spills").value
                   + reg.counter("memgov.disk_spills").value)
        reg.counter("ooc.runs").inc()
        reg.counter("ooc.partitions").inc(parts)
        resumes = 0
        recomputes = 0

        src_tables = dict(inner._tables)
        src = src_tables[self._target.table]
        key_cols = list(self._target.key_cols)

        built_inputs: set = set()

        def ensure_input(i: int):
            """The partition-i input handle, (re)computed from lineage
            when absent or retired — deterministic: the stable argsort
            over the seeded hash reproduces the identical slice."""
            nonlocal recomputes
            h = cat.lookup(self._in_key(i))
            if h is not None:
                return h
            if i in built_inputs:
                # the entry existed and is gone: retired by the catalog
                # on a corrupt spill frame (possibly discovered by the
                # prefetcher, whose advisory read swallows the error) or
                # evicted under pressure — either way this rebuild IS
                # the lineage recompute for the hole
                recomputes += 1
                reg.counter("ooc.lineage_recomputes").inc()
                metrics.event("plan.ooc.recompute", query=inner.name,
                              partition=i)
            deadline.check(f"plan.ooc.repartition[{i}]")
            reordered, offsets = hash_partition(src, parts, key_cols)
            lo = offsets[i]
            hi = offsets[i + 1] if i + 1 < parts else reordered.num_rows
            h = cat.register(self._in_key(i),
                             slice_table(reordered, lo, hi),
                             kind="partition")
            built_inputs.add(i)
            return h

        def warm(i: int):
            """Prefetch: re-materialize the next partition's spill-in
            while the current partition computes. Best-effort: a failure
            is the compute path's to rediscover, never the query's."""
            try:
                h = cat.lookup(self._in_key(i))
                if h is not None:
                    h.get()
            except Exception:  # the compute path re-raises anything real
                pass

        prefetch_on = knobs.get_bool("SRJTORCH_OOC_PREFETCH") and parts > 1

        def demote(h) -> None:
            """Best-effort device->host demotion: partitions at rest are
            SPILL-BACKED, not device-resident — the whole point of the
            strategy. A failed spill (injected spill_fail, sick disk)
            leaves the entry resident; the pressure loop and the
            catalog's own counters already account for it."""
            try:
                h.spill()
            except (ValueError, RetryableError, OSError):
                pass

        def compute_partition(i: int) -> None:
            """Run partition ``i`` through the compiled pipeline
            (pinned input — the self-eviction livelock guard), then
            checkpoint the partial in the catalog and demote it; the
            input entry is dropped (recomputable from lineage)."""
            attempt = 0
            while True:
                h = ensure_input(i)
                h.pin()
                try:
                    part_tbl = h.get()
                    sub = lower_ir(
                        inner.optimized,
                        {**src_tables, self._target.table: part_tbl},
                        name=f"{inner.name}.ooc{i}",
                    )
                    out = sub()
                    break
                except DataCorruption:
                    # corrupt partition spill: the catalog already
                    # retired the entry — loop back so ensure_input
                    # lineage-recomputes (and counts) the hole, once; a
                    # second corruption propagates to the caller's
                    # retry machinery
                    attempt += 1
                    if attempt >= 2:
                        raise
                finally:
                    h.unpin()
            # checkpoint the partial BEFORE dropping the input: a crash
            # after this line resumes past partition i. The checkpoint
            # is demoted immediately — only the in-flight partition's
            # working set stays device-resident.
            ckpt = cat.register(self._part_key(i), out, kind="partition")
            cat.unregister(self._in_key(i))
            # deliberate drop: a later rebuild (e.g. for a rotted
            # checkpoint, counted at the merge site) is not a new hole
            built_inputs.discard(i)
            # durable checkpoints go all the way to the DISK tier, so
            # that their manifests survive a killed coordinator and a
            # restarted process resumes past them. Same best-effort
            # posture as the plain demotion.
            if knobs.get_bool("SRJTORCH_OOC_DURABLE_CHECKPOINTS"):
                try:
                    ckpt.spill(to_disk=True)
                except (ValueError, RetryableError, OSError):
                    pass
            else:
                demote(ckpt)

        prefetcher: Optional[threading.Thread] = None
        # ONE plan-level admission sized to the per-partition peak for
        # the whole streamed run: nested admissions (hash_partition's op
        # boundary, each partition sub-plan) skip under the outermost-
        # only discipline, so the degraded query claims the footprint it
        # actually streams — the whole-plan estimate could never be
        # admitted (that is why this strategy was selected)
        _durable_admit = memgov.admit(f"plan.{inner.name}.ooc",
                                      nbytes=self.partition_memory_bytes)
        _tls.active = True
        try:
            # partition the source once up front (skipping any partition
            # a prior attempt already checkpointed — the resume fast
            # path)
            deadline.check("plan.ooc.partition_inputs")
            have_ckpt = [cat.lookup(self._part_key(i)) is not None
                         for i in range(parts)]
            if not all(have_ckpt):
                reordered, offsets = hash_partition(src, parts, key_cols)
                n = reordered.num_rows
                first_pending = have_ckpt.index(False)
                for i in range(parts):
                    if have_ckpt[i] or cat.lookup(self._in_key(i)) is not None:
                        continue
                    lo = offsets[i]
                    hi = offsets[i + 1] if i + 1 < parts else n
                    h = cat.register(self._in_key(i),
                                     slice_table(reordered, lo, hi),
                                     kind="partition")
                    built_inputs.add(i)
                    # partitions at rest demote off-device; the first
                    # pending one stays resident — it runs next
                    if i != first_pending:
                        demote(h)
                del reordered

            for i in range(parts):
                deadline.check(f"plan.ooc.partition[{i}]")
                faultinj.maybe_inject("plan.ooc.partition")
                if prefetch_on and i + 1 < parts:
                    prefetcher = threading.Thread(
                        target=warm, args=(i + 1,), daemon=True,
                        name=f"srjtorch-ooc-prefetch-{i + 1}",
                    )
                    prefetcher.start()
                if cat.lookup(self._part_key(i)) is not None:
                    # a prior attempt's checkpoint: resume past it (the
                    # partial is fetched — and integrity-checked — at
                    # merge; a rotted one lineage-recomputes there)
                    resumes += 1
                    reg.counter("ooc.partition_resumes").inc()
                    metrics.event("plan.ooc.resume", query=inner.name,
                                  partition=i)
                else:
                    compute_partition(i)
                if prefetcher is not None:
                    prefetcher.join(timeout=60.0)
                    prefetcher = None
            deadline.check("plan.ooc.merge")
            partials = []
            for i in range(parts):
                h = cat.lookup(self._part_key(i))
                if h is not None:
                    try:
                        partials.append(h.get())
                        continue
                    except DataCorruption:
                        recomputes += 1
                        reg.counter("ooc.lineage_recomputes").inc()
                        metrics.event("plan.ooc.recompute",
                                      query=inner.name, partition=i)
                # checkpoint missing or rotted: recompute the hole
                compute_partition(i)
                partials.append(cat.lookup(self._part_key(i)).get())
            merged = merge_partials(partials,
                                    list(self._target.sort.keys))
        except BaseException as e:
            if isinstance(e, RetryableError):
                # keep the completed-partition checkpoints — a retried
                # call resumes from them; inputs are recomputable from
                # lineage and must not outlive the attempt
                self._release(cat, inputs=True, partials=False)
            else:
                # cancel/deadline/fatal: the query is over — release
                # every partition catalog entry
                self._release(cat, inputs=True, partials=True)
            raise
        finally:
            _tls.active = False
            if prefetcher is not None:
                prefetcher.join(timeout=60.0)
            if _durable_admit is not None:
                _durable_admit.release()
        self._release(cat, inputs=True, partials=True)
        wall = time.perf_counter() - t0
        spills = (reg.counter("memgov.spills").value
                  + reg.counter("memgov.disk_spills").value) - spills0
        self.last_report = {
            "query": inner.name,
            "ooc": True,
            "partitions": parts,
            "resumes": resumes,
            "lineage_recomputes": recomputes,
            "spills": spills,
            "wall_s": wall,
            "est_peak_bytes": inner.estimated_memory_bytes,
            "partition_peak_bytes": self.partition_memory_bytes,
        }
        metrics.event("plan.ooc.run", **self.last_report)
        path = knobs.get_str("SRJTORCH_OOC_METRICS")
        if path:
            with open(path, "a") as f:
                f.write(json.dumps(self.last_report) + "\n")
        return merged
